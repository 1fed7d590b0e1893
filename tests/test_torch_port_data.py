"""The port's data path (synthetic scene, transforms, collate) against the JAX
package's synthetic benchmark batch: identical arrays for the same seeds.

GridSample draws from numpy's global state in the JAX package; the port
takes an explicit RandomState, seeded identically here."""

import sys

import numpy as np
import pytest

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from __graft_entry__ import _synthetic_arrays  # noqa: E402

from pointcept_tpu.datasets.synthetic import synthesize_scene as jax_synthesize_scene  # noqa: E402
from pointcept_tpu_torch.datasets import synthesize_scene, synthetic_arrays  # noqa: E402


@pytest.mark.parametrize("seed", [0, 7])
def test_synthesize_scene_matches(seed):
    a = synthesize_scene(seed, num_points=3000, num_classes=20, extent=6.0)
    b = jax_synthesize_scene(seed, num_points=3000, num_classes=20, extent=6.0)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize(
    "kw",
    [
        dict(capacity=4096, num_scenes=2),
        # the benchmark's recipe: 0.02 m voxels, 4x oversampled, center crop
        dict(capacity=8192, num_scenes=1, num_classes=20, grid_size=0.02, oversample=4.0,
             extent=6.0, crop=True),
    ],
)
def test_synthetic_batch_matches(seed, kw):
    np.random.seed(seed)
    want = _synthetic_arrays(seed=seed, **kw)
    got = synthetic_arrays(seed=seed, rng=np.random.RandomState(seed), **kw)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert (got["batch"] >= 0).sum() > 0


class _DyingDataset:
    """A dataset whose workers die on their first sample."""

    def __len__(self):
        return 4

    def __getitem__(self, idx):
        import os

        os._exit(3)


def test_loader_raises_when_a_worker_dies():
    """A worker that dies (as one does that touches CUDA state it forked)
    makes the loader raise instead of waiting for its batches forever."""
    from pointcept_tpu_torch.datasets import DataLoader

    loader = DataLoader(_DyingDataset(), batch_size=2, num_workers=2, collate_fn=lambda s: s)
    with pytest.raises(RuntimeError, match="worker died"):
        list(loader)
