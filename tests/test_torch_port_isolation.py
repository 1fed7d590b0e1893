"""The port stands alone: `pointcept_tpu_torch` imports neither JAX, flax nor
the JAX package, and its entry points refuse to run quietly on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "pointcept_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pointcept_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import pointcept_tpu_torch, pointcept_tpu_torch.models, pointcept_tpu_torch.engines\n"
        "import pointcept_tpu_torch.datasets, pointcept_tpu_torch.ops.kernels\n"
        "import pointcept_tpu_torch.models.point_transformer_v3.point_transformer_v3\n"
        "import pointcept_tpu_torch.models.sparse_unet.spconv_unet\n"
        "import pointcept_tpu_torch.ops.kernels.tap_conv, pointcept_tpu_torch.ops.sparse_conv\n"
        "import pointcept_tpu_torch.models.utils.convert, pointcept_tpu_torch.models.losses\n"
        "import pointcept_tpu_torch.utils.optimizer, pointcept_tpu_torch.utils.scheduler\n"
        "import pointcept_tpu_torch.utils.config, pointcept_tpu_torch.utils.events\n"
        "import pointcept_tpu_torch.engines.hooks, pointcept_tpu_torch.engines.train\n"
        "import pointcept_tpu_torch.engines.test, pointcept_tpu_torch.utils.misc\n"
        "import pointcept_tpu_torch.datasets.loader, pointcept_tpu_torch.datasets.scannet\n"
        "import pointcept_tpu_torch.models.sonata.sonata, pointcept_tpu_torch.ops.pointops\n"
        "import pointcept_tpu_torch.engines.hooks.misc, pointcept_tpu_torch.datasets.transform\n"
        "import pointcept_tpu_torch.datasets.s3dis, pointcept_tpu_torch.datasets.structured3d\n"
        "import pointcept_tpu_torch.datasets.semantic_kitti, pointcept_tpu_torch.datasets.nuscenes\n"
        "import pointcept_tpu_torch.datasets.waymo, pointcept_tpu_torch.datasets.variants\n"
        "import pointcept_tpu_torch.datasets.dataloader, pointcept_tpu_torch.models.point_prompt_training\n"
        "import pointcept_tpu_torch.models.point_prompt_training.point_prompt_training\n"
        "import pointcept_tpu_torch.models.point_group.point_group, pointcept_tpu_torch.ops.clustering\n"
        "import pointcept_tpu_torch.utils.instance_eval, pointcept_tpu_torch.engines.hooks.evaluator\n"
        "import pointcept_tpu_torch.datasets.modelnet, pointcept_tpu_torch.datasets.shapenet_part\n"
        "import pointcept_tpu_torch.datasets.partnete, pointcept_tpu_torch.datasets.synthetic\n"
        "import pointcept_tpu_torch.models.point_transformer_v2.point_transformer_v2\n"
        "import pointcept_tpu_torch.models.context_aware_classifier.context_aware_classifier\n"
        "import pointcept_tpu_torch.datasets.matterport\n"
        "print(' '.join(sorted(m for m in sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, env=dict(os.environ, PYTHONPATH=str(ROOT))).stdout
    loaded = [m for m in out.split() if _forbidden(m)]
    assert loaded == []


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py"))
                         + ["chip_smoke.py"]
                         + sorted(str(p.relative_to(ROOT)) for p in (ROOT / "tools").glob("torch_port_*.py")))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert [n for n in names if _forbidden(n)] == []


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the entry points would run on it")
    from pointcept_tpu_torch.engines import make_point_batch
    from pointcept_tpu_torch.models import build_model

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(dict(type="DefaultSegmentorV2", num_classes=4, backbone_out_channels=16,
                         backbone=dict(type="PT-v3m1", enc_depths=(1,), enc_channels=(16,),
                                       enc_num_head=(1,), enc_patch_size=(16,), dec_depths=(),
                                       dec_channels=(), dec_num_head=(), dec_patch_size=())))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_point_batch({"coord": [[0.0, 0.0, 0.0]], "batch": [0]}, 1)


@pytest.mark.parametrize("option", [dict(scene_blocked=True), dict(enable_rpe=True, scene_blocked=True),
                                    dict(proj_drop=0.1), dict(rope_base=10000.0)])
def test_unported_options_raise(option):
    from pointcept_tpu_torch.models import MODELS

    with pytest.raises(NotImplementedError):
        MODELS.build(dict(type="PT-v3m1", **option))


def test_scannet_config_model_builds():
    """The ScanNet PTv3-base model dict builds with the port's registry."""
    from pointcept_tpu_torch.models import build_model

    ns = {}
    exec(compile((ROOT / "configs/scannet/semseg-pt-v3m1-0-base.py").read_text(), "cfg", "exec"), ns)
    model = build_model(ns["model"], device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert 40e6 < n < 50e6, n  # PTv3-base: about 46 M parameters


def test_kernels_are_not_built_at_import():
    from pointcept_tpu_torch.ops.kernels import build

    assert build._libs == {}


def test_clustering_builds_the_ports_own_source():
    """`bfs_cluster` loads the port's library, built from
    `pointcept_tpu_torch/csrc/clustering.cpp` into ``build/kernels/``; no
    path of the JAX package's `native/` appears in the module or its build."""
    import numpy as np

    from pointcept_tpu_torch.ops import clustering
    from pointcept_tpu_torch.ops.kernels import build

    for module in (clustering, build):
        assert "native" not in Path(module.__file__).read_text()
    out, num = clustering.bfs_cluster(np.zeros((3, 3), np.float32), np.zeros(3, np.int32), np.zeros(3, np.int32),
                                      radius=1.0, min_points=2)
    assert num == 1 and (out == 0).all()
    lib = Path(build._host_libs["clustering.cpp"]._name)
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("libclustering-")
    assert (build.CSRC / "clustering.cpp").is_file() and build.CSRC.parent.name == "pointcept_tpu_torch"
