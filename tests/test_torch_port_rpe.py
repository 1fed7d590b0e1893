"""PT-v3m1's relative position encoding (RPE) in the port against the JAX
package, on the CPU.

The table lookup (`rpe_lookup`, the plain versions' bias) against JAX's
`RPE` module; the biased plain attention and its VJP (q, k, v and the
table) against the JAX package's dense path with the bias; a small
PT-v3m1 with ``enable_rpe`` through `params_from_jax`: logits and one
train step; the S3DIS RPE config's model in the port. The JAX side runs
its dense path, as its own tests run RPE on the CPU (its Pallas kernels
take no bias). The kernels themselves are held against these plain
versions on the card (`tests/test_torch_port_kernels.py`, marked `gpu`)."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])

from test_torch_port_probe import _cos, _labelled_scene, _rel  # noqa: E402

from pointcept_tpu.engines.train import make_point_batch as jax_point_batch  # noqa: E402
from pointcept_tpu.models import build_model as jax_build_model  # noqa: E402
from pointcept_tpu.models.point_transformer_v3.point_transformer_v3 import RPE as JaxRPE  # noqa: E402
from pointcept_tpu.ops.attention import patch_attention as jax_patch_attention  # noqa: E402
from pointcept_tpu_torch.engines import make_point_batch  # noqa: E402
from pointcept_tpu_torch.models import MODELS, apply_amp_policy, build_model  # noqa: E402
from pointcept_tpu_torch.models.utils.convert import params_from_jax  # noqa: E402
from pointcept_tpu_torch.ops import kernels  # noqa: E402
from pointcept_tpu_torch.ops.kernels.patch_attention import rpe_bound, rpe_lookup  # noqa: E402
from pointcept_tpu_torch.utils.config import Config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CRITERIA = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
            dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0, ignore_index=-1)]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a test process (tests/test_torch_port_ptv3.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ the table


@pytest.mark.parametrize("k,bound", [(32, 10), (128, 15), (1024, 31)])
def test_rpe_lookup_matches_jax(k, bound):
    """The bound is the reference's floating-point one (15 at K = 128:
    512^(1/3) is 7.999...), the table [3 * (2b + 1), H]; the bias of the
    same table at the same coordinates is JAX's bit for bit (f32: the same
    three entries summed x, y, z), clipped differences included."""
    assert rpe_bound(k) == bound == int((4 * k) ** (1 / 3) * 2)
    rng = np.random.RandomState(k)
    h, n = 3, min(k, 96)
    coords = rng.randint(0, 3 * bound, (2, n, 3)).astype(np.int32)
    rel = coords[:, :, None, :] - coords[:, None, :, :]
    assert np.abs(rel).max() > bound  # some differences clip
    module = JaxRPE(patch_size=k, num_heads=h)
    table = np.asarray(module.init(jax.random.PRNGKey(0), jnp.asarray(rel))["params"]["rpe_table"])
    assert table.shape == (3 * (2 * bound + 1), h)
    want = np.asarray(module.apply({"params": {"rpe_table": jnp.asarray(table)}}, jnp.asarray(rel)))
    got = rpe_lookup(torch.from_numpy(table.copy()), torch.from_numpy(coords)).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ the attention


def _attention_inputs(np_=3, k=32, c=32, h=2, seed=0):
    rng = np.random.RandomState(seed)
    b = rpe_bound(k)
    qkv = rng.randn(np_ * k, 3 * c).astype(np.float32)
    table = (rng.randn(3 * (2 * b + 1), h) * 0.5).astype(np.float32)
    coords = rng.randint(0, 3 * b, (np_, k, 3)).astype(np.int32)
    dout = rng.randn(np_ * k, c).astype(np.float32)
    return qkv, table, coords, dout


def _jax_dense(qkv, table, coords, h, k, scale):
    """The JAX package's dense path with the RPE bias, f32, identity slots."""
    p = qkv.shape[0]
    rel = coords[:, :, None, :] - coords[:, None, :, :]
    module = JaxRPE(patch_size=k, num_heads=h)

    def f(x, t):
        bias = module.apply({"params": {"rpe_table": t}}, jnp.asarray(rel))
        return jax_patch_attention(x, jnp.arange(p), jnp.arange(p), h, k, scale=scale, bias=bias,
                                   compute_dtype=jnp.float32, use_pallas=False)

    return f


@pytest.mark.parametrize("c,h", [(32, 2), (64, 8)])
def test_biased_plain_attention_matches_jax_dense(c, h):
    """f32: the output, and the VJP in q, k, v and the table, within 1e-5
    of the largest value (the two libraries' f32 sums in other orders)."""
    k = 32
    qkv, table, coords, dout = _attention_inputs(k=k, c=c, h=h)
    scale = (c // h) ** -0.5
    f = _jax_dense(qkv, table, coords, h, k, scale)
    want, vjp = jax.vjp(f, jnp.asarray(qkv), jnp.asarray(table))
    want_dqkv, want_dtable = (np.asarray(x) for x in vjp(jnp.asarray(dout)))
    np_ = qkv.shape[0] // k
    tq = torch.as_tensor(qkv).reshape(np_, k, 3 * c).requires_grad_(True)
    tt = torch.as_tensor(table).requires_grad_(True)
    out = kernels.PatchAttention.apply(tq, h, scale, tt, torch.as_tensor(coords))
    out.backward(torch.as_tensor(dout).reshape(np_, k, c))
    assert _rel(out.detach().reshape(-1, c).numpy(), np.asarray(want)) < 1e-5
    assert _rel(tq.grad.reshape(-1, 3 * c).numpy(), want_dqkv) < 1e-5
    assert _rel(tt.grad.numpy(), want_dtable) < 1e-5
    # the plain versions' row statistics include the bias: the backward
    # alone, from them, gives the same gradients
    o, m, l = kernels.patch_attention_rpe_fwd(tq.detach(), h, scale, tt.detach(), torch.as_tensor(coords),
                                              stats=True)
    dq, dt = kernels.patch_attention_rpe_bwd(tq.detach(), o, torch.as_tensor(dout).reshape(np_, k, c), m, l, h,
                                             scale, tt.detach(), torch.as_tensor(coords))
    assert torch.equal(dq, tq.grad) and torch.equal(dt, tt.grad)


def test_bias_moves_the_output():
    """A zero table gives the unbiased attention's bits; a nonzero one
    another output."""
    qkv, table, coords, _ = _attention_inputs()
    tq = torch.as_tensor(qkv).reshape(3, 32, 96).to(torch.bfloat16)
    plain = kernels.patch_attention_fwd(tq, 2, 0.25)
    zero = kernels.patch_attention_rpe_fwd(tq, 2, 0.25, torch.zeros(table.shape), torch.as_tensor(coords))
    assert torch.equal(plain, zero)
    biased = kernels.patch_attention_rpe_fwd(tq, 2, 0.25, torch.as_tensor(table), torch.as_tensor(coords))
    assert (biased.float() - plain.float()).abs().max() > 0.05


# ------------------------------------------------------------ PT-v3m1 with RPE


def _cfg():
    backbone = dict(
        type="PT-v3m1", in_channels=6, order=("z", "z-trans", "hilbert", "hilbert-trans"),
        stride=(2, 2), enc_depths=(1, 1, 1), enc_channels=(32, 64, 128), enc_num_head=(2, 4, 8),
        enc_patch_size=(32,) * 3, dec_depths=(1, 1), dec_channels=(32, 64), dec_num_head=(2, 4),
        dec_patch_size=(32,) * 2, mlp_ratio=2, drop_path=0.0, shuffle_orders=False,
        serialize_depth=7, pool_capacity_factors=(0.5, 0.5), conv_engine="gather", enable_rpe=True,
        # the JAX train step with RPE fails on the pinned layout: the pin's
        # packed VJP gets a float0 cotangent of the integer grid the bias
        # reads (pointcept_tpu/ops/permute.py:46; ROADMAP queue 3 item 15)
        sorted_layout=False,
    )
    return dict(type="DefaultSegmentorV2", num_classes=13, backbone_out_channels=32, backbone=backbone,
                criteria=CRITERIA)


@pytest.fixture(scope="module")
def ref():
    """JAX weights of the small PT-v3m1 with RPE (random, seed 0; tables
    drawn anew at N(0, 0.5) so that the bias matters; perturbed running
    statistics), its eval logits, and one train step's loss and gradients."""
    arrays = _labelled_scene()
    pb = jax_point_batch({k: jnp.asarray(v) for k, v in arrays.items()}, 1)
    model = jax_build_model(_cfg())
    variables = jax.jit(lambda r: model.init(r, pb, train=False))({"params": jax.random.PRNGKey(0)})
    rs = np.random.RandomState(5)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (rs.randn(*x.shape).astype(np.float32) * 0.5
                         if jax.tree_util.keystr(path).endswith("['rpe_table']") else np.asarray(x)),
        variables["params"])
    stats = jax.tree_util.tree_map(lambda x: np.asarray(x) + rs.rand(*x.shape).astype(np.float32) * 0.5,
                                   variables["batch_stats"])
    res = jax.jit(lambda p, b: model.apply({"params": p, "batch_stats": b}, pb, train=False))(params, stats)

    def loss_fn(p):
        out, upd = model.apply({"params": p, "batch_stats": stats}, pb, train=True,
                               rngs={"shuffle": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                               mutable=["batch_stats", "diagnostics"])
        return out["loss"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return dict(arrays=arrays, params=params, stats=stats, logits=np.asarray(res["seg_logits"], np.float32),
                loss=float(loss), grads=jax.tree_util.tree_map(np.asarray, grads))


def _port(ref):
    model = build_model(_cfg(), device="cpu")
    model.load_state_dict(params_from_jax(ref["params"], ref["stats"]), strict=True)
    return model


def test_rpe_model_logits_match_jax(ref):
    """Eval logits, f32 stream with bf16 attention operands: < 1e-2
    relative, argmax > 0.99 (`PERF.md` §2); the tables move them (zeroed,
    the logits differ from JAX's by more)."""
    model = _port(ref)
    names = [n for n in model.state_dict() if n.endswith("attn.rpe.rpe_table")]
    assert len(names) == 5 and "backbone.enc.enc0.block0.attn.rpe.rpe_table" in names
    assert model.state_dict()[names[0]].shape == (3 * (2 * rpe_bound(32) + 1), 2)
    pb = make_point_batch(ref["arrays"], 1, device="cpu")
    got = model(pb)["seg_logits"].numpy()
    v = ref["arrays"]["batch"] >= 0
    g, w = got[v], ref["logits"][v]
    err, agree = _rel(g, w), (g.argmax(1) == w.argmax(1)).mean()
    assert np.isfinite(g).all() and err < 1e-2 and agree > 0.99, (err, agree)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("rpe_table"):
                p.zero_()
    assert _rel(model(pb)["seg_logits"].numpy()[v], w) > 2 * err


def test_rpe_model_train_step_matches_jax(ref):
    """One train step (CE + Lovász, drop path 0, unshuffled): the loss
    within 2e-2, every gradient (each block's `rpe_table` among them)
    within 5e-2 relative L2 with cosine above 0.999 (`PERF.md` §2); tensors
    whose gradient vanishes in exact arithmetic (biases before train-mode
    BatchNorms) are held to the noise floor instead."""
    model = _port(ref).train()
    res = model(make_point_batch(ref["arrays"], 1, device="cpu"), generator=torch.Generator().manual_seed(0))
    res["loss"].backward()
    loss = float(res["loss"].detach())
    assert abs(loss - ref["loss"]) / ref["loss"] < 2e-2, (loss, ref["loss"])
    jgrads = {n: g.numpy() for n, g in params_from_jax(ref["grads"], {}).items()}
    grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    assert set(grads) == set(jgrads)
    assert sum(n.endswith("rpe_table") for n in grads) == 5
    gmax = max(np.abs(g).max() for g in grads.values())
    bad = {}
    for name, g in grads.items():
        w = jgrads[name]
        if np.abs(g).max() < 1e-6 * gmax:
            if max(np.abs(g).max(), np.abs(w).max()) > 1e-3 * gmax:
                bad[name] = "vanishing gradient above the noise floor"
            continue
        err = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        if not (err < 5e-2 and _cos(g, w) > 0.999):
            bad[name] = (err, _cos(g, w))
    assert not bad, bad


# ------------------------------------------------------------ the S3DIS RPE config


def test_s3dis_rpe_config_builds():
    """`configs/s3dis/semseg-pt-v3m1-1-rpe.py`'s model: PT-v3m1-base at
    patch 128 with a [93, H] table (bound 15) in each of its 22 blocks; its
    parity no-ops (enable_flash, upcast_attention, upcast_softmax) taken."""
    cfg = Config.fromfile(str(ROOT / "configs/s3dis/semseg-pt-v3m1-1-rpe.py"))
    bb = cfg.model.backbone
    assert bb.enable_rpe and not bb.enable_flash and bb.upcast_attention and bb.upcast_softmax
    with torch.device("meta"):
        model = MODELS.build(apply_amp_policy(dict(cfg.model), cfg.enable_amp))
    tables = {n: tuple(p.shape) for n, p in model.named_parameters() if n.endswith("attn.rpe.rpe_table")}
    heads = {f"enc.enc{s}": h for s, h in enumerate(bb.enc_num_head)}
    heads.update({f"dec.dec{s}": h for s, h in enumerate(bb.dec_num_head)})
    assert len(tables) == sum(bb.enc_depths) + sum(bb.dec_depths) == 22
    for name, shape in tables.items():
        stage = ".".join(name.split(".")[1:3])
        assert shape == (93, heads[stage]), (name, shape)
