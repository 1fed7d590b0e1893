"""LoRA fine-tuning in the port against the JAX package, on the CPU.

`DefaultLORASegmentorV2` over an ``enc_mode`` PT-v3m2 with ``lora_rank`` on
every attention's qkv (``qkv + (x @ lora_a) @ lora_b``): logits, loss and
the gradients of the adapters and the seg head against the JAX package's
class with the same weights (carried across by `params_from_jax`, with a
nonzero ``lora_b`` so that the adapter path counts); one AdamW step that
moves only the trainable tensors; `trainable_keywords`; the Concerto-large
LoRA configs as written, which freeze the encoder in the port and in the
JAX package freeze nothing; `CheckpointLoader` on a pretrained encoder.

Small model: two stages (32 and 64 channels, head dim 16), patch 128, the
gather engine, one block a stage, ``lora_rank`` 4, on the 13k-point surface
scene of `tests/test_reference_oracle.py`."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/", 1)[0])

from test_reference_oracle import _surface_scene  # noqa: E402

from pointcept_tpu.engines.train import make_point_batch as jax_point_batch  # noqa: E402
from pointcept_tpu.models import build_model as jax_build_model  # noqa: E402
from pointcept_tpu.utils.config import Config as JaxConfig  # noqa: E402
from pointcept_tpu.utils.optimizer import build_optimizer as jax_build_optimizer  # noqa: E402
from pointcept_tpu_torch.engines import build_train_step, make_point_batch  # noqa: E402
from pointcept_tpu_torch.engines.hooks.misc import CheckpointLoader  # noqa: E402
from pointcept_tpu_torch.models import MODELS, apply_amp_policy, build_model  # noqa: E402
from pointcept_tpu_torch.models.utils.convert import params_from_jax  # noqa: E402
from pointcept_tpu_torch.utils import build_optimizer, build_scheduler  # noqa: E402
from pointcept_tpu_torch.utils.config import Config  # noqa: E402
from pointcept_tpu_torch.utils.logger import get_root_logger  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENC = (32, 64)
RANK = 4
# the LoRA configs' schedule (configs/concerto/semseg-ptv3-large-v1m1-0f-scannet-ft-lora.py)
OPTIMIZER = dict(type="AdamW", lr=0.002, weight_decay=0.02)
PARAM_DICTS = [dict(keyword="block", lr=0.0002)]
SCHEDULER = dict(type="OneCycleLR", max_lr=[0.002, 0.0002], pct_start=0.05, anneal_strategy="cos",
                 div_factor=10.0, final_div_factor=1000.0)
LORA_CONFIGS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs/concerto").glob("semseg-*lora*.py"))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _lora_cfg():
    bb = dict(type="PT-v3m2", in_channels=6, order=("z", "z-trans", "hilbert", "hilbert-trans"), stride=(2,),
              enc_depths=(1, 1), enc_channels=ENC, enc_num_head=(2, 4), enc_patch_size=(128,) * 2, mlp_ratio=2,
              drop_path=0.0, shuffle_orders=False, serialize_depth=7, pool_capacity_factors=(0.5,),
              conv_engine="gather", enc_mode=True)
    return dict(type="DefaultLORASegmentorV2", num_classes=13, backbone_out_channels=sum(ENC), backbone=bb,
                lora_rank=RANK, criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)])


def _plain_cfg():
    """The same segmentor without adapters."""
    cfg = dict(_lora_cfg(), type="DefaultSegmentorV2")
    cfg.pop("lora_rank")
    return cfg


def _labelled_scene():
    grid, feat = _surface_scene(span=60, seed=3)
    n = len(grid)
    cap = ((n + 255) // 256) * 256 + 256
    rng = np.random.RandomState(9)
    arrays = dict(coord=np.zeros((cap, 3), np.float32), feat=np.zeros((cap, 6), np.float32),
                  grid_coord=np.zeros((cap, 3), np.int32), batch=np.full(cap, -1, np.int32),
                  segment=np.full(cap, -1, np.int32))
    arrays["coord"][:n] = grid * 0.02
    arrays["feat"][:n] = feat
    arrays["grid_coord"][:n] = grid
    arrays["batch"][:n] = 0
    arrays["segment"][:n] = np.where(rng.rand(n) < 0.1, -1, rng.randint(0, 12, n))
    return arrays


@pytest.fixture(scope="module")
def jax_side():
    """JAX weights of the LoRA segmentor (seed 0) with every ``lora_b`` drawn
    N(0, 1) instead of zero and raised running statistics; its eval
    logits, and one train-mode loss with its gradients."""
    arrays = _labelled_scene()
    pb = jax_point_batch({k: jnp.asarray(v) for k, v in arrays.items()}, 1)
    model = jax_build_model(_lora_cfg())
    variables = jax.jit(lambda r: model.init(r, pb, train=False))({"params": jax.random.PRNGKey(0)})
    rs = np.random.RandomState(5)

    def leaf(path, x):
        x = np.asarray(x)
        if jax.tree_util.keystr(path).endswith("['lora_b']"):
            assert not x.any()  # made at zero
            return rs.randn(*x.shape).astype(np.float32)
        return x

    params = jax.tree_util.tree_map_with_path(leaf, variables["params"])
    stats = jax.tree_util.tree_map(lambda x: np.asarray(x) + rs.rand(*x.shape).astype(np.float32) * 0.5,
                                   variables["batch_stats"])
    logits = jax.jit(lambda p, b: model.apply({"params": p, "batch_stats": b}, pb, train=False))(params, stats)

    def loss_fn(p):
        out, upd = model.apply({"params": p, "batch_stats": stats}, pb, train=True,
                               rngs={"shuffle": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                               mutable=["batch_stats", "diagnostics"])
        return out["loss"], upd["batch_stats"]

    (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(arrays=arrays, params=params, stats=stats, logits=np.asarray(logits["seg_logits"], np.float32),
                loss=float(loss), grads=tree(grads), new_stats=tree(new_stats))


@pytest.fixture(scope="module")
def port_step(jax_side):
    """One port train step (AdamW, the configs' `block` group, OneCycle)
    from the JAX weights."""
    model = build_model(_lora_cfg(), device="cpu")
    model.load_state_dict(params_from_jax(jax_side["params"], jax_side["stats"]), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = build_optimizer(OPTIMIZER, model, PARAM_DICTS)
    scheduler = build_scheduler(SCHEDULER, optimizer, total_steps=1000)
    step = build_train_step(model, optimizer, scheduler)
    res = step(make_point_batch(jax_side["arrays"], 1, device="cpu"), torch.Generator().manual_seed(0))
    after = {k: v.clone() for k, v in model.state_dict().items()}
    return dict(model=model, optimizer=optimizer, before=before, after=after, loss=float(res["loss"]))


def _trainable(model) -> set:
    return {n for n, p in model.named_parameters() if p.requires_grad}


def _adapters_and_head(model) -> set:
    return {n for n, _ in model.named_parameters() if n.endswith((".lora_a", ".lora_b")) or n.startswith("seg_head.")}


def _cos(got, want):
    a, b = got.ravel().astype(np.float64), want.ravel().astype(np.float64)
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


# ------------------------------------------------------------ against JAX


def test_lora_logits_match_jax(jax_side):
    """The eval logits with the adapters at work (``lora_b`` nonzero): f32
    stream with bf16 conv and attention operands, < 1e-2 relative and
    argmax > 0.99, the bounds of tests/test_torch_port_ptv3.py; without the
    adapters the logits move by far more than that bound."""
    port = build_model(_lora_cfg(), device="cpu")
    sd = params_from_jax(jax_side["params"], jax_side["stats"])
    port.load_state_dict(sd, strict=True)
    pb = make_point_batch(jax_side["arrays"], 1, device="cpu")
    v = jax_side["arrays"]["batch"] >= 0
    got, want = port(pb)["seg_logits"].numpy()[v], jax_side["logits"][v]
    scale = np.abs(want).max()
    err, agree = np.abs(got - want).max() / scale, (got.argmax(1) == want.argmax(1)).mean()
    assert np.isfinite(got).all() and err < 1e-2 and agree > 0.99, (err, agree)
    port.load_state_dict({k: (torch.zeros_like(t) if k.endswith("lora_b") else t) for k, t in sd.items()})
    without = port(pb)["seg_logits"].numpy()[v]
    assert np.abs(without - want).max() / scale > 10 * err


def test_lora_step_matches_jax(jax_side, port_step):
    """One train step: the loss within 2e-2 relative, and the gradient of
    every adapter tensor and of the seg head within 5e-2 relative L2 and
    cosine 0.999 of JAX's (the bounds of tests/test_torch_port_train.py).
    The backward runs through the frozen encoder (both stages' adapters get
    gradients) but gives none of its tensors a gradient."""
    model = port_step["model"]
    assert abs(port_step["loss"] - jax_side["loss"]) / jax_side["loss"] < 2e-2, (port_step["loss"], jax_side["loss"])
    jgrads = params_from_jax(jax_side["grads"], {})
    names = _adapters_and_head(model)
    assert len(names) == 2 * len(ENC) + 2
    for name in sorted(names):
        g, jg = model.get_parameter(name).grad.numpy(), jgrads[name].numpy()
        assert np.abs(jg).max() > 0, name
        err = np.linalg.norm(g - jg) / np.linalg.norm(jg)
        assert err < 5e-2 and _cos(g, jg) > 0.999, (name, err, _cos(g, jg))
    assert all(p.grad is None for n, p in model.named_parameters() if n not in names)


def test_adamw_step_moves_only_the_trainable_tensors(jax_side, port_step):
    """The optimizer holds the adapters and the seg head alone; after the
    step every other tensor is bit-identical, every trainable one moved,
    and the frozen encoder's BatchNorm statistics moved as JAX's (rtol
    1e-3, as tests/test_torch_port_train.py)."""
    model, before, after = port_step["model"], port_step["before"], port_step["after"]
    grouped = {id(p) for g in port_step["optimizer"].param_groups for p in g["params"]}
    assert {n for n, p in model.named_parameters() if id(p) in grouped} == _adapters_and_head(model) == _trainable(model)
    want_stats = params_from_jax(jax_side["params"], jax_side["new_stats"])
    moved_stats = 0
    for name, value in after.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value.numpy(), want_stats[name].numpy(), rtol=1e-3, atol=1e-5, err_msg=name)
            moved_stats += int(not torch.equal(value, before[name]))
        elif name in _trainable(model):
            assert not torch.equal(value, before[name]), name
        else:
            assert torch.equal(value, before[name]), name
    assert moved_stats > 0


# ------------------------------------------------------------ freezing


def test_trainable_keywords_freeze_in_the_model():
    """`trainable_keywords` with the reference's meaning: the other tensors
    stop requiring gradients and sit in no param group, so AdamW's decay
    leaves them as they were (SGD too); a tensor the model froze stays
    frozen whatever the keywords say."""
    for opt in (dict(OPTIMIZER, weight_decay=0.5), dict(type="SGD", lr=0.1, momentum=0.9, weight_decay=0.5)):
        model = build_model(_plain_cfg(), device="cpu")
        model.backbone.enc.enc1.block0.mlp.requires_grad_(False)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        optimizer = build_optimizer(dict(opt, trainable_keywords=("seg_head", "mlp")), model, PARAM_DICTS)
        assert _trainable(model) == {"seg_head.weight", "seg_head.bias", "backbone.enc.enc0.block0.mlp.0.fc1.weight",
                                     "backbone.enc.enc0.block0.mlp.0.fc1.bias",
                                     "backbone.enc.enc0.block0.mlp.0.fc2.weight",
                                     "backbone.enc.enc0.block0.mlp.0.fc2.bias"}
        assert sum(len(g["params"]) for g in optimizer.param_groups) == 6
        for p in model.parameters():
            p.grad = torch.ones_like(p) if p.requires_grad else None
        optimizer.step()
        for name, value in model.state_dict().items():
            assert torch.equal(value, before[name]) != (name in _trainable(model)), name


@pytest.mark.parametrize("path", LORA_CONFIGS)
def test_lora_configs_freeze_the_encoder(path):
    """Every Concerto-large LoRA config as written (its schedule block drops
    ``trainable_keywords`` with ``_delete_=True``): the port's model alone
    freezes the encoder, so only the adapters (two a block) and the seg
    head require gradients, and the config's optimizer holds those alone.
    Built on the meta device."""
    cfg = Config.fromfile(str(ROOT / path))
    assert cfg.model.type == "DefaultLORASegmentorV2" and "trainable_keywords" not in cfg.optimizer
    with torch.device("meta"):
        model = MODELS.build(apply_amp_policy(dict(cfg.model), cfg.enable_amp))
    optimizer = build_optimizer(dict(cfg.optimizer), model, cfg.get("param_dicts"))
    blocks = sum(cfg.model.backbone.enc_depths)
    assert _trainable(model) == _adapters_and_head(model) and len(_trainable(model)) == 2 * blocks + 2
    assert sum(len(g["params"]) for g in optimizer.param_groups) == 2 * blocks + 2
    a = model.backbone.enc.enc4.block0.attn
    assert a.lora_a.shape == (768, 16) and a.lora_b.shape == (16, 3 * 768)


def test_jax_lora_config_masks_nothing(jax_side):
    """The JAX side of the same config: `DefaultLORASegmentorV2` freezes
    through the optimizer's ``trainable_keywords``, which the config's
    schedule block deletes, so the optimizer built from the config as
    written updates every tensor: one step moves a frozen encoder weight."""
    cfg = JaxConfig.fromfile(str(ROOT / "configs/concerto/semseg-ptv3-large-v1m1-0f-scannet-ft-lora.py"))
    assert cfg.model.type == "DefaultLORASegmentorV2" and "trainable_keywords" not in cfg.optimizer
    params = jax_side["params"]
    tx = jax_build_optimizer(dict(cfg.optimizer), params, lambda step: cfg.optimizer.lr, cfg.param_dicts)
    new = optax.apply_updates(params, tx.update(jax_side["grads"], tx.init(params), params)[0])
    qkv = lambda t: np.asarray(t["backbone_module"]["enc0_block0"]["attn"]["qkv"]["kernel"])  # noqa: E731
    assert not np.array_equal(qkv(new), qkv(params))


def test_loader_reports_adapters_and_head_missing(tmp_path):
    """`CheckpointLoader` (``student.backbone.`` -> ``backbone.``, the
    Concerto configs') on a pretrained encoder without adapters: the
    missing keys are exactly the adapters and the seg head, and the encoder
    is the checkpoint's bit for bit."""
    from types import SimpleNamespace

    encoder = build_model(_plain_cfg(), device="cpu",
                          generator=torch.Generator().manual_seed(3))
    weight = tmp_path / "pretrained.pth"
    torch.save({"state_dict": {"student." + k: v for k, v in encoder.state_dict().items() if k.startswith("backbone.")}},
               weight)
    model = build_model(_lora_cfg(), device="cpu", generator=torch.Generator().manual_seed(4))
    loader = CheckpointLoader(keywords="student.backbone.", replacement="backbone.")
    loader.trainer = SimpleNamespace(model=model, cfg=Config(dict(save_path=str(tmp_path), weight=str(weight))),
                                     logger=get_root_logger(), device=torch.device("cpu"), comm_info={})
    loader.before_train()
    info = loader.trainer.comm_info["load_info"]
    assert set(info["missing"]) == _adapters_and_head(model) and info["unexpected"] == []
    own = model.state_dict()
    for key, value in encoder.state_dict().items():
        if key.startswith("backbone."):
            assert torch.equal(own[key], value), key
