"""JAX parameter trees -> the port's state dict (the inverse side of
`pointcept_tpu/models/utils/convert.py`).

The port's names are the reference Pointcept state-dict names, so its state
dict pushed through the JAX package's `convert_state_dict(sd, "PT-v3m1")`
(or ``"SpUNet-v1m1"``, `convert_spunet`) gives the JAX trees back:

* Dense ``kernel [in, out]``          -> Linear ``weight [out, in]``
* SubMConv ``weight [k^3, in, out]``  -> the same array
* MaskedBatchNorm ``{scale, bias}`` + batch_stats ``{mean, var}``
                                      -> ``{weight, bias, running_mean, running_var}``
* LayerNorm ``{scale, bias}``         -> ``{weight, bias}``

An ``enc_mode`` backbone under the segmentor (the probes and fine-tunes
of Sonata and Utonia) maps the same way: its seg head is a Dense of the
up-cast's width, and PT-v3m3's RoPE holds no parameters.

PT-v3m2 adds the linear stem (``embedding/stem_linear`` ->
``embedding.stem.linear``), ``embedding/mask_token`` ->
``embedding.mask_token`` and the LayerScale gammas (a block's ``ls1_gamma``
-> ``ls1.0.gamma``), the names `convert_state_dict` maps back. A LoRA
adapter (``attn/lora_a [C, r]``, ``attn/lora_b [r, 3C]``) keeps its arrays
as ``attn.lora_a`` and ``attn.lora_b`` of its block, and PT-v3m1's RPE table
(``attn/rpe/rpe_table``) as ``attn.rpe.rpe_table`` (the reference's name;
the JAX package's `convert_ptv3` maps no RPE key). A Sonata
tree (top-level ``teacher_backbone``) maps by `SONATA_ROOTS`: the student's
subtrees to ``student.*``, the teacher's to ``teacher.*`` (the reference
model's two ModuleDicts); a head's ``Dense_0``/``Dense_1`` to ``mlp.0`` and
``mlp.2``, its ``prototypes [embed, K]`` to ``prototype.weight_v [K, embed]``
beside the reference's fixed ``prototype.weight_g`` of ones.

PDNorm (a `PDNorm` module in place of a norm, the JAX package's children
``norm{i}`` a condition, ``norm`` shared and ``modulation``) maps to the
reference's ``<norm>.norm.{i}``, ``<norm>.norm`` and
``<norm>.modulation.1`` under PT-v3, and ``<norm>.bns.{i}``, ``<norm>.bn``
and ``<norm>.modulation.1`` under SpUNet-v1m3 (the names
`convert_spunet` reads back). A Point Prompt Training wrapper's own leaves
map to its module names: ``embedding_table/embedding`` ->
``embedding_table.weight``, ``proj_head`` and ``seg_head{i}`` Dense ->
Linear, ``class_embedding`` and ``logit_scale`` as they are. PointGroup's
heads (``bias_fc1``, ``bias_norm``, ``bias_fc2``) map to the reference's
``bias_head.0``, ``.1`` and ``.3`` (`PG_HEADS`) beside its ``seg_head``;
DefaultClassifier's (``cls_fc0``, ``cls_bn0``, ``cls_fc1``, ``cls_bn1``,
``cls_out``) to ``cls_head.0``, ``.1``, ``.4``, ``.5`` and ``.8``
(`CLS_HEAD`).

LitePT-v1 (a tree whose blocks lack PT-v3's ``cpe_conv``) maps its stem,
poolings and unpoolings as PT-v3's and its blocks by the JAX package's
names (`_LITEPT_BLOCK`: ``norm0``, ``conv``, ``norm1``, ``attn/qkv``,
``attn/proj``, ``norm2``, ``mlp/fc1``, ``mlp/fc2``), which the reference's
`litept_v1.py`, not in the repository, cannot confirm.

PT-v2 (m1, m2, m3 under DefaultSegmentor) maps to the reference names that
`convert_ptv2` reads back (`_PTV2_TOP`, `_PTV2_BLOCK`): a PointBN's ``bn``
to the PointBatchNorm's ``.norm``, m1's ``attn/we_grouped_weight`` [1, C]
to ``attn.weight_encoding.0.weight`` as it is, m3's PDNorm children to
``bns.{i}``, ``bn`` and ``modulation.1`` (SpUNet-v1m3's PDBatchNorm
names). CAC-v1m1's own leaves (`CAC_HEADS`; ``seg_head_kernel [C, cls]``
-> ``seg_head.weight``) map beside its backbone's.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch


def _flat(tree, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


_BLOCK = {
    "cpe_conv": "cpe.0",
    "cpe_linear": "cpe.1",
    "cpe_norm": "cpe.2",
    "norm1": "norm1.0",
    "norm2": "norm2.0",
    "attn/qkv": "attn.qkv",
    "attn/proj": "attn.proj",
    "mlp/fc1": "mlp.0.fc1",
    "mlp/fc2": "mlp.0.fc2",
}
# LitePT-v1's blocks: the JAX package's names (the reference's
# `litept_v1.py` is not in the repository to check them against)
_LITEPT_BLOCK = {
    "norm0": "norm0",
    "conv": "conv",
    "norm1": "norm1",
    "attn/qkv": "attn.qkv",
    "attn/proj": "attn.proj",
    "norm2": "norm2",
    "mlp/fc1": "mlp.fc1",
    "mlp/fc2": "mlp.fc2",
}
_MODULE = {
    "embedding/stem_conv": "backbone.embedding.stem.conv",
    "embedding/stem_linear": "backbone.embedding.stem.linear",
    "embedding/stem_norm": "backbone.embedding.stem.norm",
}
SONATA_ROOTS = {
    "backbone_module": "student.backbone", "mask_head": "student.mask_head",
    "unmask_head": "student.unmask_head", "teacher_backbone": "teacher.backbone",
    "teacher_mask_head": "teacher.mask_head", "teacher_unmask_head": "teacher.unmask_head",
}
_UP = {"proj": "proj.0", "proj_norm": "proj.1", "proj_skip": "proj_skip.0",
       "proj_skip_norm": "proj_skip.1"}


def _torch_module(path: str, block: dict = _BLOCK) -> str:
    """flax module path (under the segmentor) -> torch module name; `block`
    names a block's modules (PT-v3's, or LitePT's)."""
    if path == "seg_head":
        return "seg_head"
    assert path.startswith("backbone_module/"), path
    p = path[len("backbone_module/"):]
    if p in _MODULE:
        return _MODULE[p]
    m = re.fullmatch(r"(enc|dec)(\d+)_block(\d+)/(.+)", p)
    if m:
        kind, s, i, rest = m.groups()
        return f"backbone.{kind}.{kind}{s}.block{i}.{block[rest]}"
    m = re.fullmatch(r"enc(\d+)_down/(proj|norm)", p)
    if m:
        s, rest = m.groups()
        return f"backbone.enc.enc{s}.down." + ("proj" if rest == "proj" else "norm.0")
    m = re.fullmatch(r"dec(\d+)_up/(\w+)", p)
    if m:
        s, rest = m.groups()
        return f"backbone.dec.dec{s}.up.{_UP[rest]}"
    raise KeyError(f"no torch name for flax module {path}")


# SpUNet (DefaultSegmentor): flax module or parameter path under the
# backbone -> torch name, as `convert_spunet` maps the reference names
_SPUNET = [
    (r"conv_input", "conv_input.0"),
    (r"stem_norm", "conv_input.1"),
    (r"(down|up)(\d+)_norm", r"\1.\2.1"),
    (r"(enc|dec)(\d+)_block(\d+)/(conv1|bn1|conv2|bn2)", r"\1.\2.block\3.\4"),
    (r"(enc|dec)(\d+)_block(\d+)/proj_conv", r"\1.\2.block\3.proj.0"),
    (r"(enc|dec)(\d+)_block(\d+)/proj_norm", r"\1.\2.block\3.proj.1"),
    (r"(down|up)(\d+)_weight", r"\1.\2.0.weight"),
    (r"final_(weight|bias)", r"final.\1"),
]


def _spunet_module(path: str) -> str:
    assert path.startswith("backbone_module/"), path
    p = path[len("backbone_module/"):]
    for pat, rep in _SPUNET:
        if re.fullmatch(pat, p):
            return "backbone." + re.sub(pat, rep, p)
    raise KeyError(f"no torch name for flax path {path}")


def _pd_module(path: str, module_of, names: tuple) -> str:
    """The torch name of a flax module path, also inside a PDNorm: its
    ``norm{i}``, ``norm`` and ``modulation`` children under the names
    (decoupled list, shared norm) of the family."""
    try:
        return module_of(path)
    except KeyError:
        parent, _, child = path.rpartition("/")
        m = re.fullmatch(r"norm(\d*)", child)
        if m:
            return f"{module_of(parent)}.{names[0]}.{m.group(1)}" if m.group(1) else f"{module_of(parent)}.{names[1]}"
        if child == "modulation":
            return f"{module_of(parent)}.modulation.1"
        raise


def _ptv3_module(path: str) -> str:
    return _pd_module(path, _torch_module, ("norm", "norm"))


def _litept_module(path: str) -> str:
    return _torch_module(path, _LITEPT_BLOCK)


def _is_litept(params: dict) -> bool:
    """A LitePT-v1 tree: a block without PT-v3's xCPE."""
    return any(re.fullmatch(r"(enc|dec)\d+_block\d+", name) and "cpe_conv" not in tree
               for name, tree in params.get("backbone_module", {}).items())


def _spunet_pd_module(path: str) -> str:
    return _pd_module(path, _spunet_module, ("bns", "bn"))


def _spunet_from_jax(params: dict, batch_stats: dict) -> Dict[str, np.ndarray]:
    sd = {}
    for key, value in _flat(params).items():
        path, leaf = "/".join(key[:-1]), key[-1]
        if leaf.startswith(("down", "up", "final")):  # parameters held by the backbone itself
            sd[_spunet_module(f"{path}/{leaf}")] = value
        elif leaf in ("weight", "bias", "scale"):
            sd[f"{_spunet_pd_module(path)}.{'weight' if leaf == 'scale' else leaf}"] = value
        elif leaf == "kernel":  # a PDNorm's modulation Dense
            sd[f"{_spunet_pd_module(path)}.weight"] = np.ascontiguousarray(value.T)
        else:
            raise KeyError(f"unknown flax leaf {'/'.join(key)}")
    for key, value in _flat(batch_stats).items():
        sd[f"{_spunet_pd_module('/'.join(key[:-1]))}.running_{key[-1]}"] = value
    return sd


def _ptv3_from_jax(params: dict, batch_stats: dict, module_of=_ptv3_module) -> Dict[str, np.ndarray]:
    """PT-v3m1/m2/m3 trees, and LitePT-v1's (`module_of`: `_litept_module`)."""
    sd = {}
    for key, value in _flat(params).items():
        path, leaf = "/".join(key[:-1]), key[-1]
        if leaf == "mask_token":
            assert path == "backbone_module/embedding", path
            sd["backbone.embedding.mask_token"] = value
            continue
        if leaf in ("ls1_gamma", "ls2_gamma"):
            kind, s, i = re.fullmatch(r"backbone_module/(enc|dec)(\d+)_block(\d+)", path).groups()
            sd[f"backbone.{kind}.{kind}{s}.block{i}.{leaf[:3]}.0.gamma"] = value
            continue
        if leaf in ("lora_a", "lora_b"):
            kind, s, i = re.fullmatch(r"backbone_module/(enc|dec)(\d+)_block(\d+)/attn", path).groups()
            sd[f"backbone.{kind}.{kind}{s}.block{i}.attn.{leaf}"] = value
            continue
        if leaf == "rpe_table":
            kind, s, i = re.fullmatch(r"backbone_module/(enc|dec)(\d+)_block(\d+)/attn/rpe", path).groups()
            sd[f"backbone.{kind}.{kind}{s}.block{i}.attn.rpe.rpe_table"] = value
            continue
        module = module_of(path)
        if leaf == "kernel":
            sd[f"{module}.weight"] = np.ascontiguousarray(value.T)
        elif leaf == "scale":
            sd[f"{module}.weight"] = value
        elif leaf in ("weight", "bias"):
            sd[f"{module}.{leaf}"] = value
        else:
            raise KeyError(f"unknown flax leaf {'/'.join(key)}")
    for key, value in _flat(batch_stats).items():
        module, leaf = module_of("/".join(key[:-1])), key[-1]
        sd[f"{module}.running_{leaf}"] = value
    return sd


# PT-v2: flax module path under the backbone -> the reference's module name
_PTV2_TOP = {"patch_proj": "patch_embed.proj.0", "patch_norm": "patch_embed.proj.1",
             "seg_head_fc1": "seg_head.0", "seg_head_norm": "seg_head.1", "seg_head_fc2": "seg_head.3"}
_PTV2_DOWN = {"fc": "fc", "norm": "norm"}
_PTV2_UP = {"proj_fc": "proj.0", "proj_norm": "proj.1", "skip_fc": "proj_skip.0", "skip_norm": "proj_skip.1"}
_PTV2_BLOCK = {"fc1": "fc1", "fc3": "fc3", "norm1": "norm1", "norm2": "norm2", "norm3": "norm3", "attn": "attn",
               "attn/linear_q": "attn.linear_q.0", "attn/q_norm": "attn.linear_q.1",
               "attn/linear_k": "attn.linear_k.0", "attn/k_norm": "attn.linear_k.1",
               "attn/linear_v": "attn.linear_v"}
for _flax, _torch in (("pem", "linear_p_multiplier"), ("peb", "linear_p_bias"), ("we", "weight_encoding")):
    _PTV2_BLOCK.update({f"attn/{_flax}_fc1": f"attn.{_torch}.0", f"attn/{_flax}_norm": f"attn.{_torch}.1",
                        f"attn/{_flax}_fc2": f"attn.{_torch}.3"})


def _ptv2_plain(path: str) -> str:
    """A PT-v2 flax module path (PointBN's ``bn`` -> ``.norm``) -> torch name."""
    if path.endswith("/bn"):
        return _ptv2_plain(path[: -len("/bn")]) + ".norm"
    assert path.startswith("backbone_module/"), path
    p = path[len("backbone_module/"):]
    if p in _PTV2_TOP:
        return f"backbone.{_PTV2_TOP[p]}"
    for pattern, prefix, table in ((r"patch_embed/block(\d+)/(.+)", "patch_embed.blocks.blocks.{0}", _PTV2_BLOCK),
                                   (r"enc(\d+)_blocks/block(\d+)/(.+)", "enc_stages.{0}.blocks.blocks.{1}",
                                    _PTV2_BLOCK),
                                   (r"dec(\d+)_blocks/block(\d+)/(.+)", "dec_stages.{0}.blocks.blocks.{1}",
                                    _PTV2_BLOCK),
                                   (r"enc(\d+)_down/(.+)", "enc_stages.{0}.down", _PTV2_DOWN),
                                   (r"dec(\d+)_up/(.+)", "dec_stages.{0}.up", _PTV2_UP)):
        m = re.fullmatch(pattern, p)
        if m and m.groups()[-1] in table:
            return f"backbone.{prefix.format(*m.groups())}.{table[m.groups()[-1]]}"
    raise KeyError(f"no torch name for flax module {path}")


def _ptv2_module(path: str) -> str:
    return _pd_module(path, _ptv2_plain, ("bns", "bn"))


def _ptv2_from_jax(params: dict, batch_stats: dict) -> Dict[str, np.ndarray]:
    sd = {}
    for key, value in _flat(params).items():
        path, leaf = "/".join(key[:-1]), key[-1]
        if leaf == "we_grouped_weight":
            sd[f"{_ptv2_module(path)}.weight_encoding.0.weight"] = value
        elif leaf == "kernel":
            sd[f"{_ptv2_module(path)}.weight"] = np.ascontiguousarray(value.T)
        elif leaf in ("scale", "bias"):
            sd[f"{_ptv2_module(path)}.{'weight' if leaf == 'scale' else leaf}"] = value
        else:
            raise KeyError(f"unknown flax leaf {'/'.join(key)}")
    for key, value in _flat(batch_stats).items():
        sd[f"{_ptv2_module('/'.join(key[:-1]))}.running_{key[-1]}"] = value
    return sd


def _is_ppt_leaf(name: str) -> bool:
    return name in ("embedding_table", "proj_head", "class_embedding", "logit_scale") or bool(
        re.fullmatch(r"seg_head\d+", name))


def _ppt_from_jax(params: dict) -> Dict[str, np.ndarray]:
    """A Point Prompt Training wrapper's own leaves -> its module names."""
    sd = {}
    for key, value in _flat(params).items():
        path, leaf = ".".join(key[:-1]), key[-1]
        if not path:
            sd[leaf] = value  # class_embedding, logit_scale
        elif path == "embedding_table":
            sd["embedding_table.weight"] = value
        elif leaf == "kernel":
            sd[f"{path}.weight"] = np.ascontiguousarray(value.T)
        else:
            sd[f"{path}.{leaf}"] = value
    return sd


def _head_from_jax(tree: dict, prefix: str) -> Dict[str, np.ndarray]:
    """An OnlineCluster's flax tree -> its reference names under `prefix`."""
    sd = {}
    for dense, name in (("Dense_0", "mlp.0"), ("Dense_1", "mlp.2")):
        sd[f"{prefix}.{name}.weight"] = np.ascontiguousarray(np.asarray(tree[dense]["kernel"]).T)
        sd[f"{prefix}.{name}.bias"] = np.asarray(tree[dense]["bias"])
    proto = np.asarray(tree["prototypes"])
    sd[f"{prefix}.prototype.weight_v"] = np.ascontiguousarray(proto.T)
    sd[f"{prefix}.prototype.weight_g"] = np.ones((proto.shape[1], 1), np.float32)
    return sd


def _sonata_from_jax(params: dict, batch_stats: dict) -> Dict[str, np.ndarray]:
    sd = {}
    for root, prefix in SONATA_ROOTS.items():
        if prefix.endswith("backbone"):
            sub = _ptv3_from_jax({"backbone_module": params[root]},
                                 {"backbone_module": batch_stats.get(root, {})})
            sd.update({prefix + k[len("backbone"):]: v for k, v in sub.items()})
        else:
            sd.update(_head_from_jax(params[root], prefix))
    return sd


# PointGroup's heads (PG-v1m1/m2): flax module -> the reference's name
PG_HEADS = {"bias_fc1": "bias_head.0", "bias_norm": "bias_head.1", "bias_fc2": "bias_head.3"}
# DefaultClassifier's head: flax module -> the reference's name
CLS_HEAD = {"cls_fc0": "cls_head.0", "cls_bn0": "cls_head.1", "cls_fc1": "cls_head.4", "cls_bn1": "cls_head.5",
            "cls_out": "cls_head.8"}


# CAC-v1m1's own modules: flax name -> the reference's (its classifier's
# kernel and bias are leaves of the segmentor, `seg_head_kernel` / `seg_head_bias`)
CAC_HEADS = {"proj_fc1": "proj.0", "proj_fc2": "proj.2", "apd_fc1": "apd_proj.0", "apd_fc2": "apd_proj.2",
             "featproj_fc1": "feat_proj_layer.0", "featproj_norm": "feat_proj_layer.1",
             "featproj_fc2": "feat_proj_layer.3"}


def _heads_from_jax(heads: dict, params: dict, batch_stats: dict) -> Dict[str, np.ndarray]:
    """Dense and MaskedBatchNorm head modules (flax name -> torch name)."""
    sd = {}
    for module, name in heads.items():
        for leaf, value in params[module].items():
            if leaf == "kernel":
                sd[f"{name}.weight"] = np.ascontiguousarray(np.asarray(value).T)
            else:
                sd[f"{name}.{'weight' if leaf == 'scale' else leaf}"] = np.asarray(value)
        for leaf, value in batch_stats.get(module, {}).items():
            sd[f"{name}.running_{leaf}"] = np.asarray(value)
    return sd


def params_from_jax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """DefaultSegmentorV2 + PT-v3m1/m2/m3 or LitePT-v1 (``enc_mode`` too), DefaultSegmentor + SpUNet or
    PT-v2m1/m2/m3, PPT-v1m1/m2/m3 over either, PG-v1m1/m2 over either, DefaultClassifier over
    either, CAC-v1m1 over SpUNet or PT-v2, or Sonata-v1m1 flax trees (arrays) -> the port's
    state dict."""
    ppt = {k: v for k, v in params.items() if _is_ppt_leaf(k)}
    params = {k: v for k, v in params.items() if k not in ppt}
    head_sd = {}
    for marker, heads in (("bias_fc1", dict(PG_HEADS, seg_head="seg_head")), ("cls_out", CLS_HEAD),
                          ("proj_fc1", CAC_HEADS)):
        if marker in params:
            head_sd = _heads_from_jax(heads, params, batch_stats)
            params = {k: v for k, v in params.items() if k not in heads}
            batch_stats = {k: v for k, v in batch_stats.items() if k not in heads}
    if "seg_head_kernel" in params:  # CAC's classifier
        head_sd["seg_head.weight"] = np.ascontiguousarray(np.asarray(params.pop("seg_head_kernel")).T)
        head_sd["seg_head.bias"] = np.asarray(params.pop("seg_head_bias"))
    if "conv_input" in params.get("backbone_module", {}):
        sd = _spunet_from_jax(params, batch_stats)
    elif {"patch_norm", "patch_embed"} & {*params.get("backbone_module", {}), *batch_stats.get("backbone_module", {})}:
        sd = _ptv2_from_jax(params, batch_stats)
    elif "teacher_backbone" in params:
        sd = _sonata_from_jax(params, batch_stats)
    elif _is_litept(params):
        sd = _ptv3_from_jax(params, batch_stats, _litept_module)
    else:
        sd = _ptv3_from_jax(params, batch_stats)
    sd.update(_ppt_from_jax(ppt))
    sd.update(head_sd)
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
