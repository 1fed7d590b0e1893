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
_MODULE = {
    "embedding/stem_conv": "backbone.embedding.stem.conv",
    "embedding/stem_norm": "backbone.embedding.stem.norm",
}
_UP = {"proj": "proj.0", "proj_norm": "proj.1", "proj_skip": "proj_skip.0",
       "proj_skip_norm": "proj_skip.1"}


def _torch_module(path: str) -> str:
    """flax module path (under the segmentor) -> torch module name."""
    if path == "seg_head":
        return "seg_head"
    assert path.startswith("backbone_module/"), path
    p = path[len("backbone_module/"):]
    if p in _MODULE:
        return _MODULE[p]
    m = re.fullmatch(r"(enc|dec)(\d+)_block(\d+)/(.+)", p)
    if m:
        kind, s, i, rest = m.groups()
        return f"backbone.{kind}.{kind}{s}.block{i}.{_BLOCK[rest]}"
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


def _spunet_from_jax(params: dict, batch_stats: dict) -> Dict[str, np.ndarray]:
    sd = {}
    for key, value in _flat(params).items():
        path, leaf = "/".join(key[:-1]), key[-1]
        if leaf.startswith(("down", "up", "final")):  # parameters held by the backbone itself
            sd[_spunet_module(f"{path}/{leaf}")] = value
        elif leaf in ("weight", "bias", "scale"):
            sd[f"{_spunet_module(path)}.{'weight' if leaf == 'scale' else leaf}"] = value
        else:
            raise KeyError(f"unknown flax leaf {'/'.join(key)}")
    for key, value in _flat(batch_stats).items():
        sd[f"{_spunet_module('/'.join(key[:-1]))}.running_{key[-1]}"] = value
    return sd


def params_from_jax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """DefaultSegmentorV2 + PT-v3m1 or DefaultSegmentor + SpUNet flax trees
    (arrays) -> the port's state dict."""
    if "conv_input" in params.get("backbone_module", {}):
        sd = _spunet_from_jax(params, batch_stats)
        return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
    sd = {}
    for key, value in _flat(params).items():
        module, leaf = _torch_module("/".join(key[:-1])), key[-1]
        if leaf == "kernel":
            sd[f"{module}.weight"] = np.ascontiguousarray(value.T)
        elif leaf == "scale":
            sd[f"{module}.weight"] = value
        elif leaf in ("weight", "bias"):
            sd[f"{module}.{leaf}"] = value
        else:
            raise KeyError(f"unknown flax leaf {'/'.join(key)}")
    for key, value in _flat(batch_stats).items():
        module, leaf = _torch_module("/".join(key[:-1])), key[-1]
        sd[f"{module}.running_{leaf}"] = value
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
