"""Sonata self-distillation pretraining (counterpart of
`pointcept_tpu/models/sonata/sonata.py`; parity target: reference
`pointcept/models/sonata/sonata_v1m1_base.py`).

A student and a teacher, each an enc-mode PT-v3 backbone with two
`OnlineCluster` heads. The global views go through the teacher (train
mode, its own BatchNorm statistics, no gradient) and, grid patches masked
by the learned mask token, through the student; the local views through
the student alone. Each student point is matched to its nearest teacher
point within `match_max_r` (original coordinates) and learns the teacher's
Sinkhorn-balanced prototype assignment: masked global against the same
global view, against the other global view of its scene (the view id with
its lowest bit flipped), and local against the scene's first global view.
After each optimizer step the teacher follows the student by EMA
(`ema_update`). The mask size and ratio, the teacher temperature and the
momentum come per step from `SonataHook`.

State-dict names are the reference's: ``student.backbone.*``,
``student.mask_head.*``, ``student.unmask_head.*`` and the same under
``teacher.``; a head is ``mlp.0`` (Linear), ``mlp.2`` (Linear) and
``prototype.weight_v`` [prototypes, embed] with the reference's fixed
``prototype.weight_g`` of ones (weight norm). So a checkpoint's
``student.backbone`` loads into the fine-tune and linear-probe configs by
the reference's keyword mapping.

Single card: `sync_axis` (the Sinkhorn sums over a mesh) raises.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import serialization as ser
from ...ops.pointops import knn_query
from ...ops.segment_ops import masked_segment_reduce
from ..builder import MODELS
from ..modules import Linear, gelu
from ..point_transformer_v3.point_transformer_v3 import up_cast
from ..utils.structure import PointBatch


class _GELU(nn.Module):
    def forward(self, x):
        return gelu(x)


class OnlineCluster(nn.Module):
    """MLP (Linear, GELU, Linear), l2-normalised, against weight-normed
    prototypes: ``x @ (g * v / |v|).T`` with the reference's fixed g = 1."""

    def __init__(self, in_channels: int, hidden_channels: int = 4096, embed_channels: int = 512,
                 num_prototypes: int = 4096):
        super().__init__()
        self.mlp = nn.Sequential(Linear(in_channels, hidden_channels), _GELU(),
                                 Linear(hidden_channels, embed_channels))
        self.prototype = nn.Module()
        self.prototype.weight_v = nn.Parameter(torch.empty(num_prototypes, embed_channels))
        self.prototype.register_buffer("weight_g", torch.ones(num_prototypes, 1))

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        x = self.mlp(feat)
        x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
        v = self.prototype.weight_v
        w = v / torch.clamp(torch.linalg.vector_norm(v, dim=1, keepdim=True), min=1e-12)
        return x @ (w * self.prototype.weight_g).T


def sinkhorn_knopp(feat: torch.Tensor, temp, valid: torch.Tensor, num_iter: int = 3,
                   sync_axis: Optional[str] = None) -> torch.Tensor:
    """Balanced prototype assignment of `feat` [M, K] in f32 (``exp(feat /
    temp)`` leaves bf16's useful range); invalid rows carry no mass and come
    out 0. One card: `sync_axis` raises."""
    if sync_axis is not None:
        raise NotImplementedError("sinkhorn_knopp: cross-device sums (sync_axis) are not ported")
    validf = valid.float()
    q = torch.exp(feat.float() / temp).T * validf[None, :]  # [K, M]
    n = validf.sum()
    k = q.shape[0]
    q = q / torch.clamp(q.sum(), min=1e-12)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    for _ in range(num_iter):
        q = q / torch.clamp(q.sum(dim=1, keepdim=True), min=1e-12) / k
        col = q.sum(dim=0, keepdim=True)
        q = torch.where(valid[None, :], q / torch.clamp(col, min=1e-12) / torch.clamp(n, min=1.0), zero)
    return (q * torch.clamp(n, min=1.0)).T


def up_cast_width(enc_channels, up_cast_level: int) -> int:
    """The width `Sonata.up_cast` gives: the last stage's and the
    `up_cast_level` stages' before it."""
    return sum(enc_channels[len(enc_channels) - 1 - up_cast_level:])


@MODELS.register_module("Sonata-v1m1")
class Sonata(nn.Module):
    """`forward(data, generator, hyper, mask_scores)` on ``data`` of
    `make_view_inputs` (``global`` and ``local`` PointBatches of one view id a
    row, ``global_origin_coord``, ``local_origin_coord``) returns ``loss``,
    ``mask_loss``, ``roll_mask_loss``, ``unmask_loss`` (those with a weight
    above 0) and the three forwards' ``diagnostics``. `generator` draws the
    mask scores (unless `mask_scores` [global capacity] are given), the order
    shuffles and the drop-path masks.

    `head_in_channels` is read from the backbone (`up_cast_width`): the
    config's value is kept as ``config_head_in_channels`` and must agree
    only with `strict_head_in_channels` (the ScanNet pretraining config says
    1,232 where its backbone gives 1,088)."""

    def __init__(self, backbone=None, head_in_channels: int = 1088, head_hidden_channels: int = 4096,
                 head_embed_channels: int = 512, head_num_prototypes: int = 4096, num_global_view: int = 2,
                 num_local_view: int = 4, mask_size_start: float = 0.1, mask_size_base: float = 0.4,
                 mask_size_warmup_ratio: float = 0.05, mask_size_scale: float = 1.0,
                 mask_ratio_start: float = 0.3, mask_ratio_base: float = 0.7,
                 mask_ratio_warmup_ratio: float = 0.05, mask_jitter: Optional[float] = None,
                 teacher_temp_start: float = 0.04, teacher_temp_base: float = 0.07,
                 teacher_temp_warmup_ratio: float = 0.05, student_temp: float = 0.1,
                 mask_loss_weight: float = 2 / 8, roll_mask_loss_weight: float = 2 / 8,
                 unmask_loss_weight: float = 4 / 8, momentum_base: float = 0.996, momentum_final: float = 1.0,
                 match_max_k: int = 8, match_max_r: float = 0.08, up_cast_level: int = 2,
                 sync_axis: Optional[str] = None, strict_head_in_channels: bool = False):
        super().__init__()
        if sync_axis is not None:
            raise NotImplementedError("Sonata: sync_axis (Sinkhorn over a mesh) is not ported; one card")
        if mask_jitter is not None:
            raise NotImplementedError("Sonata: mask_jitter is not ported")
        # every scalar argument as a field: SonataHook reads the schedules'
        for name, value in list(locals().items()):
            if name not in ("self", "backbone", "__class__", "head_in_channels"):
                setattr(self, name, value)
        student, teacher = nn.ModuleDict(), nn.ModuleDict()
        for d in (student, teacher):
            d["backbone"] = MODELS.build(dict(backbone))
        bb = student["backbone"]
        if not getattr(bb, "enc_mode", False):
            raise ValueError("Sonata: the backbone must be built with enc_mode=True")
        width = up_cast_width(bb.enc_channels, up_cast_level)
        if strict_head_in_channels and width != head_in_channels:
            raise ValueError(f"Sonata: head_in_channels={head_in_channels} but up_cast gives {width}")
        self.config_head_in_channels = head_in_channels
        self.head_in_channels = width
        for d in (student, teacher):
            for name in ("mask_head", "unmask_head"):
                d[name] = OnlineCluster(width, head_hidden_channels, head_embed_channels, head_num_prototypes)
        self.student, self.teacher = student, teacher

    # ------------------------------------------------------------ the teacher
    def post_init(self) -> None:
        """After the random init: the teacher starts as a copy of the student
        and is taken out of every optimizer (requires_grad off)."""
        self.teacher.load_state_dict(self.student.state_dict())
        for p in self.teacher.parameters():
            p.requires_grad_(False)

    def ema_pairs(self):
        """(teacher parameters, student parameters), paired by name."""
        s = dict(self.student.named_parameters())
        names = [n for n, _ in self.teacher.named_parameters()]
        return [p for _, p in self.teacher.named_parameters()], [s[n] for n in names]

    @torch.no_grad()
    def ema_update(self, momentum: Optional[float] = None) -> None:
        """teacher <- m * teacher + (1 - m) * student, in f32 as
        ``(m * t) + ((1 - m) * s)`` with python-float m; the teacher's
        BatchNorm statistics stay its own."""
        m = float(self.momentum_base if momentum is None else momentum)
        t, s = self.ema_pairs()
        torch._foreach_mul_(t, m)
        torch._foreach_add_(t, torch._foreach_mul(s, 1.0 - m))

    # -------------------------------------------------------------- utilities
    def generate_mask(self, pb: PointBatch, origin_coord: torch.Tensor, mask_size: float, mask_ratio: float,
                      scores: torch.Tensor):
        """Grid-patch masking: the points of a scene fall in cubes of
        `mask_size` from the scene's least origin coordinate; patch p (a run
        of equal z-order keys, P of them) ranks by ``scores[p]`` among
        ``scores[:P]``, and the patches of rank below ``mask_ratio * P``
        are masked: a random permutation of the patches, as the reference
        draws. (The JAX package ranks ``scores[p]`` among all N scores, so
        it masks about ``mask_ratio * P / N`` of the patches.) Returns (mask
        [N] bool, patch id [N], N where invalid)."""
        n = pb.capacity
        b = torch.clamp(pb.batch, 0, pb.num_scenes - 1).long()
        start = masked_segment_reduce(
            torch.where(pb.mask[:, None], origin_coord, torch.full((), 1e9, device=pb.device)),
            torch.clamp(pb.batch, min=0), pb.mask, pb.num_scenes, "min")
        rel = origin_coord - start[b]
        grid = torch.clamp(torch.floor(rel / mask_size).to(torch.int32), 0, (1 << 16) - 1)
        keys = ser.encode(grid, pb.key_batch(), 16, "z")
        order = ser.argsort_keys(keys, 16).long()
        sk = keys[order]
        valid_sorted = pb.mask[order]
        prev_eq = torch.cat([torch.zeros(1, dtype=torch.bool, device=pb.device),
                             ser.keys_equal(sk[1:], sk[:-1])])
        head = valid_sorted & ~prev_eq
        cluster_sorted = torch.cumsum(head.to(torch.int32), 0) - 1
        num_patches = head.sum()
        cluster = torch.full((n,), n, dtype=torch.int64, device=pb.device)
        cluster[order] = torch.where(valid_sorted, cluster_sorted.long(), n)
        patch_scores = torch.where(torch.arange(n, device=pb.device) < num_patches, scores.float(),
                                   torch.full((), float("inf"), device=pb.device))
        rank = torch.argsort(torch.argsort(patch_scores, stable=True), stable=True)
        tag = (rank < mask_ratio * num_patches).to(torch.int32)
        tag = torch.cat([tag, torch.zeros(1, dtype=torch.int32, device=pb.device)])
        return (tag[torch.clamp(cluster, max=n)] == 1) & pb.mask, cluster

    def match_neighbour(self, q_coord, q_batch, q_mask, t_coord, t_batch, t_mask):
        """The nearest teacher point of each query within its scene, valid
        within `match_max_r`: (index [Nq], valid [Nq])."""
        idx, dist = knn_query(1, t_coord, torch.where(t_mask, t_batch, -1), q_coord,
                              torch.where(q_mask, q_batch, -2))
        return idx[:, 0].long(), (dist[:, 0] < self.match_max_r) & q_mask

    def up_cast(self, pb: PointBatch, skips: list) -> PointBatch:
        """Concatenate the features of `up_cast_level` earlier stages, each
        point taking its cluster's feature of the stage after it."""
        if len(skips) < self.up_cast_level:
            raise ValueError(f"Sonata: up_cast_level={self.up_cast_level} but the backbone has {len(skips)} skips")
        return up_cast(pb, skips, self.up_cast_level)

    def _ce(self, target, pred_sim, valid, batch, num_segments: int) -> torch.Tensor:
        """Cross-entropy of the student's assignment against `target`, a mean
        over each view's valid points, then over the views that have any."""
        logp = F.log_softmax(pred_sim / self.student_temp, dim=-1)
        per_point = -torch.sum(target * logp, dim=-1)
        seg = torch.clamp(batch, 0, num_segments - 1)
        per_view = masked_segment_reduce(per_point, seg, valid, num_segments, "mean")
        has = masked_segment_reduce(torch.ones_like(per_point), seg, valid, num_segments, "sum") > 0
        return torch.sum(per_view * has) / torch.clamp(has.sum(), min=1).to(per_view.dtype)

    # ----------------------------------------------------------------- forward
    def forward(self, data: dict, generator: Optional[torch.Generator] = None, hyper: Optional[dict] = None,
                mask_scores: Optional[torch.Tensor] = None) -> dict:
        hyper = hyper or {}
        mask_size = float(hyper.get("mask_size", self.mask_size_base)) * self.mask_size_scale
        mask_ratio = float(hyper.get("mask_ratio", self.mask_ratio_base))
        teacher_temp = float(hyper.get("teacher_temp", self.teacher_temp_base))
        ngv, nlv = self.num_global_view, self.num_local_view
        g_origin, l_origin = data["global_origin_coord"], data["local_origin_coord"]
        g_pb = data["global"].replace(num_scenes=data["global"].num_scenes * ngv, origin_coord=g_origin)
        l_pb = data["local"].replace(num_scenes=data["local"].num_scenes * nlv, origin_coord=l_origin)
        if mask_scores is None:
            if generator is None:
                raise ValueError("Sonata: the mask scores are drawn from an explicit generator")
            mask_scores = torch.rand(g_pb.capacity, generator=generator, device=g_pb.device)
        global_mask, _ = self.generate_mask(g_pb, g_origin, mask_size, mask_ratio, mask_scores)
        grad = contextlib.nullcontext() if self.training else torch.no_grad()
        diag = {}

        def run(backbone, pb, **kw):
            out, d, skips = backbone(pb, generator=generator, **kw)
            for k, v in d.items():
                diag.setdefault(k, []).extend(v)
            return self.up_cast(out, skips)

        result, losses = {}, []
        with torch.no_grad():
            t_pb = run(self.teacher["backbone"], g_pb)
        num_g = g_pb.num_scenes
        with grad:
            if self.mask_loss_weight > 0 or self.roll_mask_loss_weight > 0:
                with torch.no_grad():
                    t_mask_sim = self.teacher["mask_head"](t_pb.feat)
                student = self.student["backbone"]
                if student.embedding.mask_token is not None:
                    s_pb = run(student, g_pb, patch_mask=global_mask)
                else:
                    zero = torch.zeros((), dtype=g_pb.feat.dtype, device=g_pb.device)
                    s_pb = run(student, g_pb.replace(feat=torch.where(global_mask[:, None], zero, g_pb.feat)))
                mask_pred_sim = self.student["mask_head"](s_pb.feat)
                rolled = torch.where(t_pb.mask, t_pb.batch ^ 1, t_pb.batch)
                for name, weight, t_batch in (("mask_loss", self.mask_loss_weight, t_pb.batch),
                                              ("roll_mask_loss", self.roll_mask_loss_weight, rolled)):
                    if weight <= 0:
                        continue
                    sel, valid = self.match_neighbour(s_pb.origin_coord, s_pb.batch, s_pb.mask, t_pb.origin_coord,
                                                      t_batch, t_pb.mask)
                    with torch.no_grad():
                        target = sinkhorn_knopp(t_mask_sim[sel], teacher_temp, valid)
                    result[name] = self._ce(target, mask_pred_sim, valid, s_pb.batch, num_g)
                    losses.append(result[name] * weight)
            if self.unmask_loss_weight > 0:
                with torch.no_grad():
                    t_unmask_sim = self.teacher["unmask_head"](t_pb.feat)
                lp = run(self.student["backbone"], l_pb)
                unmask_pred_sim = self.student["unmask_head"](lp.feat)
                # a local view (id b * nlv + v) against its scene's first
                # global view (id b * ngv)
                l_scene = torch.where(lp.mask, lp.batch // nlv, -2)
                principal = t_pb.mask & (t_pb.batch % ngv == 0)
                g_scene = torch.where(principal, t_pb.batch // ngv, -1)
                sel, valid = self.match_neighbour(lp.origin_coord, l_scene, lp.mask, t_pb.origin_coord, g_scene,
                                                  principal)
                with torch.no_grad():
                    target = sinkhorn_knopp(t_unmask_sim[sel], teacher_temp, valid)
                result["unmask_loss"] = self._ce(target, unmask_pred_sim, valid, lp.batch, l_pb.num_scenes)
                losses.append(result["unmask_loss"] * self.unmask_loss_weight)
            result["loss"] = sum(losses)
        result["diagnostics"] = diag
        return result


@MODELS.register_module("Sonata-v1m2")
class SonataUniTeacherHead(Sonata):
    """One shared teacher head: not ported."""

    def __init__(self, **kwargs):
        raise NotImplementedError("Sonata-v1m2 (one shared teacher head) is not ported yet")


@MODELS.register_module("Sonata-v1m3")
class SonataDistill(Sonata):
    """Distillation from a frozen pretrained teacher: not ported."""

    def __init__(self, **kwargs):
        raise NotImplementedError("Sonata-v1m3 (a frozen pretrained teacher) is not ported yet")
