"""PointBatch: the fixed-capacity batched point cloud (counterpart of
`pointcept_tpu/models/utils/structure.py`).

A batch is a concatenation of scenes padded to ``capacity`` rows;
``batch[i]`` is the scene id (-1 for padding). The layout matches the JAX
package's, so the two can be compared row for row.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...ops import serialization as ser


def grid_bits(grid_coord) -> int:
    """Bits of the largest grid coordinate of a host array (numpy or a CPU
    tensor), 0 for an empty one or one on the card (which would need a
    host wait): the least depth at which the grid serializes unclamped."""
    if grid_coord is None or (torch.is_tensor(grid_coord) and grid_coord.device.type != "cpu"):
        return 0
    a = grid_coord.numpy() if torch.is_tensor(grid_coord) else np.asarray(grid_coord)
    return int(a.max()).bit_length() if a.size else 0


def serialization_depth(serialize_depth: int, pb: "PointBatch") -> int:
    """The depth a batch serializes at: the config's `serialize_depth`, or
    more where the batch's grid reaches past ``2**serialize_depth`` cells
    (the reference takes the depth from the data, `Point.serialization`;
    the JAX package clamps every coordinate into its static depth instead,
    so voxels past it collapse onto the grid's face). Equal to the config's
    wherever the grid fits it, so in range the keys are the JAX package's."""
    depth = max(serialize_depth, pb.grid_depth)
    if depth > 16:
        raise ValueError(f"serialize_depth={serialize_depth}: the batch's grid reaches {(1 << pb.grid_depth) - 1} "
                         f"cells or more ({pb.grid_depth} bits), past the 16 bits a key holds")
    return depth


def order_permutation(num_orders: int, generator: torch.Generator) -> torch.Tensor:
    """A random permutation of the serialization orders (the train-time order
    shuffle), on the generator's device."""
    return torch.randperm(num_orders, generator=generator, device=generator.device)


@dataclasses.dataclass
class PointBatch:
    coord: torch.Tensor  # [N, 3] float32
    feat: Optional[torch.Tensor]  # [N, C]
    grid_coord: Optional[torch.Tensor]  # [N, 3] int32 voxel coords (>= 0)
    batch: torch.Tensor  # [N] int32 scene id, -1 = padding
    segment: Optional[torch.Tensor] = None  # [N] int32 labels, -1 = ignore
    serialized_keys: Optional[torch.Tensor] = None  # [S, N, 3] int32 key triples
    serialized_order: Optional[torch.Tensor] = None  # [S, N] int32
    serialized_inverse: Optional[torch.Tensor] = None  # [S, N] int32
    serialized_depth: int = 0
    num_scenes: int = 1
    origin_coord: Optional[torch.Tensor] = None  # [N, 3] float32 pre-augmentation coords (SSL)
    grid_depth: int = 0  # bits of the largest grid coordinate (`grid_bits`), 0 = not known
    condition: Optional[str] = None  # the batch's dataset (PPT: one condition a batch)
    context: Optional[torch.Tensor] = None  # [1, context_channels] the condition's embedding (PPT)
    instance: Optional[torch.Tensor] = None  # [N] int32 instance ids, -1 = none (PointGroup)
    instance_centroid: Optional[torch.Tensor] = None  # [N, 3] float32 each point's instance centroid
    category: Optional[torch.Tensor] = None  # [num_scenes] int32 each scene's class, -1 = padding (classifiers)

    def replace(self, **kw) -> "PointBatch":
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.batch.device

    @property
    def capacity(self) -> int:
        return self.coord.shape[0]

    @property
    def mask(self) -> torch.Tensor:
        return self.batch >= 0

    @property
    def num_points(self) -> torch.Tensor:
        return self.mask.sum().to(torch.int32)

    def scene_counts(self) -> torch.Tensor:
        """[num_scenes] int32 valid-point count per scene."""
        ids = torch.arange(self.num_scenes, dtype=self.batch.dtype, device=self.device)
        return (self.batch[None, :] == ids[:, None]).sum(dim=1).to(torch.int32)

    def with_grid_coord(self, grid_size: float) -> "PointBatch":
        """Voxel grid coords from metric coords when absent: per-scene
        min-shifted floor(coord / grid_size)."""
        if self.grid_coord is not None:
            return self
        b = torch.clamp(self.batch, 0, self.num_scenes - 1).long()
        coord = torch.where(self.mask[:, None], self.coord, torch.full_like(self.coord, 1e9))
        mins = torch.full((self.num_scenes, 3), 1e9, dtype=coord.dtype, device=self.device)
        mins = mins.scatter_reduce(0, b[:, None].expand(-1, 3), coord, reduce="amin")
        mins = torch.where(mins < 1e9, mins, 0.0)
        grid = torch.floor((self.coord - mins[b]) / grid_size).to(torch.int32)
        return self.replace(grid_coord=torch.clamp(grid, min=0))

    def key_batch(self) -> torch.Tensor:
        """Batch ids with padding mapped to the sort sentinel (sorts last)."""
        return torch.where(self.batch >= 0, self.batch, ser.BATCH_SENTINEL).to(torch.int32)

    def serialize(
        self,
        orders: Sequence[str] = ("z", "z-trans", "hilbert", "hilbert-trans"),
        depth: int = 12,
        sort_indices: Optional[Sequence[int]] = None,
        key_orders: Optional[Sequence[int]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> "PointBatch":
        """Per-order curve keys, orders and inverses.

        `sort_indices` restricts which orders are sorted (the others keep
        identity permutations); `key_orders` which are encoded (the others
        alias keys[0] and must not be read). With a `generator`, every order
        is encoded and sorted and the orders are then shuffled
        (`order_permutation`); it excludes the two restrictions."""
        assert depth <= 16
        if generator is not None:
            assert sort_indices is None and key_orders is None, "a shuffle needs every order"
        gc = torch.clamp(self.grid_coord, 0, (1 << depth) - 1)
        kb = self.key_batch()
        if key_orders is None:
            key_orders = range(len(orders))
        assert 0 in key_orders, "order 0 drives pooling and block tables"
        k0 = ser.encode(gc, kb, depth, orders[0])
        keys = torch.stack(
            [ser.encode(gc, kb, depth, orders[i]) if (i in key_orders and i != 0) else k0
             for i in range(len(orders))]
        )
        iota = torch.arange(self.capacity, dtype=torch.int32, device=self.device)
        order, inverse = [], []
        for i in range(len(orders)):
            if sort_indices is None or i in sort_indices:
                o = ser.argsort_keys(keys[i], depth)
                order.append(o)
                inverse.append(ser.invert_order(o))
            else:
                order.append(iota)
                inverse.append(iota)
        out = self.replace(
            serialized_keys=keys,
            serialized_order=torch.stack(order),
            serialized_inverse=torch.stack(inverse),
            serialized_depth=depth,
        )
        return out if generator is None else out.shuffle_orders_(generator)

    def shuffle_orders_(self, generator: torch.Generator) -> "PointBatch":
        """The serialized keys, orders and inverses in a random order of the
        curves (drawn by `order_permutation`)."""
        perm = order_permutation(self.serialized_order.shape[0], generator).to(self.device)
        return self.replace(
            serialized_keys=self.serialized_keys[perm],
            serialized_order=self.serialized_order[perm],
            serialized_inverse=self.serialized_inverse[perm],
        )

    def reorder(self, perm: torch.Tensor, inv: torch.Tensor, rebase_orders=None,
                rebase_keys=True) -> "PointBatch":
        """Permute every per-point array (new[i] = old[perm[i]]).

        Serialized orders/inverses are rebased (order'_i = inv[order_i],
        inverse'_i = inverse_i[perm]) for the `rebase_orders` index set;
        order 0 and unlisted orders become identities. `rebase_keys` (True or
        an index set) selects the keys that are permuted; the others alias
        the permuted keys[0]."""
        p = perm.long()
        s = self.serialized_order.shape[0] if self.serialized_order is not None else 0
        iota = torch.arange(self.capacity, dtype=torch.int32, device=self.device)
        rebase = range(s) if rebase_orders is None else rebase_orders

        def take(a):
            return None if a is None else a[p]

        new_order = new_inverse = new_keys = None
        if s:
            new_order = torch.stack([
                inv[self.serialized_order[i].long()] if (i in rebase and i != 0) else iota
                for i in range(s)
            ])
            new_inverse = torch.stack([
                self.serialized_inverse[i][p] if (i in rebase and i != 0) else iota
                for i in range(s)
            ])
            if rebase_keys:
                kset = set(range(s) if rebase_keys is True else rebase_keys) | {0}
                k0 = self.serialized_keys[0][p]
                new_keys = torch.stack([
                    k0 if i == 0 else (self.serialized_keys[i][p] if i in kset else k0)
                    for i in range(s)
                ])
        return self.replace(
            coord=take(self.coord),
            origin_coord=take(self.origin_coord),
            feat=take(self.feat),
            grid_coord=take(self.grid_coord),
            batch=take(self.batch),
            segment=take(self.segment),
            instance=take(self.instance),
            instance_centroid=take(self.instance_centroid),
            serialized_keys=new_keys,
            serialized_order=new_order,
            serialized_inverse=new_inverse,
        )

    def patch_partition(self, order_index: int, patch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Static patch layout for serialized attention.

        Returns slot_to_point [P] (the point feeding each attention slot; dead
        slots read point 0) and point_to_slot [N] (the slot holding each
        point's own output). Scene tails re-read the points one patch earlier
        (the reference's tail duplication); scenes smaller than one patch wrap
        cyclically."""
        assert self.serialized_order is not None, "call serialize() first"
        K = patch_size
        B = self.num_scenes
        dev = self.device
        order = self.serialized_order[order_index]
        inverse = self.serialized_inverse[order_index]
        n = self.scene_counts()
        p = ((n + K - 1) // K) * K
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        s_excl = torch.cat([zero, torch.cumsum(n, 0)[:-1].to(torch.int32)])
        q_incl = torch.cumsum(p, 0).to(torch.int32)
        q_excl = torch.cat([zero, q_incl[:-1]])

        P = self.padded_capacity(K)
        t = torch.arange(P, dtype=torch.int32, device=dev)
        scene = torch.searchsorted(q_incl, t, right=True).to(torch.int32)
        live = scene < B
        scene_c = torch.clamp(scene, 0, B - 1).long()
        o = t - q_excl[scene_c]
        n_s = n[scene_c]
        idx = torch.where(o < n_s, o, torch.where(o >= K, o - K, o % torch.clamp(n_s, min=1)))
        idx = torch.minimum(idx, torch.clamp(n_s - 1, min=0))
        g = s_excl[scene_c] + idx
        slot_to_point = torch.where(
            live & (n_s > 0), order[torch.clamp(g, 0, self.capacity - 1).long()], 0
        ).to(torch.int32)

        pscene = torch.clamp(self.batch, 0, B - 1).long()
        slot = q_excl[pscene] + (inverse - s_excl[pscene])
        point_to_slot = torch.clamp(torch.where(self.mask, slot, 0), 0, P - 1).to(torch.int32)
        return slot_to_point, point_to_slot

    def padded_capacity(self, patch_size: int) -> int:
        """Static upper bound on the patch-aligned slot count."""
        K = patch_size
        return ((self.capacity + K - 1) // K + self.num_scenes) * K
