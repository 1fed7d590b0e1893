"""Host-side numpy transforms (counterparts in `pointcept_tpu/datasets/transform.py`).

The transforms of the ScanNet PTv3-base config and the synthetic configs:
CenterShift, the augmentations (RandomDropout, RandomRotate, RandomScale,
RandomFlip, RandomJitter, ElasticDistortion, ChromaticAutoContrast,
ChromaticTranslation, ChromaticJitter), GridSample, SphereCrop (random and
center mode), NormalizeColor, ToTensor (a no-op: arrays stay numpy until
the collate) and Collect; for the tester, GridSample's test mode
(`count.max()` fragments, each holding one point of every voxel, with its
source `index`) and `return_inverse`, RandomRotateTargetAngle and Copy;
for Sonata's pretraining, RandomColorJitter, RandomColorGrayScale,
RandomColorDrop and MultiViewGenerator (global and local crops, each view
augmented on its own); for the indoor datasets' configs, ShufflePoint,
RandomDropColor and RandomDropNormal; for instance segmentation,
InstanceParser; for classification and part segmentation, NormalizeCoord
and RandomShift. Each draws from `np.random` and
`random` in the JAX version's order, so one seed gives the same arrays bit
for bit.
"""

from __future__ import annotations

import copy
import numbers
import random
from collections.abc import Sequence

import numpy as np

from ..utils.registry import Registry

TRANSFORMS = Registry("transforms")

DEFAULT_INDEX_VALID_KEYS = ["coord", "color", "normal", "superpoint", "strength", "segment", "instance"]


def index_operator(data_dict, index, duplicate=False):
    """Apply an index selection to every key in index_valid_keys: in place,
    or (`duplicate`) into a new dict that shares the other values."""
    if "index_valid_keys" not in data_dict:
        data_dict["index_valid_keys"] = list(DEFAULT_INDEX_VALID_KEYS)
    if not duplicate:
        for key in data_dict["index_valid_keys"]:
            if key in data_dict:
                data_dict[key] = data_dict[key][index]
        return data_dict
    out = {}
    for key, value in data_dict.items():
        if key in data_dict["index_valid_keys"]:
            out[key] = value[index]
        elif key == "index_valid_keys":
            out[key] = copy.copy(value)
        else:
            out[key] = value
    return out


class Compose:
    """Sequential transform pipeline built from a list of cfg dicts."""

    def __init__(self, cfg=None):
        self.cfg = cfg if cfg is not None else []
        self.transforms = [TRANSFORMS.build(dict(t)) for t in self.cfg]

    def __call__(self, data_dict):
        for t in self.transforms:
            data_dict = t(data_dict)
        return data_dict


@TRANSFORMS.register_module()
class Collect:
    """Pick keys, emit the offset, concatenate feat_keys.

    An offset key the pipeline already holds is kept as it is: the per-view
    offsets of `MultiViewGenerator` (``global_offset``, ``local_offset``),
    which Sonata's config names in `offset_keys_dict`. The JAX package
    replaces them with the total count, so both views of a scene become one
    scene there; the reference keeps one offset a view
    (``[pc1, pc1', pc2, pc2']``, its Sonata `roll_point`). A key the
    sample lacks raises a KeyError naming it and the keys the sample holds
    (the JAX package's names the key alone)."""

    def __init__(self, keys, offset_keys_dict=None, **kwargs):
        self.keys = [keys] if isinstance(keys, str) else list(keys)
        self.offset_keys = offset_keys_dict if offset_keys_dict is not None else dict(offset="coord")
        self.kwargs = kwargs

    def __call__(self, data_dict):
        wanted = list(self.keys) + [k for keys in self.kwargs.values() for k in keys]
        missing = [k for k in wanted if k not in data_dict]
        if missing:
            # ScanObjectNN's samples carry no normals, which its configs collect
            raise KeyError(f"Collect: the sample has no {missing} (keys {self.keys}, {self.kwargs}); "
                           f"it holds {sorted(data_dict)}")
        data = {key: data_dict[key] for key in self.keys}
        for key, value in self.offset_keys.items():
            data[key] = data_dict[key] if key in data_dict else np.array([data_dict[value].shape[0]])
        for name, keys in self.kwargs.items():
            assert isinstance(keys, Sequence)
            data[name.replace("_keys", "")] = np.concatenate(
                [np.asarray(data_dict[key], dtype=np.float32) for key in keys], axis=1
            )
        return data


@TRANSFORMS.register_module()
class Copy:
    """Copy values to new keys (arrays by `.copy()`, others deeply)."""

    def __init__(self, keys_dict=None):
        self.keys_dict = keys_dict if keys_dict is not None else dict(coord="origin_coord",
                                                                       segment="origin_segment")

    def __call__(self, data_dict):
        for key, value in self.keys_dict.items():
            v = data_dict[key]
            data_dict[value] = v.copy() if isinstance(v, np.ndarray) else copy.deepcopy(v)
        return data_dict


@TRANSFORMS.register_module("Add")
@TRANSFORMS.register_module()
class Update:
    """Set keys to values (one class under both names, as the JAX
    package's): the PPT configs' ``Add(keys_dict={"condition": ...})``
    tags each sample with its dataset."""

    def __init__(self, keys_dict=None):
        self.keys_dict = keys_dict if keys_dict is not None else dict()

    def __call__(self, data_dict):
        for key, value in self.keys_dict.items():
            data_dict[key] = value
        return data_dict


@TRANSFORMS.register_module()
class ToTensor:
    """A no-op, as in the JAX package: arrays stay numpy until the collate,
    and the loader moves the collated batch to the card."""

    def __call__(self, data):
        return data


@TRANSFORMS.register_module()
class NormalizeColor:
    def __call__(self, data_dict):
        if "color" in data_dict:
            data_dict["color"] = data_dict["color"] / 255
        return data_dict


@TRANSFORMS.register_module()
class NormalizeCoord:
    """Centre the cloud on its mean and scale it into the unit sphere."""

    def __call__(self, data_dict):
        if "coord" in data_dict:
            centroid = np.mean(data_dict["coord"], axis=0)
            data_dict["coord"] = data_dict["coord"] - centroid
            m = np.max(np.sqrt(np.sum(data_dict["coord"] ** 2, axis=1)))
            data_dict["coord"] = data_dict["coord"] / m
        return data_dict


@TRANSFORMS.register_module()
class RandomShift:
    """Add one offset a cloud, each axis's drawn from its (lo, hi) range."""

    def __init__(self, shift=((-0.2, 0.2), (-0.2, 0.2), (0, 0))):
        self.shift = shift

    def __call__(self, data_dict):
        if "coord" in data_dict:
            s = [np.random.uniform(lo, hi) for lo, hi in self.shift]
            data_dict["coord"] = data_dict["coord"] + s
        return data_dict


@TRANSFORMS.register_module()
class CenterShift:
    def __init__(self, apply_z=True):
        self.apply_z = apply_z

    def __call__(self, data_dict):
        if "coord" in data_dict:
            x_min, y_min, z_min = data_dict["coord"].min(axis=0)
            x_max, y_max, _ = data_dict["coord"].max(axis=0)
            shift = [(x_min + x_max) / 2, (y_min + y_max) / 2, z_min if self.apply_z else 0]
            data_dict["coord"] = data_dict["coord"] - shift
        return data_dict


@TRANSFORMS.register_module()
class RandomDropout:
    def __init__(self, dropout_ratio=0.2, dropout_application_ratio=0.5):
        self.dropout_ratio = dropout_ratio
        self.dropout_application_ratio = dropout_application_ratio

    def __call__(self, data_dict):
        if random.random() < self.dropout_application_ratio:
            n = len(data_dict["coord"])
            idx = np.random.choice(n, int(n * (1 - self.dropout_ratio)), replace=False)
            if "sampled_index" in data_dict:
                # the labelled points of the data-efficient benchmarks survive
                idx, data_dict["sampled_index"] = _keep_sampled(idx, data_dict)
            data_dict = index_operator(data_dict, idx)
        return data_dict


@TRANSFORMS.register_module()
class ShufflePoint:
    """Every point-wise key in one random order (`np.random.shuffle`)."""

    def __call__(self, data_dict):
        shuffle_index = np.arange(data_dict["coord"].shape[0])
        np.random.shuffle(shuffle_index)
        return index_operator(data_dict, shuffle_index)


class _RandomDropChannel:
    """With probability `drop_application_ratio` (a `random.random()` draw),
    zero the `key` rows of `drop_ratio` of the points, drawn without
    replacement."""

    key = ""

    def __init__(self, drop_ratio=0.2, drop_application_ratio=0.5):
        self.drop_ratio = drop_ratio
        self.drop_application_ratio = drop_application_ratio

    def __call__(self, data_dict):
        if self.key in data_dict and random.random() < self.drop_application_ratio:
            n = len(data_dict[self.key])
            idx = np.random.choice(n, int(n * self.drop_ratio), replace=False)
            data_dict[self.key][idx] = 0.0
        return data_dict


@TRANSFORMS.register_module()
class RandomDropColor(_RandomDropChannel):
    key = "color"


@TRANSFORMS.register_module()
class RandomDropNormal(_RandomDropChannel):
    key = "normal"


def _keep_sampled(idx: np.ndarray, data_dict: dict):
    """(`idx` with every ``sampled_index`` point added, sorted and unique;
    the positions of those points in it)."""
    idx = np.unique(np.append(idx, data_dict["sampled_index"]))
    mask = np.zeros(len(data_dict["segment"]), bool)
    mask[data_dict["sampled_index"]] = True
    return idx, np.flatnonzero(mask[idx])


def _rotation_matrix(axis: str, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    if axis == "z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    raise NotImplementedError(axis)


class _RotateBase:
    """Rotation about `axis` through `center` (the coords' box center when
    None) with probability `p`; subclasses draw the angle (in units of pi)."""

    def __init__(self, angle, center=None, axis="z", always_apply=False, p=0.5):
        self.angle = angle
        self.axis = axis
        self.center = center
        self.p = 1 if always_apply else p

    def draw_angle(self) -> float:
        raise NotImplementedError

    def __call__(self, data_dict):
        if random.random() > self.p:
            return data_dict
        rot_t = _rotation_matrix(self.axis, self.draw_angle() * np.pi)
        if "coord" in data_dict:
            if self.center is None:
                center = (data_dict["coord"].min(axis=0) + data_dict["coord"].max(axis=0)) / 2
            else:
                center = np.asarray(self.center)
            data_dict["coord"] = (data_dict["coord"] - center) @ rot_t.T + center
        if "normal" in data_dict:
            data_dict["normal"] = data_dict["normal"] @ rot_t.T
        return data_dict


@TRANSFORMS.register_module()
class RandomRotate(_RotateBase):
    def __init__(self, angle=None, center=None, axis="z", always_apply=False, p=0.5):
        super().__init__([-1, 1] if angle is None else angle, center, axis, always_apply, p)

    def draw_angle(self) -> float:
        return np.random.uniform(self.angle[0], self.angle[1])


@TRANSFORMS.register_module()
class RandomRotateTargetAngle(_RotateBase):
    """A rotation by one of the listed angles (the tester's views)."""

    def __init__(self, angle=(1 / 2, 1, 3 / 2), center=None, axis="z", always_apply=False, p=0.75):
        super().__init__(angle, center, axis, always_apply, p)

    def draw_angle(self) -> float:
        return np.random.choice(self.angle)


@TRANSFORMS.register_module()
class RandomScale:
    def __init__(self, scale=None, anisotropic=False):
        self.scale = scale if scale is not None else [0.95, 1.05]
        self.anisotropic = anisotropic

    def __call__(self, data_dict):
        if "coord" in data_dict:
            scale = np.random.uniform(self.scale[0], self.scale[1], 3 if self.anisotropic else 1)
            data_dict["coord"] = data_dict["coord"] * scale
        return data_dict


@TRANSFORMS.register_module()
class RandomFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, data_dict):
        for dim in (0, 1):
            if np.random.rand() < self.p:
                if "coord" in data_dict:
                    data_dict["coord"][:, dim] = -data_dict["coord"][:, dim]
                if "normal" in data_dict:
                    data_dict["normal"][:, dim] = -data_dict["normal"][:, dim]
        return data_dict


@TRANSFORMS.register_module()
class RandomJitter:
    def __init__(self, sigma=0.01, clip=0.05):
        assert clip > 0
        self.sigma = sigma
        self.clip = clip

    def __call__(self, data_dict):
        if "coord" in data_dict:
            jitter = np.clip(self.sigma * np.random.randn(data_dict["coord"].shape[0], 3), -self.clip, self.clip)
            data_dict["coord"] = data_dict["coord"] + jitter
        return data_dict


@TRANSFORMS.register_module()
class ChromaticAutoContrast:
    def __init__(self, p=0.2, blend_factor=None):
        self.p = p
        self.blend_factor = blend_factor

    def __call__(self, data_dict):
        if "color" in data_dict and np.random.rand() < self.p:
            color = data_dict["color"]
            lo = np.min(color, 0, keepdims=True)
            hi = np.max(color, 0, keepdims=True)
            diff = hi - lo
            if not np.any(diff > 0):
                return data_dict
            scale = np.divide(255, diff, out=np.ones_like(diff, dtype=color.dtype), where=diff > 0)
            contrast_feat = (color[:, :3] - lo) * scale
            blend = np.random.rand() if self.blend_factor is None else self.blend_factor
            data_dict["color"][:, :3] = (1 - blend) * color[:, :3] + blend * contrast_feat
        return data_dict


@TRANSFORMS.register_module()
class ChromaticTranslation:
    def __init__(self, p=0.95, ratio=0.05):
        self.p = p
        self.ratio = ratio

    def __call__(self, data_dict):
        if "color" in data_dict and np.random.rand() < self.p:
            tr = (np.random.rand(1, 3) - 0.5) * 255 * 2 * self.ratio
            data_dict["color"][:, :3] = np.clip(tr + data_dict["color"][:, :3], 0, 255)
        return data_dict


@TRANSFORMS.register_module()
class ChromaticJitter:
    def __init__(self, p=0.95, std=0.005):
        self.p = p
        self.std = std

    def __call__(self, data_dict):
        if "color" in data_dict and np.random.rand() < self.p:
            noise = np.random.randn(data_dict["color"].shape[0], 3) * self.std * 255
            data_dict["color"][:, :3] = np.clip(noise + data_dict["color"][:, :3], 0, 255)
        return data_dict


@TRANSFORMS.register_module()
class ElasticDistortion:
    """A smooth random displacement field on the coords: box-blurred white
    noise on a lattice of cell `granularity` (one-cell apron), sampled
    trilinearly at each point, times `magnitude`; applied with probability
    0.95 for each (granularity, magnitude) pair."""

    def __init__(self, distortion_params=None):
        self.distortion_params = [[0.2, 0.4], [0.8, 1.6]] if distortion_params is None else distortion_params

    @staticmethod
    def elastic_distortion(coords, granularity, magnitude):
        from scipy.ndimage import map_coordinates, uniform_filter

        cmin = coords.min(0)
        dims = ((coords.max(0) - cmin) // granularity).astype(int) + 3
        lattice = np.random.randn(*dims, 3).astype(np.float32)
        for _ in range(2):
            lattice = uniform_filter(lattice, size=(3, 3, 3, 1), mode="constant")
        u = ((coords - cmin) / granularity + 1.0).T.astype(np.float32)
        disp = np.stack([map_coordinates(lattice[..., a], u, order=1) for a in range(3)], axis=1)
        return coords + disp * magnitude

    def __call__(self, data_dict):
        if "coord" in data_dict and self.distortion_params is not None:
            if random.random() < 0.95:
                for granularity, magnitude in self.distortion_params:
                    data_dict["coord"] = self.elastic_distortion(data_dict["coord"], granularity, magnitude)
        return data_dict


@TRANSFORMS.register_module()
class GridSample:
    """Hash-based voxel sampling. Train mode: one random point per voxel,
    drawn from `rng` (a numpy RandomState; the global numpy state when
    None). Test mode: a list of `count.max()` fragments, fragment i taking
    point ``i % count`` of every voxel's run, each with its source `index`:
    every fragment holds each voxel once (one voxel grid), and together they
    hold every point. `return_inverse` adds each input point's voxel id
    (``inverse``). The other hash, the min coord and the displacement are
    not ported."""

    def __init__(self, grid_size=0.05, hash_type="fnv", mode="train", return_inverse=False,
                 return_grid_coord=False, rng=None, keys=None, **unported):
        if mode not in ("train", "test"):
            raise ValueError(f"GridSample: mode {mode!r}")
        if hash_type != "fnv" or any(unported.values()):
            raise NotImplementedError(f"GridSample: hash_type={hash_type!r}, {sorted(unported)} are not ported")
        self.grid_size = grid_size
        self.mode = mode
        self.return_inverse = return_inverse
        self.return_grid_coord = return_grid_coord
        self.rng = rng

    def _voxel_runs(self, coord):
        """(grid_coord, order, starts, counts, voxel of each point): the
        points of voxel v are the run ``order[starts[v] : starts[v] + counts[v]]``."""
        grid = np.floor(coord / self.grid_size).astype(np.int64)
        grid = grid - grid.min(0)
        key = self.fnv_hash_vec(grid)
        order = np.argsort(key)
        sk = key[order]
        head = np.empty(sk.shape[0], bool)
        head[0] = True
        np.not_equal(sk[1:], sk[:-1], out=head[1:])
        starts = np.flatnonzero(head)
        counts = np.diff(np.append(starts, sk.shape[0]))
        voxel_of_point = np.empty_like(order)
        voxel_of_point[order] = np.cumsum(head) - 1
        return grid, order, starts, counts, voxel_of_point

    def _attach(self, out, picked, grid, voxel_of_point):
        if self.return_inverse:
            out["inverse"] = voxel_of_point
        if self.return_grid_coord:
            out["grid_coord"] = grid[picked]
            if "grid_coord" not in out["index_valid_keys"]:
                out["index_valid_keys"] = list(out["index_valid_keys"]) + ["grid_coord"]
        return out

    def __call__(self, data_dict):
        grid, order, starts, counts, vox = self._voxel_runs(data_dict["coord"])
        if self.mode == "train":
            rng = self.rng if self.rng is not None else np.random
            picked = order[starts + rng.randint(0, counts.max(), counts.size) % counts]
            if "sampled_index" in data_dict:
                # the labelled points of the data-efficient benchmarks survive
                picked, data_dict["sampled_index"] = _keep_sampled(picked, data_dict)
            return self._attach(index_operator(data_dict, picked), picked, grid, vox)
        parts = []
        for i in range(counts.max()):
            picked = order[starts + i % counts]
            part = index_operator(data_dict, picked, duplicate=True)
            part["index"] = picked
            parts.append(self._attach(part, picked, grid, vox))
        return parts

    @staticmethod
    def fnv_hash_vec(arr):
        """Row-wise FNV-1a (64-bit offset basis / prime)."""
        arr = np.ascontiguousarray(arr, dtype=np.uint64)
        h = np.full(arr.shape[0], np.uint64(0xCBF29CE484222325))
        for col in arr.T:
            h = (h * np.uint64(0x100000001B3)) ^ col
        return h


@TRANSFORMS.register_module()
class SphereCrop:
    """Keep the `point_max` points nearest to a center point: a random point
    (random mode) or the middle row (center mode)."""

    def __init__(self, point_max=80000, sample_rate=None, mode="random"):
        if mode not in ("random", "center"):
            raise NotImplementedError(f"SphereCrop: mode {mode!r} is not ported")
        self.point_max = point_max
        self.sample_rate = sample_rate
        self.mode = mode

    def __call__(self, data_dict):
        n = data_dict["coord"].shape[0]
        point_max = int(self.sample_rate * n) if self.sample_rate is not None else self.point_max
        if n > point_max:
            center = data_dict["coord"][np.random.randint(n) if self.mode == "random" else n // 2]
            idx_crop = np.argsort(np.sum(np.square(data_dict["coord"] - center), 1))[:point_max]
            data_dict = index_operator(data_dict, idx_crop)
        return data_dict


def _rgb_to_grayscale(color, num_output_channels=1):
    if color.shape[-1] < 3:
        raise TypeError(f"Input color should have at least 3 channels, found {color.shape[-1]}")
    if num_output_channels not in (1, 3):
        raise ValueError("num_output_channels should be either 1 or 3")
    r, g, b = color[..., 0], color[..., 1], color[..., 2]
    gray = (0.2989 * r + 0.587 * g + 0.114 * b).astype(color.dtype)[..., None]
    if num_output_channels == 3:
        gray = np.broadcast_to(gray, color.shape)
    return gray


def _rgb_to_hsv(rgb):
    """colorsys semantics vectorised (hue in [0, 1), s and v on the raw
    0-255 scale), by the chroma form."""
    x = rgb[..., :3].astype(np.float64)
    v = x.max(axis=-1)
    chroma = v - x.min(axis=-1)
    s = np.divide(chroma, v, out=np.zeros_like(v), where=v > 0)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    safe_c = np.where(chroma > 0, chroma, 1.0)
    sector = np.choose(x.argmax(axis=-1), [(g - b) / safe_c, 2.0 + (b - r) / safe_c, 4.0 + (r - g) / safe_c])
    h = np.where(chroma > 0, (sector / 6.0) % 1.0, 0.0)
    return np.stack([h, s, v], axis=-1)


def _hsv_to_rgb(hsv):
    """The inverse of `_rgb_to_hsv` by the piecewise-linear k formula,
    rounded (not truncated) to uint8."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]

    def channel(n):
        k = (n + h * 6.0) % 6.0
        return v * (1.0 - s * np.clip(np.minimum(k, 4.0 - k), 0.0, 1.0))

    out = np.stack([channel(5.0), channel(3.0), channel(1.0)], axis=-1)
    return np.clip(np.rint(out), 0, 255).astype("uint8")


@TRANSFORMS.register_module()
class RandomColorGrayScale:
    def __init__(self, p):
        self.p = p

    def __call__(self, data_dict):
        if np.random.rand() < self.p:
            data_dict["color"] = _rgb_to_grayscale(data_dict["color"], 3)
        return data_dict


@TRANSFORMS.register_module()
class RandomColorDrop:
    """Scale the colors by `color_augment` (0: drop them) with probability p."""

    def __init__(self, p: float = 0.2, color_augment: float = 0.0):
        self.p = p
        self.color_augment = color_augment

    def __call__(self, data_dict):
        if "color" in data_dict and np.random.rand() < self.p:
            data_dict["color"] = data_dict["color"] * self.color_augment
        return data_dict


@TRANSFORMS.register_module()
class RandomColorJitter:
    """torchvision-style brightness, contrast, saturation and hue jitter in
    a random order, each applied with probability p."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, p=0.95):
        self.brightness = self._check_input(brightness, "brightness")
        self.contrast = self._check_input(contrast, "contrast")
        self.saturation = self._check_input(saturation, "saturation")
        self.hue = self._check_input(hue, "hue", center=0, bound=(-0.5, 0.5), clip_first_on_zero=False)
        self.p = p

    @staticmethod
    def _check_input(value, name, center=1, bound=(0, float("inf")), clip_first_on_zero=True):
        if isinstance(value, numbers.Number):
            if value < 0:
                raise ValueError(f"If {name} is a single number, it must be non negative.")
            value = [center - float(value), center + float(value)]
            if clip_first_on_zero:
                value[0] = max(value[0], 0.0)
        elif isinstance(value, (tuple, list)) and len(value) == 2:
            if not bound[0] <= value[0] <= value[1] <= bound[1]:
                raise ValueError(f"{name} values should be between {bound}")
        else:
            raise TypeError(f"{name} should be a number or a pair")
        if value[0] == value[1] == center:
            value = None
        return value

    @staticmethod
    def blend(color1, color2, ratio):
        return (float(ratio) * color1 + (1.0 - float(ratio)) * color2).clip(0, 255.0).astype(color1.dtype)

    def adjust_brightness(self, color, factor):
        return self.blend(color, np.zeros_like(color), factor)

    def adjust_contrast(self, color, factor):
        return self.blend(color, np.mean(_rgb_to_grayscale(color)), factor)

    def adjust_saturation(self, color, factor):
        return self.blend(color, _rgb_to_grayscale(color, 3), factor)

    def adjust_hue(self, color, factor):
        if not (-0.5 <= factor <= 0.5):
            raise ValueError(f"hue_factor ({factor}) is not in [-0.5, 0.5].")
        hsv = _rgb_to_hsv(color)
        hsv[..., 0] = (hsv[..., 0] + factor) % 1.0
        return _hsv_to_rgb(hsv).astype(color.dtype)

    def __call__(self, data_dict):
        if "color" not in data_dict:
            return data_dict
        fn_idx = np.random.permutation(4)
        b = None if self.brightness is None else np.random.uniform(*self.brightness)
        c = None if self.contrast is None else np.random.uniform(*self.contrast)
        s = None if self.saturation is None else np.random.uniform(*self.saturation)
        h = None if self.hue is None else np.random.uniform(*self.hue)
        for fn_id in fn_idx:
            if fn_id == 0 and b is not None and np.random.rand() < self.p:
                data_dict["color"] = self.adjust_brightness(data_dict["color"], b)
            elif fn_id == 1 and c is not None and np.random.rand() < self.p:
                data_dict["color"] = self.adjust_contrast(data_dict["color"], c)
            elif fn_id == 2 and s is not None and np.random.rand() < self.p:
                data_dict["color"] = self.adjust_saturation(data_dict["color"], s)
            elif fn_id == 3 and h is not None and np.random.rand() < self.p:
                data_dict["color"] = self.adjust_hue(data_dict["color"], h)
        return data_dict


@TRANSFORMS.register_module()
class MultiViewGenerator:
    """Global and local crops of a scene for Sonata's self-distillation: a
    major spherical view around a random point (of the points between
    `center_height_scale`'s heights), the other global views centred on its
    points, and local views centred on major-view points no local view covers
    yet (the cover mask; all cleared once all are covered). A view holds the
    nearest ``uniform(*scale) * min(max_size, N)`` points. The global views
    come from the scene after `global_shared_transform`, the local ones
    from the scene as given; each view then takes its own transform. Out:
    ``global_{key}`` and ``local_{key}`` concatenated over the views, and
    per-view offsets ``global_offset`` and ``local_offset``."""

    def __init__(self, global_view_num=2, global_view_scale=(0.4, 1.0), local_view_num=4,
                 local_view_scale=(0.1, 0.4), global_shared_transform=None, global_transform=None,
                 local_transform=None, max_size=65536, center_height_scale=(0, 1), shared_global_view=False,
                 view_keys=("coord", "origin_coord", "color", "normal")):
        self.global_view_num = global_view_num
        self.global_view_scale = global_view_scale
        self.local_view_num = local_view_num
        self.local_view_scale = local_view_scale
        self.global_shared_transform = Compose(global_shared_transform)
        self.global_transform = Compose(global_transform)
        self.local_transform = Compose(local_transform)
        self.max_size = max_size
        self.center_height_scale = center_height_scale
        self.shared_global_view = shared_global_view
        self.view_keys = view_keys
        assert "coord" in view_keys

    def get_view(self, point, center, scale):
        coord = point["coord"]
        max_size = min(self.max_size, coord.shape[0])
        size = max(1, int(np.random.uniform(*scale) * max_size))
        index = np.argsort(np.sum(np.square(coord - center), axis=-1))[:size]
        view = dict(index=index)
        for key in point.keys():
            if key in self.view_keys:
                view[key] = point[key][index]
        if "index_valid_keys" in point:
            view["index_valid_keys"] = point["index_valid_keys"]
        return view

    def __call__(self, data_dict):
        coord = data_dict["coord"]
        point = self.global_shared_transform(copy.deepcopy(data_dict))
        z_min, z_max = coord[:, 2].min(), coord[:, 2].max()
        z_lo = z_min + (z_max - z_min) * self.center_height_scale[0]
        z_hi = z_min + (z_max - z_min) * self.center_height_scale[1]
        center_mask = (coord[:, 2] >= z_lo) & (coord[:, 2] <= z_hi)
        if not center_mask.any():
            center_mask[:] = True
        major_center = coord[np.random.choice(np.where(center_mask)[0])]
        major_view = self.get_view(point, major_center, self.global_view_scale)
        major_coord = major_view["coord"]
        if not self.shared_global_view:
            global_views = [
                self.get_view(point, major_coord[np.random.randint(major_coord.shape[0])], self.global_view_scale)
                for _ in range(self.global_view_num - 1)
            ]
        else:
            global_views = [{k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in major_view.items()}
                            for _ in range(self.global_view_num - 1)]
        global_views = [major_view] + global_views

        cover_mask = np.zeros_like(major_view["index"], dtype=bool)
        local_views = []
        for _ in range(self.local_view_num):
            if (~cover_mask).sum() == 0:
                cover_mask[:] = False
            center = major_coord[np.random.choice(np.where(~cover_mask)[0])]
            local_view = self.get_view(data_dict, center, self.local_view_scale)
            local_views.append(local_view)
            cover_mask[np.isin(major_view["index"], local_view["index"])] = True

        view_dict = {}
        for prefix, views, transform in (("global", global_views, self.global_transform),
                                         ("local", local_views, self.local_transform)):
            for view in views:
                view.pop("index")
                view = transform(view)
                for key in self.view_keys:
                    view_dict.setdefault(f"{prefix}_{key}", []).append(view[key])
            view_dict[f"{prefix}_offset"] = np.cumsum([d.shape[0] for d in view_dict[f"{prefix}_coord"]])
        for key in view_dict:
            if "offset" not in key:
                view_dict[key] = np.concatenate(view_dict[key], axis=0)
        data_dict.update(view_dict)
        return data_dict


@TRANSFORMS.register_module()
class InstanceParser:
    """Instance ground truth (counterpart of the JAX package's, reference
    `transform.py:1312`): the instance ids of the points whose segment is
    not in `segment_ignore_index` renumbered 0.. in the order of their
    values, the others `instance_ignore_index`; each point's instance
    centroid (``instance_centroid``, f32, the ignore value where it has
    none); and one 8-dof box an instance (``bbox``: center, size, heading
    0, the class with the ignored classes below it removed)."""

    def __init__(self, segment_ignore_index=(-1, 0, 1), instance_ignore_index=-1):
        self.segment_ignore_index = segment_ignore_index
        self.instance_ignore_index = instance_ignore_index

    def __call__(self, data_dict):
        coord = data_dict["coord"]
        segment = data_dict["segment"]
        instance = data_dict["instance"]
        mask = ~np.isin(segment, self.segment_ignore_index)
        instance[~mask] = self.instance_ignore_index
        unique, inverse = np.unique(instance[mask], return_inverse=True)
        instance_num = len(unique)
        instance[mask] = inverse
        centroid = np.ones((coord.shape[0], 3)) * self.instance_ignore_index
        bbox = np.ones((instance_num, 8)) * self.instance_ignore_index
        vacancy = [index for index in self.segment_ignore_index if index >= 0]
        for instance_id in range(instance_num):
            mask_ = instance == instance_id
            coord_ = coord[mask_]
            bbox_min = coord_.min(0)
            bbox_max = coord_.max(0)
            bbox_centroid = coord_.mean(0)
            bbox_center = (bbox_max + bbox_min) / 2
            bbox_size = bbox_max - bbox_min
            bbox_theta = np.zeros(1, dtype=coord_.dtype)
            bbox_class = np.array([segment[mask_][0]], dtype=coord_.dtype)
            bbox_class -= np.greater(bbox_class, vacancy).sum()
            centroid[mask_] = bbox_centroid
            bbox[instance_id] = np.concatenate([bbox_center, bbox_size, bbox_theta, bbox_class])
        data_dict["instance"] = instance
        data_dict["instance_centroid"] = centroid.astype(np.float32)
        data_dict["bbox"] = bbox
        return data_dict
