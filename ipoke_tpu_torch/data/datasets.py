"""Disk datasets over the reference's processed layout (the port's copy of
``ipoke_tpu/data/datasets.py``): per-video frame PNGs + FlowNet .flow.npy
files + a meta pickle with aligned per-frame records.

Meta schema (written by the JAX package's ``data/prepare.build_meta`` or the
reference's prepare_dataset.py):
  img_path:   (N,) str   — path of frame i
  flow_paths: (N, L) str — flow files for each lag
  fid:        (N,) int   — frame index within its video
  vid:        (N,) int   — video id
  object_id:  (N,) int
  train:      (N,) bool  — split flag (or dataset-specific split rules)
plus optional keypoints / nn ids for iPER.

Batch contract (as the synthetic dataset's):
  images (T,H,W,3) in [-1,1], poke (H,W,2), flow (H,W,2), sample_ids scalar;
  zero-poke via __getitem__(-1) (still video + zero flow target).

Frames are decoded and resized by ``data/image`` (PIL's PNG pixels and
LANCZOS resample without PIL).  Every draw comes from the dataset's one
``np.random.Generator`` in the JAX package's order; the loader's threads
share it, as they do there.  ``IPOKE_NATIVE=1`` loads flows, and a clip's
frames where every path is a ``.png``, through the native engine
(``data/native``: C++/OpenMP, a bilinear resize where the default path
resamples with LANCZOS), as the JAX package's datasets do; an engine that
does not build raises, it never falls back to numpy.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ipoke_tpu_torch.data import native
from ipoke_tpu_torch.data.augment import AugmentConfig, color_jitter, geometric
from ipoke_tpu_torch.data.image import load_image as _load_image
from ipoke_tpu_torch.data.image import load_images
from ipoke_tpu_torch.data.poke import (
    FlowError,
    PokeConfig,
    flow_foreground_mask,
    grabcut_foreground_mask,
    keypoint_poke,
    simulate_poke,
)


def _native() -> bool:
    """Whether ``IPOKE_NATIVE=1`` selects the native engine; its library is
    built here, so a failed build raises ``native.NativeBuildError`` before
    any load that a ``FlowError`` retry could swallow."""
    if os.environ.get("IPOKE_NATIVE") != "1":
        return False
    native.lib()
    return True


def _bilinear_resize_np(x, size):
    """(H,W,C) float resize, align_corners=True (matches F.interpolate)."""
    h, w = x.shape[:2]
    if (h, w) == size:
        return x
    ys = np.linspace(0, h - 1, size[0])
    xs = np.linspace(0, w - 1, size[1])
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 2)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 2)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    a = x[y0][:, x0]
    b = x[y0][:, x0 + 1]
    c = x[y0 + 1][:, x0]
    d = x[y0 + 1][:, x0 + 1]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx + c * fy * (1 - fx) + d * fy * fx)


@dataclass
class DatasetConfig:
    spatial_size: int = 128
    max_frames: int = 10
    poke: PokeConfig = field(default_factory=PokeConfig)
    scale_poke_to_res: bool = True
    augment: bool = False
    aug: AugmentConfig = field(default_factory=AugmentConfig)
    # None = unset -> the dataset class's default_subsample applies; an
    # explicit 1 is honored (ADVICE r2: 1 used to be indistinguishable from
    # unset and was silently bumped for Plant/Taichi/H36m)
    subsample_step: Optional[int] = None
    valid_lag: int = 0
    split: str = "official"

    def __post_init__(self):
        self.poke.spatial_size = (self.spatial_size, self.spatial_size)


def flow_gap_of(path) -> Optional[int]:
    """Frame gap encoded in a flow filename ``..._{start}_{end}.flow.npy``
    (reference lag selection parses this — flow_dataset.py:102-118).
    Returns None when the name doesn't carry two trailing ints."""
    stem = os.path.basename(str(path)).split(".")[0]
    parts = stem.split("_")
    try:
        return int(parts[-1]) - int(parts[-2])
    except (ValueError, IndexError):
        return None


class FlowVideoDataset:
    """Generic processed-layout dataset (Plants / iPER / Taichi / Human3.6m
    share this structure; per-dataset split rules differ — flow_dataset.py).

    Class attributes mirror the reference's per-dataset
    ``_set_instance_specific_values``:
      filter_flow          poke candidates restricted to a foreground mask
      use_flow_for_weights mask source: flow amplitude (True) vs grabcut
      flow_cutoff          variable-length chunk ceiling (legacy samplers)
      default_subsample    frame subsampling when the config doesn't set it
    """

    filter_flow = False
    use_flow_for_weights = False
    flow_cutoff = 1.0
    flow_width_factor = 5
    min_frames = 5
    default_subsample: Optional[int] = None

    def __init__(self, meta_path, cfg: DatasetConfig, train=True, seed=0,
                 datakeys=("images", "poke", "flow", "sample_ids")):
        self.cfg = cfg
        self.train = train
        self.datakeys = datakeys
        self.rng = np.random.default_rng(seed)
        with open(meta_path, "rb") as f:
            meta = pickle.load(f)
        self.meta = {k: np.asarray(v) for k, v in meta.items()}
        self.root = os.path.dirname(os.path.abspath(meta_path))
        # resolved per-instance (never mutate the caller's shared cfg)
        self.subsample_step = (cfg.subsample_step if cfg.subsample_step is not None
                               else (self.default_subsample or 1))
        self.valid_lag = cfg.valid_lag
        self._select_lag()
        mask = self._split_mask(train)
        n = len(self.meta["img_path"])
        # valid start ids: enough frames left within the same video
        vid = self.meta["vid"]
        need = cfg.max_frames * self.subsample_step
        ok = np.zeros(n, bool)
        for i in np.flatnonzero(mask):
            j = i + need
            ok[i] = j < n and vid[j] == vid[i]
        self.ids = np.flatnonzero(ok & mask)

    # -- per-dataset hooks -------------------------------------------------
    def _split_mask(self, train):
        """Official split: the meta 'train' flag (overridden per dataset)."""
        n = len(self.meta["img_path"])
        split_flag = self.meta.get("train")
        if split_flag is None or self.cfg.split != "official":
            return self._generic_split(train)
        return split_flag.astype(bool) == train

    def _generic_split(self, train, fraction=0.9):
        """'videos' split fallback: leading fraction of video ids trains."""
        vid = self.meta["vid"]
        vids = np.unique(vid)
        cut = max(1, int(len(vids) * fraction)) if len(vids) > 1 else len(vids)
        train_vids = set(vids[:cut].tolist())
        is_train = np.asarray([v in train_vids for v in vid])
        return is_train if train else (~is_train if len(vids) > 1 else is_train)

    def _select_lag(self):
        """Pick the flow lag whose frame gap equals max_frames*subsample_step
        (reference flow_dataset.py:102-118).  No-op when filenames don't
        encode gaps or only one lag exists."""
        fp = self.meta.get("flow_paths")
        if fp is None or fp.ndim < 2 or fp.shape[1] <= 1:
            return
        gaps = [flow_gap_of(p) for p in fp[0]]
        if any(g is None for g in gaps):
            return
        target = self.cfg.max_frames * self.subsample_step
        matches = [i for i, g in enumerate(gaps) if g == target]
        if matches:
            self.valid_lag = matches[0]

    def _foreground_mask(self, flow, frames):
        """Foreground mask over the valid window for filter_flow datasets."""
        if not self.filter_flow:
            return None
        if self.use_flow_for_weights:
            return flow_foreground_mask(flow, self.cfg.poke)
        try:
            return grabcut_foreground_mask(frames[0], self.cfg.poke,
                                           self.flow_width_factor)
        except Exception:
            return flow_foreground_mask(flow, self.cfg.poke)

    def __len__(self):
        return len(self.ids)

    def _abs(self, p):
        p = str(p)
        return p if os.path.isabs(p) else os.path.join(self.root, p)

    def _load_flow(self, idx):
        path = self._abs(self.meta["flow_paths"][idx][self.valid_lag]
                         if self.meta["flow_paths"].ndim > 1 else self.meta["flow_paths"][idx])
        load = native.load_npy_flow if _native() else np.load
        try:
            flow = load(path)
        except Exception as e:
            raise FlowError(str(e))
        if flow.shape[0] == 2:  # CHW -> HWC
            flow = np.transpose(flow, (1, 2, 0))
        if self.cfg.scale_poke_to_res:
            flow = flow / (flow.shape[0] / self.cfg.spatial_size)
        flow = _bilinear_resize_np(flow.astype(np.float32),
                                   (self.cfg.spatial_size, self.cfg.spatial_size))
        return flow

    def _load_frames_single(self, idx):
        return _load_image(self._abs(self.meta["img_path"][idx]),
                           self.cfg.spatial_size).astype(np.float32)

    def _load_frames(self, start):
        step = self.subsample_step
        idxs = [start + i * step for i in range(self.cfg.max_frames)]
        paths = [self._abs(self.meta["img_path"][i]) for i in idxs]
        if _native() and all(p.endswith(".png") for p in paths):
            return native.load_frames([paths], self.cfg.spatial_size)[0]
        return load_images(paths, self.cfg.spatial_size)

    def __getitem__(self, idx, _retries=50):
        zero_poke = idx == -1
        if zero_poke:
            idx = int(self.rng.integers(0, len(self.ids)))
        for attempt in range(_retries):
            try:
                start = int(self.ids[idx % len(self.ids)])
                flow = self._load_flow(start)
                frames = self._load_frames(start)
                fg_mask = self._foreground_mask(flow, frames)
                poke, centers = simulate_poke(flow, self.cfg.poke, self.rng,
                                              zero_poke=zero_poke,
                                              foreground_mask=fg_mask)
                if zero_poke:
                    frames = np.repeat(frames[:1], self.cfg.max_frames, axis=0)
                    flow = np.zeros_like(flow)
                if self.cfg.augment and self.train:
                    frames = color_jitter(frames, self.rng, self.cfg.aug)
                    frames, (flow, poke) = geometric(frames, [flow, poke], self.rng, self.cfg.aug)
                out = {
                    "images": frames.astype(np.float32),
                    "poke": poke.astype(np.float32),
                    "flow": flow.astype(np.float32),
                    "sample_ids": np.asarray(-1 if zero_poke else idx, np.int64),
                }
                if "original_flow" in self.datakeys:
                    out["original_flow"] = self._load_flow(start)
                if "keypoints_rel" in self.datakeys and "keypoints" in self.meta:
                    out["keypoints_rel"] = np.asarray(self.meta["keypoints"][start], np.float32)
                if "keypoint_poke" in self.datakeys and "keypoints" in self.meta:
                    t_end = start + (self.cfg.max_frames - 1) * self.subsample_step
                    kp_poke, kp_centers = keypoint_poke(
                        np.asarray(self.meta["keypoints"][start], np.float32),
                        np.asarray(self.meta["keypoints"][t_end], np.float32),
                        self.cfg.poke, self.rng,
                    )
                    out["keypoint_poke"] = kp_poke
                    out["keypoint_poke_centers"] = kp_centers
                if "keypoints_abs" in self.datakeys and "keypoints" in self.meta:
                    # stored keypoints are pose-net-relative (/64); abs scales
                    # to the input resolution (posenet_wrapper.py:53-57)
                    out["keypoints_abs"] = (
                        np.asarray(self.meta["keypoints"][start], np.float32)
                        * self.cfg.spatial_size
                    )
                if "app_img_random" in self.datakeys or "app_img_cmp" in self.datakeys:
                    # appearance-transfer image: random frame of another video
                    # (reference _get_transfer_img, base_dataset.py:301-325)
                    vid = self.meta["vid"]
                    others = np.flatnonzero(vid != vid[start])
                    j = int(self.rng.choice(others)) if others.size else start
                    app = self._load_frames_single(j)
                    if "app_img_random" in self.datakeys:
                        out["app_img_random"] = app
                    if "app_img_cmp" in self.datakeys:
                        out["app_img_cmp"] = app
                if "img_aT" in self.datakeys:
                    out["img_aT"] = color_jitter(frames[:1], self.rng, self.cfg.aug)[0]
                if "img_sT" in self.datakeys:
                    f, _ = geometric(frames[:1], [], self.rng, self.cfg.aug)
                    out["img_sT"] = f[0]
                if "app_img_dis" in self.datakeys:
                    # disentanglement view: color+geometry augmented sample frame
                    j = int(self.rng.integers(0, self.cfg.max_frames))
                    f = color_jitter(frames[j : j + 1], self.rng, self.cfg.aug)
                    f, _ = geometric(f, [], self.rng, self.cfg.aug)
                    out["app_img_dis"] = f[0]
                if "nn" in self.datakeys and "nn_ids" in self.meta:
                    # same-pose partner from another video (iPER transfer pairs,
                    # reference _get_nn, flow_dataset.py:507-557)
                    nn_start = int(self.meta["nn_ids"][start])
                    nn_flow = self._load_flow(nn_start)
                    nn_poke, _ = simulate_poke(nn_flow, self.cfg.poke, self.rng)
                    out["nn_images"] = self._load_frames(nn_start).astype(np.float32)
                    out["nn_poke"] = nn_poke.astype(np.float32)
                return out
            except FlowError:
                idx = int(self.rng.integers(0, len(self.ids)))
        raise FlowError(f"failed after {_retries} retries")


DATASETS = {}


def register_dataset(name):
    def deco(cls):
        DATASETS[name] = cls
        return cls
    return deco


@register_dataset("PlantDataset")
class PlantDataset(FlowVideoDataset):
    """Poking Plants (reference flow_dataset.py:22-320): subsample 2, lag
    selected from flow-filename frame gaps, flow_cutoff 0.4, no filtering."""

    flow_cutoff = 0.4
    default_subsample = 2


@register_dataset("VegetationDataset")
class VegetationDataset(PlantDataset):
    pass


@register_dataset("TaichiDataset")
class TaichiDataset(VegetationDataset):
    """TaiChi-HD (flow_dataset.py:354-370): filter_flow via grabcut mask,
    flow_cutoff 0.1, subsample 2, meta carries the train flag."""

    filter_flow = True
    flow_cutoff = 0.1
    default_subsample = 2


@register_dataset("IperDataset")
class IperDataset(FlowVideoDataset):
    """iPER (flow_dataset.py:372-557): official split from train.txt video
    names, grabcut-filtered pokes, flow_cutoff 0.6, keypoints + NN pairs."""

    filter_flow = True
    flow_cutoff = 0.6

    def _split_mask(self, train):
        train_txt = os.path.join(self.root, "train.txt")
        if self.cfg.split != "official" or not os.path.exists(train_txt):
            return super()._split_mask(train)
        # official split: video names listed in train.txt, matched as
        # substrings of img_path with '/' -> '_' (flow_dataset.py:427-446)
        with open(train_txt) as f:
            names = [n.replace("/", "_").rstrip() for n in f if n.strip()]
        img_path = np.asarray([str(p) for p in self.meta["img_path"]])
        is_train = np.zeros(len(img_path), bool)
        for n in names:
            is_train |= np.char.find(img_path, n) != -1
        return is_train == train


@register_dataset("Human36mDataset")
class Human36mDataset(FlowVideoDataset):
    """Human3.6m (flow_dataset.py:560-623): actors 9/11 are the test split,
    subsample 2 with valid lag 1 (lag 0 when subsample 1), flow-based masks,
    lanczos resize (the generic loader already uses LANCZOS)."""

    TEST_ACTORS = (9, 11)
    use_flow_for_weights = True
    flow_cutoff = 0.3
    default_subsample = 2

    def _split_mask(self, train):
        if self.cfg.split == "official" and "actor_id" in self.meta:
            is_test = np.isin(self.meta["actor_id"].astype(int), self.TEST_ACTORS)
            return ~is_test if train else is_test
        return super()._split_mask(train)

    def _select_lag(self):
        # flow_dataset.py:115-118: lag 0 for subsample 1, lag 1 for subsample 2
        assert self.subsample_step in (1, 2)
        fp = self.meta.get("flow_paths")
        n_lags = fp.shape[1] if fp is not None and fp.ndim > 1 else 1
        self.valid_lag = min(0 if self.subsample_step == 1 else 1, n_lags - 1)


def get_dataset(name):
    """Name registry mirroring data/__init__.py:46-53 (IperDataset,
    PlantDataset, TaichiDataset, Human36mDataset + synthetic)."""
    if name in DATASETS:
        return DATASETS[name]
    if name == "SyntheticDataset":
        from ipoke_tpu_torch.data.synthetic import SyntheticPokeDataset

        return SyntheticPokeDataset
    raise KeyError(name)
