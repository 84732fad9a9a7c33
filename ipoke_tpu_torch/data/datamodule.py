"""Train/val/test loader assembly (the port's copy of
``ipoke_tpu/data/datamodule.py``): the datasets of a config's ``data:``
section and the JAX package's choice of sampler.

``loader("train")`` builds a fresh sampler from ``data.seed`` on every call,
as JAX's does, so every epoch repeats the first one's order: with
``zero_poke`` a ``FixedLengthSampler`` that turns ``n // zero_poke_amount``
indices into -1 (zero-poke examples), else the object-weighted or the plain
permutation.  Validation and test go in index order.  Every loader drops the
last partial batch.
"""
from __future__ import annotations

from ipoke_tpu_torch.data.datasets import DatasetConfig, get_dataset
from ipoke_tpu_torch.data.loader import DataLoader
from ipoke_tpu_torch.data.poke import PokeConfig
from ipoke_tpu_torch.data.samplers import (
    FixedLengthSampler,
    SequentialSampler,
    WeightedRandomSampler,
)


def _spatial_size(data_cfg):
    ss = data_cfg.get("spatial_size", (64, 64))
    return int(ss[0] if isinstance(ss, (tuple, list)) else ss)


def dataset_config_from(data_cfg: dict) -> DatasetConfig:
    return DatasetConfig(
        spatial_size=_spatial_size(data_cfg),
        max_frames=int(data_cfg.get("max_frames", 10)),
        poke=PokeConfig(
            poke_size=int(data_cfg.get("poke_size", 5)),
            n_pokes=int(data_cfg.get("n_pokes", 5)),
            fix_n_pokes=bool(data_cfg.get("fix_n_pokes", False)),
        ),
        scale_poke_to_res=bool(data_cfg.get("scale_poke_to_res", True)),
        augment=bool(data_cfg.get("augment", False)),
        split=data_cfg.get("split", "official"),
    )


class StaticDataModule:
    def __init__(self, data_cfg: dict, datakeys=("images", "poke", "flow", "sample_ids")):
        self.cfg = data_cfg
        self.datakeys = datakeys
        self.ds_cls = get_dataset(data_cfg.get("dataset", "SyntheticDataset"))
        self.batch_size = int(data_cfg.get("batch_size", 8))
        self.zero_poke = bool(data_cfg.get("zero_poke", False))
        self.zero_poke_amount = int(data_cfg.get("zero_poke_amount", 12))
        self.seed = int(data_cfg.get("seed", 0))
        self.datasets = {}

    def _make(self, split):
        from ipoke_tpu_torch.data.synthetic import SyntheticConfig, SyntheticPokeDataset

        train = split == "train"
        if self.ds_cls is SyntheticPokeDataset:
            cfg = SyntheticConfig(
                spatial_size=_spatial_size(self.cfg),
                max_frames=int(self.cfg.get("max_frames", 10)),
                n_examples=int(self.cfg.get("n_examples", 64)),
                poke=PokeConfig(
                    poke_size=int(self.cfg.get("poke_size", 5)),
                    n_pokes=int(self.cfg.get("n_pokes", 5)),
                ),
            )
            return SyntheticPokeDataset(cfg, seed=self.seed + (0 if train else 1))
        return self.ds_cls(
            self.cfg["meta_path"], dataset_config_from(self.cfg), train=train,
            seed=self.seed, datakeys=self.datakeys,
        )

    def setup(self):
        for split in ("train", "val", "test"):
            self.datasets[split] = self._make(split)

    def loader(self, split):
        if not self.datasets:
            self.setup()
        ds = self.datasets[split]
        n = len(ds)
        if split == "train":
            if self.zero_poke:
                sampler = FixedLengthSampler(n, True, self.zero_poke_amount, seed=self.seed)
            elif self.cfg.get("obj_weighting") and hasattr(ds, "meta") and "weights" in ds.meta:
                sampler = WeightedRandomSampler(ds.meta["weights"], n, seed=self.seed)
            else:
                sampler = FixedLengthSampler(n, False, seed=self.seed)
        else:
            sampler = SequentialSampler(n)
        return DataLoader(ds, sampler, self.batch_size, drop_last=True,
                          num_threads=int(self.cfg.get("n_workers", 4)))
