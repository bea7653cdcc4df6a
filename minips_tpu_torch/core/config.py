"""Config dataclasses — the rebuild of the reference's gflags config system.

The reference configures apps through gflags (``--config_file``, ``--my_id``,
app hyperparameters) plus a plaintext hostfile (SURVEY.md §5.6, §2 "gflags/
glog config+log"). Here each app carries a typed ``Config`` dataclass with an
argparse bridge, so the ``lr_example``-style entrypoints launch with the same
flag surface.

A copy of ``minips_tpu/core/config.py``, which imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class TableConfig:
    """Declares one parameter table — the rebuild of CreateTable(ModelType,
    StorageType) in the reference Engine (SURVEY.md §1 L4).

    ``kind`` selects dense (VectorStorage analog: a sharded array pytree) or
    sparse (MapStorage analog: fixed-slot hashed embedding — TPUs have no
    dynamic dicts, SURVEY.md §2 "KVTable storage").
    """

    name: str = "table0"
    kind: str = "dense"  # "dense" | "sparse"
    # consistency model: "bsp" | "ssp" | "asp" (SURVEY.md §2 consistency rows)
    consistency: str = "bsp"
    staleness: int = 0  # SSP bound s; north-star s <= 4 (BASELINE.json:4)
    # server-side updater applied on push (SURVEY.md §2 "Updaters");
    # adam_bf16 / adam8 store moments in bf16 / blockwise int8 — the
    # optimizer-state HBM levers (tables/updaters.py)
    updater: str = "sgd"  # sgd | adagrad | adam | adamw | adam_bf16 | adam8
    lr: float = 0.1
    # sparse-only: fixed slot capacity + embedding dim + init scale
    num_slots: int = 1 << 16
    dim: int = 8
    init_scale: float = 0.01
    # ASP: sync period in local steps (local-SGD emulation, SURVEY.md §7.1)
    sync_every: int = 8


@dataclass
class TrainConfig:
    """Per-app training loop knobs (mirrors reference app gflags)."""

    batch_size: int = 256
    num_iters: int = 100
    num_workers: int = 4  # logical workers (mesh data-axis size)
    seed: int = 0
    log_every: int = 10
    metrics_path: Optional[str] = None  # JSONL metrics sink (SURVEY.md §5.5)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # 0 = disabled


@dataclass
class Config:
    """Top-level config: table + train + free-form app params."""

    table: TableConfig = field(default_factory=TableConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    app: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw = json.loads(text)
        return cls(
            table=TableConfig(**raw.get("table", {})),
            train=TrainConfig(**raw.get("train", {})),
            app=raw.get("app", {}),
        )


def add_config_flags(parser: argparse.ArgumentParser) -> None:
    """Register the shared flag surface (the gflags analog)."""
    parser.add_argument("--config_file", type=str, default=None,
                        help="JSON config file (reference: --config_file)")
    parser.add_argument("--consistency", type=str, default=None,
                        choices=["bsp", "ssp", "asp"])
    parser.add_argument("--staleness", type=int, default=None)
    parser.add_argument("--updater", type=str, default=None,
                        choices=["sgd", "adagrad", "adam", "adamw",
                                 "adam_bf16", "adam8"])
    # adamw is dense-table-only (lm_example dp/sp); the sparse/sharded
    # tables refuse it loudly at construction
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--num_slots", type=int, default=None,
                        help="sparse table capacity (power of two)")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--num_iters", type=int, default=None)
    parser.add_argument("--num_workers", type=int, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--log_every", type=int, default=None)
    parser.add_argument("--metrics_path", type=str, default=None)
    parser.add_argument("--checkpoint_dir", type=str, default=None)
    parser.add_argument("--checkpoint_every", type=int, default=None)


def config_from_args(args: argparse.Namespace,
                     default: Optional[Config] = None) -> Config:
    """Overlay CLI flags onto a default/app config (+ optional JSON file)."""
    cfg = default or Config()
    if getattr(args, "config_file", None):
        with open(args.config_file) as f:
            cfg = Config.from_json(f.read())
    for name in ("consistency", "staleness", "updater", "lr", "num_slots"):
        val = getattr(args, name, None)
        if val is not None:
            setattr(cfg.table, name, val)
    for name in ("batch_size", "num_iters", "num_workers", "seed",
                 "log_every", "metrics_path", "checkpoint_dir",
                 "checkpoint_every"):
        val = getattr(args, name, None)
        if val is not None:
            setattr(cfg.train, name, val)
    return cfg
