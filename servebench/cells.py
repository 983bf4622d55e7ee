"""Cells, configurations and traffic mixes, each found by name in a file of
its own:

* ``servebench/workloads/<cell>.json``: the configuration and the traffic
  mix it names, the cluster (policy, workers, slots of ``max_len`` tokens
  each), the offered rate, the SLO limits and the correctness limit, all
  fixed numbers;
* ``servebench/configs/<config>.json``: the model's published
  ``config.json`` keys as run, with ``reduced`` and ``assumed``, and under
  ``arch`` the name of its architecture (``servebench/archs``; ``llama``
  where it gives none);
* ``servebench/traffic/<mix>.json``: ``traffic.Mix``'s distributions.

A later cell, model, architecture or mix is a new file; nothing here
names one but the default architecture.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from servebench import archs, traffic

HERE = Path(__file__).resolve().parent
DEFAULT_ARCH = "llama"


def _json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


@dataclasses.dataclass(frozen=True)
class Config:
    raw: dict

    @classmethod
    def load(cls, name: str) -> "Config":
        return cls(_json("configs", name))

    @property
    def name(self) -> str:
        return self.raw["name"]

    @property
    def arch(self):
        """The architecture's harness module (``servebench/archs``), by the
        name under ``arch``."""
        return archs.harness(self.raw.get("arch", DEFAULT_ARCH))

    @property
    def reference(self):
        """The architecture's plain reference (``servebench/reference``)."""
        return archs.reference(self.raw.get("arch", DEFAULT_ARCH))

    def shape(self):
        return self.arch.shape(self.raw)

    def layout(self) -> dict:
        """The weights' tree, in the configuration's type."""
        return self.arch.layout(self.shape(), self.dtype)

    @property
    def dtype(self):
        """The weights' and activations' type (``torch_dtype``)."""
        import torch
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            self.raw.get("torch_dtype", "bfloat16")]

    def port_config(self):
        """The port's ``ModelConfig`` of this configuration."""
        return self.arch.port_config(self.raw, self.dtype)


@dataclasses.dataclass(frozen=True)
class Cell:
    raw: dict
    config: Config
    mix: traffic.Mix

    @classmethod
    def load(cls, name: str) -> "Cell":
        raw = _json("workloads", name)
        if raw["name"] != name:
            raise ValueError(f"{name}.json names itself {raw['name']!r}")
        return cls(raw, Config.load(raw["config"]),
                   traffic.Mix.load(raw["traffic"]))

    def __getattr__(self, key):
        try:
            return self.raw[key]
        except KeyError:
            raise AttributeError(key) from None

    def ttft_limit(self, prompt: int) -> float:
        s = self.raw["slo"]
        return s["ttft_a_s"] + s["ttft_b_s_per_token"] * prompt

    @property
    def tpot_limit(self) -> float:
        return self.raw["slo"]["tpot_s"]
