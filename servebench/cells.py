"""Cells, configurations and traffic mixes, each found by name in a file of
its own:

* ``servebench/workloads/<cell>.json``: the configuration and the traffic
  mix it names, the cluster (policy, workers, slots of ``max_len`` tokens
  each), the offered rate, the SLO limits and the correctness limit, all
  fixed numbers;
* ``servebench/configs/<config>.json``: the model's published
  ``config.json`` keys as run, with ``reduced`` and ``assumed``;
* ``servebench/traffic/<mix>.json``: ``traffic.Mix``'s distributions.

A later cell, model or mix is a new file; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from servebench import cost, traffic
from servebench.reference.model import Arch

HERE = Path(__file__).resolve().parent


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

    def _get(self, key, default=None):
        return self.raw.get(key, default)

    @property
    def head_dim(self) -> int:
        return self.raw.get("head_dim", self.raw["hidden_size"]
                            // self.raw["num_attention_heads"])

    @property
    def residual_ff(self) -> int:
        """The dense residual MLP's width beside a MoE layer
        (``parallel_attn_mlp_res``), from its own key: Arctic's
        ``modeling_arctic.py`` builds it ``hidden_size`` wide, not
        ``intermediate_size``."""
        return self.raw["residual_mlp_ffn_dim"] \
            if self._get("parallel_attn_mlp_res") else 0

    def shape(self) -> cost.Shape:
        r = self.raw
        return cost.Shape(
            layers=r["num_hidden_layers"], d_model=r["hidden_size"],
            heads=r["num_attention_heads"], kv_heads=r["num_key_value_heads"],
            head_dim=self.head_dim, d_ff=r["intermediate_size"],
            vocab=r["vocab_size"], experts=self._get("num_local_experts", 0),
            top_k=self._get("num_experts_per_tok", 0),
            dense_residual_ff=self.residual_ff,
            tied=bool(self._get("tie_word_embeddings", False)))

    def arch(self) -> Arch:
        s = self.shape()
        return Arch(layers=s.layers, d_model=s.d_model, heads=s.heads,
                    kv_heads=s.kv_heads, head_dim=s.head_dim, d_ff=s.d_ff,
                    vocab=s.vocab, rope_theta=float(self.raw["rope_theta"]),
                    norm_eps=float(self.raw["rms_norm_eps"]),
                    experts=s.experts, top_k=s.top_k,
                    dense_residual_ff=s.dense_residual_ff)

    @property
    def dtype(self):
        """The weights' and activations' type (``torch_dtype``)."""
        import torch
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            self.raw.get("torch_dtype", "bfloat16")]

    def port_config(self):
        """The port's ``ModelConfig`` of this configuration."""
        from repro_torch.models.layers import ModelConfig
        if self.raw.get("hidden_act", "silu") != "silu":
            raise ValueError(f"{self.name}: the port's gated MLP here is "
                             "SwiGLU (hidden_act silu)")
        s = self.shape()
        return ModelConfig(
            name=self.name, family="moe" if s.experts else "dense",
            num_layers=s.layers, d_model=s.d_model, num_heads=s.heads,
            num_kv_heads=s.kv_heads, head_dim=s.head_dim, d_ff=s.d_ff,
            vocab_size=s.vocab, rope_theta=float(self.raw["rope_theta"]),
            norm_eps=float(self.raw["rms_norm_eps"]),
            tie_embeddings=s.tied, num_experts=s.experts, top_k=s.top_k,
            moe_dense_residual_ff=s.dense_residual_ff,
            dtype=self.dtype)


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
