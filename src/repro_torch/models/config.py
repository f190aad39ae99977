"""Unified model configuration of the LM zoo, as ``repro.models.config``
has it: one frozen dataclass whose family fields decide the block kind of
every layer (dense / MoE / SSM / hybrid / enc-dec), so one backbone
(``models/transformer.py``) serves every architecture.  ``jdtype``
becomes :attr:`ModelConfig.torch_dtype`.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv: int = 4
    head_dim: int = 0           # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    act: str = "silu"           # ffn activation (rules.act kind) or "relu"
    ffn_gated: bool = True      # SwiGLU-style gate (False: 2-matrix FFN)
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    first_dense: int = 0              # leading dense layers (moonlight)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM (mamba1) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    dt_rank: int = 0                  # 0 -> ceil(d_model / 16)
    ssm_chunk: int = 128              # chunked selective-scan length

    # --- hybrid (hymba) ---
    swa_window: int = 0               # 0 = full attention
    global_layers: Tuple[int, ...] = ()   # full-attn layers when swa_window>0

    # --- encoder-decoder (audio) ---
    enc_layers: int = 0               # >0 => enc-dec; n_layers = decoder depth

    # --- modality stubs ---
    n_patches: int = 0                # vlm: patch embeddings prepended
    frontend: str = "none"            # none | patches | frames

    # --- numerics / memory ---
    dtype: str = "bfloat16"
    remat: str = "full"               # full | dots | none
    attn_chunk: int = 1024            # flash-style KV chunk for long seqs
    attn_chunk_threshold: int = 4096  # chunk attention when S >= this
    residual_policy: str = "int8"     # attribution residuals for smooth gates

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dtr(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def torch_dtype(self) -> torch.dtype:
        """The compute dtype (``repro``'s ``jdtype``)."""
        return _DTYPES[self.dtype]

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a 16-multiple (the head and the table are
        padded; logits are sliced back to ``vocab``)."""
        return -(-self.vocab // 16) * 16

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def block_kind(self, layer: int) -> str:
        if self.family == "ssm":
            return "mamba"
        if self.family == "hybrid":
            return "hybrid"
        if self.n_experts > 0 and layer >= self.first_dense:
            return "moe"
        return "dense"

    def segments(self) -> Tuple[Tuple[str, int], ...]:
        """Contiguous (block_kind, count) runs of layers."""
        return tuple((k, c) for k, c, _ in self.layer_plan())

    def layer_plan(self) -> Tuple[Tuple[str, int, int], ...]:
        """Contiguous (block_kind, count, attn_window) runs; hymba's sparse
        global layers split the stack into runs."""
        runs = []
        for i in range(self.n_layers):
            k = self.block_kind(i)
            w = 0
            if self.swa_window and i not in self.global_layers:
                w = self.swa_window
            if runs and runs[-1][0] == k and runs[-1][2] == w:
                runs[-1][1] += 1
            else:
                runs.append([k, 1, w])
        return tuple((k, c, w) for k, c, w in runs)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, hd = self.d_model, self.hd
        attn = (d * self.n_heads * hd + 2 * d * self.n_kv * hd
                + self.n_heads * hd * d)
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv) * hd
        mats = 3 if self.ffn_gated else 2
        dense_ffn = mats * d * self.d_ff
        moe_ffn = (self.n_experts * mats * d * self.d_ff
                   + self.n_shared_experts * mats * d * self.d_ff
                   + d * self.n_experts)
        di, n, dtr = self.d_inner, self.ssm_state, self.dtr
        mamba = (d * 2 * di + di * self.ssm_conv + di * (dtr + 2 * n)
                 + dtr * di + di + di * n + di + di * d)
        total = 0
        for i in range(self.n_layers):
            kind = self.block_kind(i)
            total += 2 * d  # norms
            if kind == "mamba":
                total += mamba
            elif kind == "hybrid":
                total += attn + mamba + dense_ffn + 2 * d
            elif kind == "moe":
                total += attn + moe_ffn
            else:
                total += attn + dense_ffn
        if self.enc_layers:
            total += self.enc_layers * (2 * attn // 2 + dense_ffn + 2 * d)
            total += self.n_layers * (attn + 2 * d)   # decoder cross-attn
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        mats = 3 if self.ffn_gated else 2
        per_expert = mats * self.d_model * self.d_ff
        n_moe_layers = self.n_layers - self.first_dense
        inactive = n_moe_layers * (self.n_experts - self.top_k) * per_expert
        return full - inactive

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)
