"""Model configuration and shared utilities of the architecture zoo.

:class:`ModelConfig` is the reference's configuration record, field for
field, so that a configuration reads the same on both sides and later
slices need no change here.  Models are ``nn.Module`` trees whose
repeated layers sit in ``ModuleList``\\ s; parameters are made from an
explicit ``torch.Generator`` (the reference draws from ``jax.random``
keys, so the two never give the same numbers from one seed: tests carry
the reference's parameters across with :mod:`repro_torch.convert`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint
from torch import nn

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 ⇒ d_model // n_heads

    # --- MoE ----------------------------------------------------------- #
    moe_experts: int = 0
    moe_topk: int = 0
    moe_shared: int = 0            # always-on shared experts (qwen2-moe)
    moe_pad_to: int = 0            # pad expert dim (dummy experts) for EP
    moe_period: int = 1            # every k-th layer is MoE (jamba: 2)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- MLA (minicpm3) ------------------------------------------------- #
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- hybrid (jamba): 1 attention layer per ``attn_period`` ---------- #
    attn_period: int = 0           # 0 ⇒ pure attention stack
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # --- ssm (xlstm): 1 sLSTM block per ``slstm_period`` ---------------- #
    slstm_period: int = 0          # 0 ⇒ no sLSTM blocks
    xlstm_proj_factor: float = 2.0

    # --- enc-dec (whisper) ---------------------------------------------- #
    enc_layers: int = 0
    enc_seq: int = 1500            # encoder frames (stub frontend output)

    # --- vlm (qwen2-vl) -------------------------------------------------- #
    mrope_sections: tuple[int, ...] = ()

    # --- common ---------------------------------------------------------- #
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    use_pallas: bool = False       # the reference's kernel switch; unread
    attn_q_chunk: int = 512        # chunks of the plain attention twin
    attn_kv_chunk: int = 512
    mamba_chunk: int = 64
    xlstm_chunk: int = 64

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ------------------------------------------------------------------ #
    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    def layer_is_moe(self, idx: int) -> bool:
        return self.is_moe and (idx % self.moe_period == self.moe_period - 1)

    def param_count(self) -> int:
        """Exact parameter count, from a model built on the meta device."""
        from .registry import count_params  # lazy, avoids a cycle
        return count_params(self)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------- #
# init helpers
# ---------------------------------------------------------------------- #
def dense_init(gen: torch.Generator | None, shape, dtype,
               scale: float | None = None, device=None) -> nn.Parameter:
    """Truncated-normal fan-in init (±2 standard units, then × std), as a
    frozen parameter (serving; ``train.train_step.trainable`` turns
    gradients on).  ``gen`` is None only on the meta device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    x = torch.empty(shape, dtype=torch.float32, device=device)
    if x.device.type != "meta":
        nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        x.mul_(std)
    return nn.Parameter(x.to(dtype), requires_grad=False)


def const_param(shape, value: float, dtype, device=None) -> nn.Parameter:
    """A frozen parameter filled with ``value`` (norm scales, biases)."""
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device),
                        requires_grad=False)


def _wants_grad(args) -> bool:
    """Whether a gradient can flow from these arguments: a tensor, or a
    module's parameter, that requires grad."""
    return any(
        (isinstance(a, torch.Tensor) and a.requires_grad)
        or (isinstance(a, nn.Module)
            and any(p.requires_grad for p in a.parameters()))
        for a in args)


def remat(cfg: ModelConfig, fn, *args, **kw):
    """``fn(*args, **kw)``, its activations recomputed in the backward
    when ``cfg.remat`` is set, grad mode is on and a gradient can flow
    (serving, whose parameters are frozen, calls ``fn`` as it is): the
    reference's ``jax.checkpoint`` of a whole block (nothing saveable) as
    ``torch.utils.checkpoint``, non-reentrant.  The recomputation takes
    the first run's MoE routes and adds no MoE stats
    (``layers.ffn.recompute_contexts``).  Otherwise a plain call."""
    if not (cfg.remat and torch.is_grad_enabled()
            and _wants_grad((*args, *kw.values()))):
        return fn(*args, **kw)
    from .layers.ffn import recompute_contexts  # lazy: ffn imports common

    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=recompute_contexts, **kw)


def param_bytes(params: nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())


def param_count_tree(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
