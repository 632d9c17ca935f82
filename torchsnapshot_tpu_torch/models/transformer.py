"""The repo's llama-style decoder-only transformer as ``nn.Module``s.

Counterpart of ``torchsnapshot_tpu/models/transformer.py`` with the same
configuration defaults and the same numerics: rotary embeddings computed
in f32 and cast back, attention scores scaled in ``cfg.dtype``, the
causal mask filled with float32's minimum, softmax in f32 with the
probabilities cast to ``cfg.dtype``, and the LM head computed in f32.
Attention stays dense (``torch.matmul``), as the JAX model computes it
outside any Pallas kernel.  Weights are held in ``cfg.dtype``.

Training is the JAX module's: ``make_train_state`` builds the model and
``torch.optim.AdamW(lr=3e-4, weight_decay=0.01)`` (optax
``adamw(3e-4, weight_decay=0.01)``), ``loss_fn`` is the mean next-token
NLL and ``train_step`` one update.  ``params_from_jax`` and
``adamw_state_from_jax`` carry a flax parameter tree and its optax AdamW
state into this module's ``state_dict`` layout and a torch AdamW
``state_dict``, so a JAX train state continues here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    d_ff: int = 11008
    max_seq: int = 2048
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny() -> "TransformerConfig":
        return TransformerConfig(
            vocab=256, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=64
        )


def rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of x [b, s, h, hd] at positions [b, s]."""
    hd = x.shape[-1]
    half = hd // 2
    freq = 1.0 / (
        10000 ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    )
    angles = positions[..., None].float() * freq  # [b, s, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-5,
                 device: Any = None) -> None:
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().square().mean(dim=-1, keepdim=True)
        return (x.float() * torch.rsqrt(var + self.eps)).to(x.dtype) * self.scale


def _linear(d_in: int, d_out: int, cfg: TransformerConfig, device: Any) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False, dtype=cfg.dtype, device=device)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: Any = None) -> None:
        super().__init__()
        self.cfg = cfg
        self.wq = _linear(cfg.d_model, cfg.d_model, cfg, device)
        self.wk = _linear(cfg.d_model, cfg.d_model, cfg, device)
        self.wv = _linear(cfg.d_model, cfg.d_model, cfg, device)
        self.wo = _linear(cfg.d_model, cfg.d_model, cfg, device)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """Rotary-embedded q, k and v as [b, s, heads, head_dim]."""
        cfg = self.cfg
        hd = cfg.d_model // cfg.n_heads
        split = lambda t: t.reshape(*x.shape[:2], cfg.n_heads, hd)  # noqa: E731
        q, k, v = split(self.wq(x)), split(self.wk(x)), split(self.wv(x))
        return rope(q, positions), rope(k, positions), v

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        hd = cfg.d_model // cfg.n_heads
        q, k, v = self.qkv(x, positions)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [b, h, s, hd]
        scores = torch.matmul(q, k.transpose(-1, -2)) / torch.tensor(
            hd ** 0.5, dtype=cfg.dtype, device=x.device
        )
        seq = x.shape[1]
        mask = torch.ones((seq, seq), dtype=torch.bool, device=x.device).tril()
        scores = torch.where(
            mask, scores.float(), torch.finfo(torch.float32).min
        )
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(*x.shape[:2], cfg.d_model)
        return self.wo(out)


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: Any = None) -> None:
        super().__init__()
        self.gate = _linear(cfg.d_model, cfg.d_ff, cfg, device)
        self.w1 = _linear(cfg.d_model, cfg.d_ff, cfg, device)
        self.w2 = _linear(cfg.d_ff, cfg.d_model, cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.silu(self.gate(x)) * self.w1(x))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: Any = None) -> None:
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.attn = Attention(cfg, device)
        self.norm2 = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.mlp = MLP(cfg, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), positions)
        return x + self.mlp(self.norm2(x))


class TransformerLM(nn.Module):
    """Layers are attributes ``layer{i}`` so parameter names read
    ``layer0.attn.wq.weight``, mirroring the flax tree's ``layer0/attn/wq``."""

    def __init__(self, cfg: TransformerConfig, device: Any = "cuda") -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab, cfg.d_model, dtype=cfg.dtype, device=device)
        for i in range(cfg.n_layers):
            setattr(self, f"layer{i}", Block(cfg, device))
        self.norm_f = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.lm_head = _linear(cfg.d_model, cfg.vocab, cfg, device)

    def layer(self, i: int) -> Block:
        return getattr(self, f"layer{i}")

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed(tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device).expand(
            tokens.shape
        )
        for i in range(self.cfg.n_layers):
            x = self.layer(i)(x, positions)
        x = self.norm_f(x)
        # the LM head computes in f32, as the flax model's does
        return F.linear(x.float(), self.lm_head.weight.float())


def params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax parameters (nested dict of numpy arrays, with or without the
    top-level ``"params"`` key) → a ``TransformerLM`` state dict of CPU
    tensors: Dense ``kernel`` [in, out] → ``weight`` [out, in],
    ``Embed.embedding`` → ``embed.weight``, ``RMSNorm.scale`` →
    ``scale``, ``layer{i}/attn/wq`` → ``layer{i}.attn.wq``."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Dict[str, Any], prefix: str) -> None:
        for name, value in node.items():
            key = f"{prefix}.{name}" if prefix else name
            if isinstance(value, dict):
                walk(value, key)
                continue
            t = torch.from_numpy(np.array(value))
            if name == "kernel":
                out[f"{prefix}.weight"] = t.T.contiguous()
            elif name == "embedding":
                out[f"{prefix}.weight"] = t
            else:
                out[key] = t

    walk(params, "")
    return out


LEARNING_RATE = 3e-4
WEIGHT_DECAY = 0.01


def _adamw(model: nn.Module) -> torch.optim.AdamW:
    # optax.adamw's other defaults are torch's: betas (0.9, 0.999), eps 1e-8
    return torch.optim.AdamW(
        model.parameters(), lr=LEARNING_RATE, weight_decay=WEIGHT_DECAY
    )


def make_train_state(
    cfg: TransformerConfig, seed: int = 0, device: Any = "cuda"
) -> Tuple[TransformerLM, torch.optim.AdamW]:
    """A model with weights drawn from ``seed`` (the caller's RNG streams
    are left as they were) and its AdamW optimizer."""
    device = torch.device(device)
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        model = TransformerLM(cfg, device=device)
    return model, _adamw(model)


def loss_fn(model: TransformerLM, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood of ``tokens`` [b, s]."""
    logits = model(tokens[:, :-1])
    return F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1)
    )


def train_step(
    model: TransformerLM, opt: torch.optim.Optimizer, tokens: torch.Tensor
) -> torch.Tensor:
    """One training step, in place on ``model`` and ``opt``; returns the
    step's loss (computed before the update)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model, tokens)
    loss.backward()
    opt.step()
    return loss.detach()


def _find_adam_state(node: Any) -> Any:
    """optax's ScaleByAdamState (count, mu, nu) inside an opt_state chain."""
    if all(hasattr(node, a) for a in ("count", "mu", "nu")):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find_adam_state(child)
            if found is not None:
                return found
    return None


def adamw_state_from_jax(opt_state: Any, model: TransformerLM) -> Dict[str, Any]:
    """An optax ``adamw`` state (numpy leaves) → a ``state_dict`` for this
    model's AdamW (``make_train_state``): count → ``step``, mu →
    ``exp_avg``, nu → ``exp_avg_sq``, mapped onto the parameters by name
    as ``params_from_jax`` maps the weights."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the optax state")
    mu, nu = params_from_jax(adam.mu), params_from_jax(adam.nu)
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    state = {
        i: {"step": step.clone(), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
        for i, (name, _) in enumerate(model.named_parameters())
    }
    return {"state": state, "param_groups": _adamw(model).state_dict()["param_groups"]}
