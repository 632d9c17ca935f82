"""A decoder-only language model's training state: the port's
``TransformerLM`` at the configuration's widths, torch AdamW's moments
(in the parameters' dtype, as the port's ``make_train_state`` keeps
them), the RNG streams and a progress counter.

Configuration keys are those of a Hugging Face ``config.json``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..state import BenchState, leaf_specs


def build(cfg: Dict[str, Any], seed: int, device: Any) -> BenchState:
    import torchsnapshot_tpu_torch as tts
    from torchsnapshot_tpu_torch.models.transformer import TransformerConfig, make_train_state

    tcfg = TransformerConfig(
        vocab=cfg["vocab_size"], d_model=cfg["hidden_size"], n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"], d_ff=cfg["intermediate_size"],
        max_seq=cfg["max_position_embeddings"], dtype=getattr(torch, cfg["torch_dtype"]),
    )
    if cfg["num_key_value_heads"] != cfg["num_attention_heads"] or cfg["tie_word_embeddings"]:
        raise ValueError("the port's TransformerLM has one kv head per head and an untied head")
    model, opt = make_train_state(tcfg, seed=0, device=device)
    named = []
    for name, p in model.named_parameters():
        named.append((f"0/model/{name}", p.data, "normal"))
    for i, p in enumerate(model.parameters()):
        st = {"step": torch.tensor(1.0), "exp_avg": torch.empty_like(p), "exp_avg_sq": torch.empty_like(p)}
        opt.state[p] = st
        named.append((f"0/optim/state/{i}/exp_avg", st["exp_avg"], "normal"))
        named.append((f"0/optim/state/{i}/exp_avg_sq", st["exp_avg_sq"], "nonneg"))
    progress = tts.StateDict(step=-1)
    app_state = {"model": model, "optim": opt, "rng": tts.RNGState(), "progress": progress}
    n_params = len(list(model.parameters()))
    state = BenchState(
        app_state, progress, leaf_specs(named), [t for _, t, _ in named], range(n_params), seed
    )
    state.refill(0)
    return state
