"""Adapters for torch modules and optimizers.

Counterpart of ``torchsnapshot_tpu/tricks/torch_module.py`` (reference
torchsnapshot/tricks/ddp.py:17-47): a DDP-wrapped module saves keys
prefixed with ``module.``; ``TorchModuleAdapter`` strips the prefix on
save and adds it back on load, so checkpoints interchange between
wrapped and unwrapped models.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

_DDP_PREFIX = "module."


class TorchModuleAdapter:
    def __init__(self, module: Any) -> None:
        self.module = module

    def state_dict(self) -> Dict[str, Any]:
        sd = self.module.state_dict()
        if all(k.startswith(_DDP_PREFIX) for k in sd):
            sd = {k[len(_DDP_PREFIX) :]: v for k, v in sd.items()}
        return sd

    def load_state_dict(self, state_dict: Dict[str, Any], strict: bool = True) -> None:
        own = self.module.state_dict()
        if own and all(k.startswith(_DDP_PREFIX) for k in own):
            state_dict = {k if k.startswith(_DDP_PREFIX) else _DDP_PREFIX + k: v for k, v in state_dict.items()}
        self.module.load_state_dict(state_dict, strict=strict)


class TorchOptimizerAdapter:
    """Routes optimizer state through the optimizer's own (de)hydration.
    An optimizer with no state yet (a fresh process) gives the restore no
    templates, so its tensors come back wherever the read put them; on
    load they move to the device of the optimizer's parameters, ``step``
    counters to the host (the optimizer's own ``load_state_dict`` moves
    those to the parameters' device where its group is capturable or
    fused), as the JAX adapter turns numpy leaves into tensors."""

    def __init__(self, optimizer: Any) -> None:
        self.optimizer = optimizer

    def state_dict(self) -> Dict[str, Any]:
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        device = params[0].device if params else torch.device("cpu")

        def conv(x: Any, key: Any = None) -> Any:
            if isinstance(x, torch.Tensor):
                return x.to("cpu" if key == "step" else device)
            if isinstance(x, dict):
                return {k: conv(v, k) for k, v in x.items()}
            if isinstance(x, list):
                return [conv(v) for v in x]
            if isinstance(x, tuple):
                return tuple(conv(v) for v in x)
            return x

        self.optimizer.load_state_dict(conv(state_dict))
