"""Framework adapters and the original torchsnapshot format ("tricks").

Counterpart of ``torchsnapshot_tpu/tricks/``:

- ``TorchModuleAdapter`` strips and re-adds DDP's ``module.`` prefix;
  ``TorchOptimizerAdapter`` moves a templateless restore's optimizer
  state onto the parameters' device (``torch_module.py``);
- ``read_torchsnapshot`` / ``write_torchsnapshot`` read and write the
  original torchsnapshot library's on-disk format, from and to tensors
  on the card or the host.

Not ported, by design: ``flax_adapters.py`` and ``orbax_interop.py``
adapt flax train states and orbax checkpoints, which have no meaning
for torch state.
"""

from .torch_module import TorchModuleAdapter, TorchOptimizerAdapter  # noqa: F401
from .torchsnapshot_reader import peek_torchsnapshot, read_torchsnapshot  # noqa: F401
from .torchsnapshot_writer import write_torchsnapshot  # noqa: F401
