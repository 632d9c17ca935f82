"""Benchmark of torchsnapshot_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the NVIDIA GPU(s) the
cell asks for; it exits non-zero, printing no result, without them.  The
last line of standard output is the result object; the numbers compared
with the plain reference, each beside its limit, are the last lines of
standard error and the result's last key.

Where a run reads and writes:
- the measured windows write snapshots to the port's ``memory://``
  plugin, in this process's memory: nothing goes to disk or /dev/shm;
- the port's kernel and fast-I/O libraries build into the checkout's
  ``build/torch_kernels/`` (only the first run of a checkout builds);
  TRITON_CACHE_DIR and TORCH_EXTENSIONS_DIR are pointed at the
  checkout's ``build/`` too;
- a traced run writes its Chrome trace, some tens of MB, to
  ``build/portbench/<cell>.trace.json``, overwritten by the next;
- the DLRM cells' one-rank process group keeps its FileStore in a fresh
  directory under ``$TMPDIR``, removed at the end;
- no fixed path under /tmp, nothing under ``$HOME``.
"""

import os
import sys
import time

T_PROCESS = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path[:1] = [ROOT]

if __name__ == "__main__":
    from portbench.harness import main

    sys.exit(main(t_process=T_PROCESS))
