"""The port's preemption hook (``resilience/preemption.py``) and heartbeats
(``continuous/heartbeat.py``), against the JAX package's.

Both packages' hooks sit in this process, each with its own drains and
previous handler: a notice to one runs its own drains only.  The real
signal path runs in a child process of the port alone, under its own
timeout: SIGTERM with a replication in flight drains it, the peer's HEAD
names the last recorded step, and the child dies by SIGTERM."""

import os
import re
import select
import signal
import subprocess
import sys
import textwrap
import threading
import time

import pytest

import torchsnapshot_tpu.continuous.heartbeat as jhb
import torchsnapshot_tpu.resilience.preemption as jpre
import torchsnapshot_tpu_torch as tts
import torchsnapshot_tpu_torch.continuous.heartbeat as thb
import torchsnapshot_tpu_torch.resilience.preemption as tpre
from torchsnapshot_tpu.coordination import FileCoordinator as JFileCoordinator
from torchsnapshot_tpu_torch import obs
from torchsnapshot_tpu_torch.continuous import ContinuousStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _uninstalled():
    prev = signal.getsignal(signal.SIGTERM)
    yield
    tpre.uninstall()
    jpre.uninstall()
    signal.signal(signal.SIGTERM, prev)


def test_drains_share_one_deadline_and_errors_are_swallowed():
    seen = []

    def ok(deadline):
        seen.append(("ok", deadline))

    def broken(deadline):
        seen.append(("broken", deadline))
        raise RuntimeError("drain bug")

    d0 = obs.counter(obs.CONTINUOUS_PREEMPTION_DRAINS).value
    h1, h2 = tpre.on_preemption(ok), tpre.on_preemption(broken)
    assert not tpre.preemption_requested()
    t0 = time.monotonic()
    assert tpre.notify_preemption(grace_s=5.0) == 1
    assert tpre.preemption_requested()
    assert [k for k, _ in seen] == ["ok", "broken"]
    assert seen[0][1] == seen[1][1] and t0 + 4.9 < seen[0][1] < time.monotonic() + 5.0
    assert obs.counter(obs.CONTINUOUS_PREEMPTION_DRAINS).value == d0 + 1
    tpre.remove_handler(h2)
    seen.clear()
    assert tpre.notify_preemption(grace_s=0.0) == 1 and [k for k, _ in seen] == ["ok"]
    tpre.remove_handler(h1)
    assert tpre.notify_preemption() == 0
    # the knob's window
    with tts.knobs.override_continuous_grace_s(2.5):
        tpre.on_preemption(ok)
        seen.clear()
        t0 = time.monotonic()
        tpre.notify_preemption()
        assert t0 + 2.4 < seen[0][1] < time.monotonic() + 2.5


def test_both_packages_hooks_keep_their_own_drains_and_handlers():
    """The port's registry is its own: each package's notice runs its own
    drains, and each ``uninstall`` restores the handler it replaced."""
    ran = []
    tpre.on_preemption(lambda d: ran.append("port"))
    port_handler = signal.getsignal(signal.SIGTERM)
    assert port_handler is tpre._sigterm_handler
    jpre.on_preemption(lambda d: ran.append("jax"))
    assert signal.getsignal(signal.SIGTERM) is jpre._sigterm_handler
    assert tpre.notify_preemption(grace_s=1.0) == 1 and ran == ["port"]
    assert jpre.notify_preemption(grace_s=1.0) == 1 and ran == ["port", "jax"]
    jpre.uninstall()
    assert signal.getsignal(signal.SIGTERM) is port_handler
    tpre.uninstall()
    assert signal.getsignal(signal.SIGTERM) is not port_handler
    assert not tpre.preemption_requested()


def test_handler_delivers_again_through_the_previous_handler():
    """``_sigterm_handler`` runs the drains, then the handler installed
    before the hook (a callable here; the default disposition kills the
    process, which the child test shows)."""
    calls = []
    signal.signal(signal.SIGTERM, lambda signum, frame: calls.append(("prev", signum)))
    tpre.on_preemption(lambda d: calls.append(("drain", None)))
    tpre._sigterm_handler(signal.SIGTERM, None)
    assert calls == [("drain", None), ("prev", signal.SIGTERM)]
    tpre.uninstall()
    assert signal.getsignal(signal.SIGTERM) not in (tpre._sigterm_handler,)
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    tpre.on_preemption(lambda d: calls.append(("drain2", None)))
    tpre._sigterm_handler(signal.SIGTERM, None)  # SIG_IGN before: nothing more
    assert calls[-1] == ("drain2", None)


def test_registration_off_the_main_thread_still_drains(caplog):
    ran = []
    t = threading.Thread(target=lambda: tpre.on_preemption(lambda d: ran.append(d)))
    t.start()
    t.join(10)
    assert signal.getsignal(signal.SIGTERM) is not tpre._sigterm_handler
    assert "off the main thread" in caplog.text
    assert tpre.notify_preemption(grace_s=1.0) == 1 and len(ran) == 1


def test_heartbeats_use_the_jax_key_layout(tmp_path):
    """Stamps published by either package read back in the other over one
    FileCoordinator directory; malformed stamps read as None; ``clear``
    deletes the key."""
    port = tts.FileCoordinator(str(tmp_path), 0, 2)
    jax = JFileCoordinator(str(tmp_path), 1, 2)
    thb.publish(port, "cc/0", 0, 7)
    jhb.publish(jax, "cc/0", 1, -1)
    assert thb.read_all(port, "cc/0", 2) == jhb.read_all(jax, "cc/0", 2) == {0: 7, 1: -1}
    port.kv_set("cc/0/hb/1", "garbage")
    assert thb.read_all(port, "cc/0", 2) == jhb.read_all(jax, "cc/0", 2) == {0: 7, 1: None}
    thb.clear(port, "cc/0", 0)
    jhb.clear(jax, "cc/0", 1)
    assert thb.read_all(port, "cc/0", 2) == {0: None, 1: None}

    class _DeadKV(tts.LocalCoordinator):
        def kv_set(self, key, value):
            raise ConnectionError("kv down")

    thb.publish(_DeadKV(), "cc/0", 0, 1)  # never raises


_SIGTERM_CHILD = """
import os, sys, time
sys.path.insert(0, {repo!r})
import torch
import torchsnapshot_tpu_torch as tts

cc = tts.ContinuousCheckpointer({local!r}, replica_roots=[{peer!r}], chunk_size_bytes=16384,
                                device="cpu")
state = {{"app": tts.StateDict(w=torch.arange(1 << 15, dtype=torch.float32))}}
for s in range(1, 10_000):
    state["app"]["w"] += 1.0
    cc.step(state, s)
    print(f"TRAINED {{s}}", flush=True)
    time.sleep(0.02)
"""


def test_sigterm_child_drains_the_inflight_step_and_dies_by_sigterm(tmp_path):
    """SIGTERM mid-step (every replicated chunk slowed by 100 ms): the hook
    drains the in-flight replication, so the peer's HEAD holds every step
    the loop recorded, and the process then dies a normal SIGTERM death."""
    peer = str(tmp_path / "peerhost")
    script = tmp_path / "preempt_child.py"
    script.write_text(textwrap.dedent(_SIGTERM_CHILD.format(
        repo=REPO, local=str(tmp_path / "localhost"), peer=peer)))
    env = {
        **os.environ,
        "PYTHONPATH": "",
        "TORCHSNAPSHOT_TPU_TORCH_FAILPOINTS": "continuous.replicate=delay100",
        "TORCHSNAPSHOT_TPU_TORCH_CONTINUOUS_GRACE_S": "20",
    }
    proc = subprocess.Popen([sys.executable, str(script)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    seen = b""
    try:
        deadline = time.monotonic() + 60
        while b"TRAINED 4" not in seen:
            assert time.monotonic() < deadline and proc.poll() is None, seen.decode()
            if select.select([proc.stdout], [], [], 1.0)[0]:
                seen += proc.stdout.read1(65536)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        seen += out
    finally:
        proc.kill()
    assert proc.returncode in (-signal.SIGTERM, 128 + signal.SIGTERM), (
        proc.returncode, seen.decode()[-2000:])
    # the handler's log line may land inside a print's line
    trained = [int(n) for n in re.findall(rb"TRAINED (\d+)", seen)]
    assert "grace window" in seen.decode()
    head = ContinuousStore(os.path.join(peer, "r0")).read_head()
    # >=: the signal may land between step() and the print
    assert head is not None and head["step"] >= trained[-1], (head, trained[-1])
