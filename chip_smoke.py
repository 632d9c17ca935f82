#!/usr/bin/env python3
"""Drive the PyTorch port end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (the kernels are built from ``csrc/`` on
first use), ``g++`` (the native fast-I/O library is built from
``_csrc/fastio.cpp`` on first use; the script fails when it does not
build), a writable temporary directory (the snapshot is written
under ``$TMPDIR``) and the checkout's ``tests/cloud_fakes.py`` and
``tests/s3_service_model.py`` (the object-store fakes of path j; no
client library and no network).  It exits non-zero, printing no result, when there
is no card or anything below fails.  In order:

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the CUDA kernels (K1 slab pack, K2 slab unpack, K3 flash-
   attention forward, K4/K5 flash-attention backward dq and dk/dv), one
   nvcc each, in parallel, prints what ptxas reports for them, and
   fails on a spill or a serialised ``wgmma`` (C75xx);
3. kernel phase: holds each kernel against its plain PyTorch version on
   the card at the main path's shapes and times both, plus one PyTorch
   library call computing the same function where there is one.
   Tolerances: K1 and K2 bitwise; K3 m atol 1e-3 and pv/l normalised
   within 2e-2 (bf16 operands, another summation order); K4/K5 dq, dk,
   dv within 2e-2 of the largest plain value (ds and gpv enter the
   tensor cores in bf16) and the argmax exactly on rows whose top two
   scores are apart by more than the summation order can move them (the
   ``kernels`` line carries each kernel's own outputs' absolute error;
   K3's record adds its normalised pv error), K3-K5 at s = 2048, on
   ragged and q_offset cases (K4/K5 also s = 2047) and on the three
   blocks a causal ring of two ranks of 2048 positions computes at a
   nonzero key offset (``RING_OFFSET_CASES``: wholly masked, where every
   output must be 0 and every argmax -1; the diagonal at offset 2048;
   unmasked), each timed against its own bound (``offset_cases`` in the
   kernel's record), with a second call bitwise equal to the first.  K1
   packs the take's first device slab and the same members each
   followed by a 4-byte f32 scalar (the step a fused AdamW keeps on the
   card), which puts them off 16-byte alignment; K2 unpacks both slabs.  K6 casts 32 MiB bf16 tiles of the
   embedding into an f32 template at offset 0 and as the last, ragged
   tile, bitwise.  Every kernel, its plain version and the library
   yardstick (``torch.cat`` for K1, ``torch._foreach_copy_`` from the
   slab's views for K2, SDPA forward for K3, SDPA backward
   for K4 + K5, ``copy_`` into the template's range for K6) are timed 5
   times: median, range, share of the bound, TFLOP/s for K3-K5; K1 both
   as ``pack_slab`` is called and as its launch alone;
4. seventeen paths, each with the launch counters set to 0 just before it
   and read just after (a path that starts processes adds the launches
   they report), all with the fast-I/O engine at its defaults unless
   the path says otherwise.  The processes of n start during l and
   wait, having reached the card, until their path releases them (each
   takes 8-10 s to reach it):
   a. serving, at full width: the repo's transformer (TransformerConfig
      defaults, depth cut to 2 layers, bf16, ~0.67 B parameters) takes
      one AdamW step, is snapshotted with ``Snapshot.take``, restored
      into a differently seeded model and optimizer, and checked
      bitwise (every tensor, the logits on a fixed batch, the step
      counter, ``read_object``); then ring attention (ring size 1, so
      K3) on q/k/v projected from the restored layer-0 weights at
      s = 2048 against dense attention computed in f32 (tolerance 2e-2);
   a2. fastio (after a, on a's state): take and restore under FASTIO=0
      (the fs plugin's pure-Python legs), FASTIO=1 (the native engine,
      digests fused into its writes) and FASTIO=1 + FASTIO_DIRECT=1
      (O_DIRECT where the work directory takes it), once each (twice
      each, alternating, before the cloud_interop path came), the
      restores under MMAP=0 (a mapped read never
      reaches the engine), each snapshot deleted after use: every restore
      bitwise, every manifest's digests equal; it prints the library,
      whether O_DIRECT is active, each setting's seconds and
      its seven ``storage.fastio`` counters.  After c it also prints
      the host digest rates: zlib against the native one-pass digest
      over the same 256 MiB, which must agree;
   a3. trace (after a2, on a's state), with span tracing on: a sync
      take, an ``async_take`` and its ``wait()``, a restore into a
      zeroed model and optimizer (K2), and a budgeted ``read_object`` of
      the embedding into an f32 template (K6).  Each prints its wall
      seconds, its critical path (the operation's span partitioned by
      which pipeline spans run; the parts add up to the span), the phase
      rollup of its flight record, its span count, its 10 longest spans
      and its Perfetto JSON under ``build/traces/``; the async take its
      goodput (time to unblock, durability lag).  Each take's
      ``.snapshot_obsrecord`` must read back with ``bytes_written`` equal
      to the take's own counter delta.  Then the tracer's cost: sync
      takes under TRACE=0 and TRACE=1, ``TRACE_COST_REPEATS`` each in
      alternating order, medians and ranges;
   a4. stripe_codec (after a3, on a's state): the stripe engine and the
      codec layer.  Striping is on at its defaults on every path (objects
      of 128 MiB or more move as concurrent 64 MiB parts); here a sync
      take and a restore must count one striped write and one striped
      read per object the manifest holds at that size, restored bitwise,
      then a take and a restore at the default and one at
      STRIPE_MIN_OBJECT_SIZE_BYTES=0 (2 each, alternating, before the
      cloud_interop path came); these
      restores run under MMAP=0, since a mapped read is never striped.
      CODEC=huff on the whole state plus f32 copies of one layer's
      moments: parts must be encoded (no quiet degrade to raw); stored/raw
      per dtype from the codec tables, encode and decode GB/s a thread
      from the ``storage.codec.*_latency_s.huff`` histograms; the restore
      bitwise with K2 on the decoded slabs; the embedding encoded in
      40 MiB frames read into an f32 template under the 32 MiB budget
      (K6, tiles straddling frames), equal to the cast on the card.
      CODEC=zlib on the embedding and LM head, an incremental take over
      it linking both (``bytes_deduped`` 524,288,000) and carrying their
      frame tables, deep ``verify``, and a copy with one byte flipped
      inside a frame that deep ``verify`` must fail.  Then a single
      transient failure at the ``storage.fs.part.write`` failpoint (the
      take commits after exactly one retry, each part written once) and a
      permanent one (the take raises, leaving no ``.snapshot_metadata`` and
      no temp file; the breakers are reset after);
   b. ring-attention gradient: ``torch.autograd.grad`` of the bf16 ring
      output on those q/k/v (K3 forward, K4/K5 backward) against f32
      dense attention's autograd gradient (tolerance 3e-2 of the largest
      gradient);
   c. resumable training at full width, s = 2048, on a batch sized from
      the measured step peak (plus a ballast tensor) so that the step
      fills the card up to where half of the state's device copies fit
      beside the next one: ``train_step``, a host clone of the state,
      ``Snapshot.async_take`` (device copies within its budget, blocking
      pinned copies past it), the next ``train_step`` at once (it
      changes the state in place while the snapshot drains), ``wait()``,
      restore into a differently seeded model and optimizer: every
      tensor bitwise equal to the clone, and the step after the restore
      gives the same loss bitwise.  Before that restore, with extra
      ballast pushing the device-copy budget below half the smallest
      object at the stripe threshold, 2 more ``async_take``s of the
      state (default stripes and STRIPE_MIN_OBJECT_SIZE_BYTES=0; 4,
      alternating, before the continuous path came): the large leaves take blocking pinned copies and
      part-stream from them at the default (``storage.stripe.
      streamed_writes`` > 0), each snapshot's digests equal a sync
      take's; unblock and durability lag per setting;
   d. budgeted reads (after b, out of a's snapshot, at full width):
      ``read_object`` of the embedding and the LM head, and of the
      embedding chunked into 64 MiB chunks, with a 32 MiB budget into
      bf16 CUDA templates (copies only), f32 CUDA templates (K6), no
      template (a fresh CUDA tensor) and CPU templates, each bitwise;
      again under VERIFY_ON_RESTORE=1, and a corrupted copy that must
      raise while its template stays usable.  Each read prints its
      tiles, seconds, pinned tile high-water mark (at most the budget
      and one tile) and the rise in allocated device memory;
   e. many ranks (after c, the parent holding no state): two processes
      on the card over a TCPStore on localhost (gloo initialized for the
      store only), each with the full-width model cut to 1 layer (its
      world-2 take and restore repeat k's at 2) and AdamW state marked
      ``Replicated`` plus state of its own: a sync take at world 2 (each
      rank writes 40-60% of the replicated bytes), restore at world 2,
      ``async_take`` with its commit barrier, and a take in which rank
      1's storage fails (both raise within 10 s, rank 0 a
      ``SnapshotAbortedError``, no metadata); then a restore at world 1
      in this process, bitwise, and the sync take's flight record must
      report ranks [0, 1] and the ranks' summed bytes_written;
   f. sharded (after e): the same full-width state as DTensors laid out
      by ``parallel/mesh.py``'s rules (embedding, LM head, wq/wk/wv/w1/
      gate split over dim 1, wo/w2 over dim 0, norms replicated, each
      AdamW moment as its parameter), stored boxes split at 64 MiB.  In
      this process, on a 1-rank CUDA mesh of (1, 1) named ("dp", "tp")
      over gloo: sync take, ``async_take`` and ``wait()``, restores into
      bf16 DTensors, f32 DTensors (K6) and plain CUDA tensors, and a
      budgeted ``read_object`` of the embedding, each bitwise.  Then two
      processes on the card over gloo, DTensors on a 1-D "tp" CUDA mesh
      of 2 (on the CPU if such a mesh cannot be built; the result line
      says which): a take at world 2 (each rank writes 40-60% of the
      bytes) and a restore at world 2 into the transposed layout; then,
      in this process, the restore at world 1 of that snapshot onto the
      (1, 1) mesh and into plain tensors, bitwise.  No box may miss the
      device path (``read.tile_misses.*``);
   g. lifecycle (after f): the full-width model as a fine-tune (the
      embedding and LM head frozen, outside AdamW; the layers train)
      under ``SnapshotManager(keep_last_n=2)``: ``save(step=0)``, a
      step, ``save(step=1, incremental=True, async_=True)`` and
      ``wait()``, a step, ``save(step=2, incremental=True)``.  Steps 1
      and 2 must hold the frozen tensors as hardlinks of their base's
      files, counted in ``bytes_deduped``; retention must delete step 0,
      ``.snapshot_metadata`` first, and step 1 must still restore
      bitwise.  Then ``restore_latest`` into a zeroed model and
      optimizer (bitwise, K2, the next loss bitwise); a warm start with
      ``restore(paths=["model/**"])`` (the optimizer keeps its fresh
      state); the model restored with ``priority`` and without,
      ``LIFECYCLE_REPEATS`` runs
      each alternating, traced: when the first class's consumes ended
      against the whole restore; f32 moments (a mixed-precision
      master's) taken through a ``leaf_transform`` to bf16 and restored
      into f32 templates whole and through a 32 MiB-budget
      ``read_object`` (K6), equal to the bf16-rounded values; and
      ``materialize`` on the card and the host, ``get_manifest``,
      ``verify(deep=True)``, a copy with one flipped byte reported
      ``corrupt``, and ``python -m torchsnapshot_tpu_torch verify
      --deep`` exiting 0 on the step and 1 on the copy;
   h. cas_mmap (after g): the same fine-tune under
      ``SnapshotManager(cas=True, keep_last_n=2)``: step 0 sync (the
      chunks written plus shared equal the bytes taken), a training
      step, step 1 incremental async and traced with the device-copy
      budget pushed below half the embedding, so the frozen embedding and
      LM head take blocking pinned copies and stream chunk by chunk
      (``cas/stream_write`` spans; at least their 524,288,000 bytes
      shared), step 2 sync, each save's seconds beside g's hardlinked
      ones; ``restore_latest`` into a zeroed state (K2 on slabs assembled
      from the pool, bitwise, the next loss bitwise) and a 32 MiB-budget
      ``read_object`` of the embedding into an f32 template (K6, tiles
      straddling chunks); retention deleting step 0 metadata first and
      releasing its refs, ``cas_gc(grace_s=0)`` sweeping exactly the
      chunks no committed step references, deep ``verify`` of steps 1 and
      2, ``fsck()`` rebuilding a deleted ``index.json`` with the same live
      keys, ``python -m torchsnapshot_tpu_torch cas <pool> --json``.  Then
      mapped against copying reads on a's state: where the work
      directory lives and how fast a mapped file reads there,
      ``MMAP_REPEATS`` restores under MMAP=1 and as many under MMAP=0,
      alternating, each bitwise into a
      zeroed state (``storage.mmap.reads`` equal to the restore's reads
      under MMAP=1, 0 under MMAP=0); ``materialize(device="cpu")``
      returning tensors over the mappings (a written one leaves its file
      unchanged) and ``materialize(device="cuda")`` bitwise; and the CLI's
      ``stats --json``, ``doctor`` and ``trace`` (on the card, Perfetto
      under ``build/traces/``) on the CAS step;
   i. tier_cache (after h): tiered storage and the shared-host object
      cache on a's state (4,001,488,980 bytes) under
      ``SnapshotManager(durable, tier=TierConfig(fast_root,
      fast_keep_last_n=2))``.  The fast root, and later the cache
      directory, go to ``/dev/shm`` when it has room (three copies of the
      state for the fast root, one for the cache), else under the work
      directory; the line says which filesystem each is on.  Step 0
      under ``write_through`` (both tiers committed on return); step 1 a
      sync ``write_back`` take (the seconds to return at the fast commit,
      to the durable marker after ``drain_promotions``,
      ``tier.promotion_lag_s``, and ``tier.bytes_promoted`` equal to the
      step's payload bytes); step 2 an ``async_take`` under write-back
      (unblock, fast and durable commit).  Fast retention must evict step
      0's fast copy only, and only with its durable marker present.
      Restores into a zeroed state, bitwise with K2: fast-first (every
      read a fast hit), after one byte flipped in a fast payload
      (``tier.fast_corrupt`` and ``tier.fast_repairs`` 1, the repaired
      file matching its digest) and after step 2's fast copy was wiped
      (served by the durable tier, every object repaired); the embedding
      into an f32 template under 32 MiB through the tier (K6); ``python
      -m torchsnapshot_tpu_torch tiers`` reporting each step's residency.
      Then two processes restore the durable step 1 onto the card at
      once through one cache directory (``--tier-cache-child``), each
      bitwise; summed over them ``storage.cache.misses`` must equal the
      step's object count, and a third restore in this process must be
      all hits, every read mapped;
   j. cloud_interop (after i): object stores and the original
      torchsnapshot format on a state like a's (its own seed), over
      in-process fakes of the ``boto3`` S3 client and of
      ``google.cloud.storage`` (``tests/cloud_fakes.py``; the S3 one
      checks every call and response against ``tests/s3_service_model.py``);
      every line says that no network is measured.  ``s3://``: a take
      (one multipart upload per object at the stripe threshold, none left
      in progress), a restore into a zeroed state (K2, bitwise), the
      embedding into an f32 template under the 32 MiB budget (K6, no GET
      above the budget), an incremental ``base=`` take after the
      embedding changed (every unchanged object copied server-side with
      ``copy_object``) restored bitwise.  ``gs://``: a take
      with the 100 MB chunk (one ``compose`` per object over the chunk or
      striped, no part blob left) and a restore over ranged GETs (K2,
      bitwise).  Then ``write_torchsnapshot`` of the state from the card
      into the work directory; ``python -m torchsnapshot_tpu_torch
      convert`` in a process each way, the two started together (``--to-reference`` reads a
      native snapshot of the same tree taken here): the native result
      restored into a zeroed state (K2, bitwise), the ``--to-reference``
      result read back bitwise.  It
      prints MemAvailable before and after, each step's seconds and GB/s,
      the fakes' calls and the K1/K2/K6 launches;
   k. fleet (after j): two processes on the card (``--fleet-child``; gloo
      over a TCPStore on localhost), ``TOPOLOGY`` "0,0" (one slice, each
      rank its own host, also named by ``TOPOLOGY_HOST_ID``), no host
      cache, each with a's full-width state marked ``Replicated`` plus 4
      MiB of bf16 of its own.  A take at world 2 (each rank elected for
      40-60% of the replicated bytes, slice → host → rank; K1), a
      fan-out restore at world 2 into differently seeded state, bitwise:
      summed over the ranks, ``topology.fanout_durable_reads`` and
      ``durable_gets_saved`` equal the shared objects, the engine is
      ``collective`` (gloo broadcasts of CUDA tensors) and
      ``transport.collective_bytes`` twice the shared bytes (the source's
      broadcast and the sibling's receipt), no fallback; then a take in which rank 1 dies (``os._exit``) where
      it would publish its commit payload, under ``LIVENESS_TIMEOUT_S`` 2
      and ``LIVENESS_INTERVAL_S`` 0.2: rank 0 commits degraded within
      30 s, ``takeover.objects``/``bytes`` equal to rank 1's elected
      share, ``metadata.degraded`` naming rank 1's private leaf alone.
      Then in this process: the degraded snapshot restored at world 1
      (bitwise for the replicated state, K2), rank 1's view refused with
      ``DegradedSnapshotError``, ``verify`` degraded and not missing, a
      continuous mirror of rank 1 written through ``continuous/store.py``,
      ``repair_degraded``, ``verify`` complete, the healed leaf read back
      and read again into an f32 template under a 1 MiB budget (K6).
   l. continuous (after k; no kernel: the leaves reach the host through
      ``encode_leaf``'s copies): the lifecycle fine-tune under one
      ``ContinuousCheckpointer``, the local store under ``/dev/shm`` when
      it has room (else the work directory and ``retain_steps=1``), a
      standby host root and a durable root on the work directory,
      promotion every 3 steps, ``TRANSPORT=collective`` (local mode: each
      chunk bound for the standby takes ``device_move``'s round trip
      through the card).  Three steps (four, promoted every 2, before the
      publish path came), each printing its blocked seconds
      (and the share in ``encode_leaf``'s copies to the host), its
      replication lag, the training step's seconds beside the previous
      replication, chunks and bytes replicated and skipped, and the
      device moves with their GB/s; ``notify_preemption()`` with step 3's
      replication in flight must leave the standby's HEAD at step 3.
      Checks: from step 2 on at least the frozen 524,288,000 bytes
      skipped a step, no replication error, device moves equal to the
      chunks replicated and no transport fallback, the last promoted step
      1.  Then ``restore_latest`` into a fresh model and optimizer on the
      card (source ``local``, step 3, every tensor equal to step 3's
      clone, the next loss bitwise) with ``python -m
      torchsnapshot_tpu_torch stats <host root> --json`` in a process
      beside it (exit 0, head step 3), and, with the local and standby
      roots deleted, again (source ``durable``, step 1, bitwise).
   m. publish (after l): live-weight publication at full width.  The
      trainer (this process) starts a serving child first
      (``--publish-child``: a differently seeded ``TransformerLM`` on the
      card under ``Subscriber(..., strict=False).follow()``, a request
      thread answering requests under ``live.pinned()``: the logits on a
      fixed batch and ring attention, ring size 1 so K3, on layer-0
      q/k/v), then publishes the lifecycle fine-tune's model to a root on
      the work directory over a ``FileCoordinator`` both share:
      ``publish_state`` cold (step 1) and after two AdamW steps (2, 3), a
      ``SnapshotManager(publisher=)`` save of model and optimizer (step 4,
      K1; the child skips the optimizer's leaves), and two
      ``ContinuousCheckpointer(publisher=, promote_every_n=1)`` steps (5,
      6; host and standby stores under ``/dev/shm`` when it has room, the
      durable mirror on the work directory).  After each publication the
      trainer posts the crc32 of every tensor over the KV and waits for
      the child's verdict, made on its follow thread right after the
      swap, where it also records that generation's request digest.
      Checks: every tensor bitwise the trainer's at every step; every
      request's digest its generation's (no torn request); from each
      state or continuous delta on, the frozen leaves' 32 chunks reused
      and not fetched, a state delta fetching at most the changed bytes
      plus one chunk a leaf; ``publish.fallback_polls``,
      ``publish.watch_errors``, ``publish.announce_failures`` and the
      exceptions swallowed at publication sites all 0; ``python -m
      torchsnapshot_tpu_torch stats <root>`` (in a process, beside the
      child's end) naming the subscriber at step 6.  It prints each
      publication's seconds (``publish_state``'s by phase), its
      ``bytes_delta``, the subscriber's fetch and apply seconds, the
      staging basis's device-to-host copies, the lag from the record's
      ``t`` to the swap, the requests served while swaps were in flight
      and the longest wait for ``pinned()``.
   n. workloads (after m): two processes on the card
      (``--workloads-child``; gloo over a TCPStore on localhost, a group
      timeout of ``WORKLOADS_GROUP_TIMEOUT_S``), started beside l.  (1)
      DLRM at full width (``DLRMConfig()``, f32, Adagrad): 8 tables of
      65,536 x 128 ``Shard(0)`` over an "ep" mesh of 2, the MLPs
      ``Replicate()``; three ``train_step``s on batches of 4096 (ids
      uniform over each table's rows), a ``Snapshot.take`` of model and
      optimizer at world 2 (K1); here, a restore at world 1 into a
      differently seeded model (every table row range and accumulator
      bitwise the ranks' shards by crc32, the next loss on a fixed batch
      within rtol 1e-5 of the ranks').  (2) The GPipe pipeline at
      d_model 4096, two stages one a rank, batch 4096 in 4 microbatches,
      f32: ``pipeline_forward`` within 1e-4 of the largest output of
      ``sequential_forward``, one step's gradients within 1e-4 of the
      largest of sequential autograd's, three ``pipeline_train_step``s
      lowering the loss, the "pp"-sharded weights taken at world 2 and
      restored replicated here (each stage and ``sequential_forward``'s
      output bitwise the ranks').  (3) Ring attention at ring size 2:
      b 1, 2048 positions a rank, 32 heads, d 128, bf16, causal (K3 at
      each step, K4/K5 in the gradient): each rank's output within 2e-2
      of f32 dense attention over the 4096 positions and the gradients
      of q, k and v within 3e-2 of the largest dense gradient, the dense
      reference computed once, here.  It prints each part's seconds,
      bytes taken and restored, and launches.

Every kernel must have launched on these paths, and each path on the
kernels it runs.  The line before the last is the card; the line before
it the ``kernels`` JSON; the last line ``{"ok": true, "device": ...}``.
"""

import fnmatch
import gc
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import torch

import torchsnapshot_tpu_torch as tts
from torchsnapshot_tpu_torch.batcher import BatchedBufferStager, batch_write_requests
from torchsnapshot_tpu_torch.flatten import flatten
from torchsnapshot_tpu_torch import host_offload
from torchsnapshot_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    make_train_state,
    train_step,
)
from torchsnapshot_tpu_torch.ops import device_pack, flash_attention, kernels
from torchsnapshot_tpu_torch.parallel.ring_attention import dense_attention, ring_attention
from torchsnapshot_tpu_torch.preparers import prepare_write
from torchsnapshot_tpu_torch.serialization import dtype_to_string, string_to_dtype
from torchsnapshot_tpu_torch.storage.fs import FSStoragePlugin

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth, bf16 tensor rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
N_LAYERS = 2
# the many_ranks path's depth: its world-2 take and restore repeat the
# fleet path's at full depth, so it runs one layer
MANY_RANKS_LAYERS = 1
SEQ = 2048
READ_BUDGET = 32 << 20  # the budgeted reads' memory_budget_bytes


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def misses(family):
    """The registry's counts of one miss family (``tts.obs.READ_TILE_MISSES``
    or ``READ_UNPACK_MISSES``), by reason."""
    prefix = family + "."
    return {k[len(prefix):]: v for k, v in tts.obs.counters().items() if k.startswith(prefix)}


def pinned_gauge():
    """The gauge of pinned read buffers in use; its ``max`` is the
    high-water mark since its last ``reset_max()``."""
    return tts.obs.gauge(tts.obs.READ_PINNED_IN_USE)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters=20, warmup=3):
    """Device time of one ``fn()`` call: CUDA events around ``iters``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(t):
    return t.numel() * t.element_size()


def phases_of(record):
    """Rank 0's phase rollup of a flight record: seconds (summed over
    concurrent tasks) and count per phase."""
    return json.dumps(record["per_rank"]["0"]["phases"], sort_keys=True)


def first_device_slab(model):
    """The member tensors of the first slab ``Snapshot.take`` packs on the
    device for this model (same planning code as the take)."""
    _, flat = flatten(model.state_dict(), prefix="model")
    entries, reqs = {}, []
    for path in sorted(flat):
        entry, wr = prepare_write(flat[path], path, rank=0)
        entries[path] = entry
        reqs.extend(wr)
    _, reqs = batch_write_requests(entries, reqs, 0)
    for wr in reqs:
        s = wr.buffer_stager
        if isinstance(s, BatchedBufferStager) and s.on_device:
            return [st.tensor for st, _ in s.stagers]
    raise RuntimeError("the plan has no device slab")


def kernel_record(name, source, replaces, err, ms, plain_ms, bound_ms, bound_by, library_ms):
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


def interleave_steps(members):
    """``members`` each followed by a 4-byte f32 CUDA scalar, the ``step``
    that ``torch.optim.AdamW(fused=True)`` keeps on the card beside every
    parameter: in the slab every member after the first then sits at 4,
    8, 12, ... mod 16, as the batcher's path order puts them."""
    out = []
    for i, t in enumerate(members):
        out += [t, torch.full((), float(i + 1), device=t.device)]
    return out


def pack_launch(members):
    """K1's launch alone, its table built beforehand (as ``pack_slab``
    builds it): a callable returning the launch's error code."""
    lib = kernels.lib("slab_pack")
    plan, total_chunks, total = device_pack.pack_plan(
        [nbytes(t) for t in members], lib.tsnp_slab_pack_chunk_bytes()
    )
    table, on_device = device_pack.descriptor_table(
        [(t.data_ptr(), *row) for t, row in zip(members, plan)],
        lib.tsnp_slab_pack_inline_members(), members[0].device,
    )
    slab = torch.empty(total, dtype=torch.uint8, device=members[0].device)
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: lib.tsnp_slab_pack(table.data_ptr(), on_device, len(plan), total_chunks,
                                      slab.data_ptr(), stream)


def fmt_t(t):
    return f"{t[0]:.4f} ms ({t[1]:.4f}-{t[2]:.4f})"


def phase_k1(members):
    """K1 on the take's first device slab (aligned members) and on the same
    members interleaved with 4-byte scalars (misaligned), bitwise against
    the plain version; ``pack_slab`` as called and its launch alone, with
    ``torch.cat`` of the same bytes as the yardstick, 5 timings each."""
    out = {}
    for what, ms in (("aligned", members), ("misaligned", interleave_steps(members))):
        total = sum(nbytes(t) for t in ms)
        got = device_pack.pack_slab(ms)
        want = device_pack.pack_slab_plain(ms)
        check(torch.equal(got, want), f"K1 {what} slab differs from its plain version")
        err = float((got.int() - want.int()).abs().max()) if total else 0.0
        launch = pack_launch(ms)
        kernels.check(launch(), f"slab_pack {what}")
        views = [t.reshape(-1).view(torch.uint8) for t in ms]
        call_t = time_ms_repeats(lambda: device_pack.pack_slab(ms))
        launch_t = time_ms_repeats(launch)
        cat_t = time_ms_repeats(lambda: torch.cat(views))
        bound_ms = 2 * total / HBM_BYTES_PER_S * 1e3
        out[what] = (ms, got, total, err, call_t, launch_t, cat_t, bound_ms)
        print(f"K1 {what}: {len(ms)} members, {total} bytes; pack_slab as called {fmt_t(call_t)}, "
              f"launch alone {fmt_t(launch_t)}, torch.cat {fmt_t(cat_t)}; bound {bound_ms:.4f} ms "
              f"({100 * bound_ms / call_t[0]:.1f}% as called, {100 * bound_ms / launch_t[0]:.1f}% "
              f"launch alone); {total / call_t[0] / 1e6:.1f} GB/s of slab")
    _, got, total, err, call_t, launch_t, cat_t, bound_ms = out["aligned"]
    mis = out["misaligned"]
    per_byte = (mis[4][0] / mis[2]) / (call_t[0] / total)
    plain_t = time_ms_repeats(lambda: device_pack.pack_slab_plain(members), iters=5)
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    d2h_ms = time_ms(lambda: host.copy_(got, non_blocking=True), iters=5)
    print(f"K1 misaligned time per byte / aligned: {per_byte:.3f}; plain {fmt_t(plain_t)}; pinned D2H "
          f"of the aligned slab {d2h_ms:.3f} ms ({total / d2h_ms / 1e6:.2f} GB/s)")
    record = kernel_record(
        "slab_pack", "torchsnapshot_tpu_torch/csrc/slab_pack.cu",
        "torchsnapshot_tpu/ops/device_pack.py:23", max(err, mis[3]), call_t[0], plain_t[0],
        bound_ms, "bytes", cat_t[0],
    )
    record.update(launch_ms=launch_t[0], misaligned_ms=mis[4][0], misaligned_launch_ms=mis[5][0],
                  misaligned_bound_ms=mis[7], misaligned_library_ms=mis[6][0])
    return got, mis[0], mis[1], record


def unpack_layout(members):
    layout, off = [], 0
    for t in members:
        layout.append((off, dtype_to_string(t.dtype), tuple(t.shape)))
        off += nbytes(t)
    return layout


def phase_k2(slab, members, mis_slab, mis_members):
    """Unpack the K1 slab plus a bool member, casting member 0 bf16 → f32;
    and the misaligned K1 slab into aligned templates of the stored
    dtypes (identity members at 4, 8, 12 mod 16).  Both bitwise against
    the plain version, 5 timings each."""
    g = torch.Generator(device="cuda").manual_seed(2)
    flags = torch.rand(4099, device="cuda", generator=g) > 0.5
    slab = torch.cat([slab, flags.view(torch.uint8)])
    layout = unpack_layout(members + [flags])
    out_dtypes = [torch.float32] + [t.dtype for t in members[1:]] + [torch.bool]
    outs = [torch.empty(t.shape, dtype=d, device="cuda") for t, d in zip(members + [flags], out_dtypes)]
    mis_layout = unpack_layout(mis_members)
    mis_dtypes = [t.dtype for t in mis_members]
    mis_outs = [torch.empty_like(t) for t in mis_members]
    times = {}
    for what, sl, lay, dts, os_ in (("aligned", slab, layout, out_dtypes, outs),
                                     ("misaligned", mis_slab, mis_layout, mis_dtypes, mis_outs)):
        device_pack.unpack_slab_into(sl, lay, os_)
        want = device_pack.unpack_slab_plain(sl, lay, dts)
        for o, w in zip(os_, want):
            check(o.dtype == w.dtype and torch.equal(o, w), f"K2 {what} output differs from its plain version")
        times[what] = time_ms_repeats(lambda sl=sl, lay=lay, os_=os_: device_pack.unpack_slab_into(sl, lay, os_))
    check(all(torch.equal(o, t) for o, t in zip(mis_outs, mis_members)), "K2 misaligned: members differ")
    out_bytes = sum(nbytes(o) for o in outs)
    bound_ms = (nbytes(slab) + out_bytes) / HBM_BYTES_PER_S * 1e3
    mis_bound_ms = 2 * nbytes(mis_slab) / HBM_BYTES_PER_S * 1e3

    def plain_into():
        # the plain version plus the copy into the templates the kernel
        # writes (identity members decode to views of the slab)
        for o, w in zip(outs, device_pack.unpack_slab_plain(slab, layout, out_dtypes)):
            o.copy_(w)

    plain_t = time_ms_repeats(plain_into, iters=5)

    def slab_views(sl, lay):
        views = []
        for off, d, shape in lay:
            dt = string_to_dtype(d)
            n = dt.itemsize * math.prod(shape)
            views.append(sl[off:off + n].view(dt).view(shape))
        return views

    # the library's one call for the same function: torch._foreach_copy_
    # from the slab's views (stored dtypes) into the templates, casting
    lib_t = {}
    for what, sl, lay, os_ in (("aligned", slab, layout, outs), ("misaligned", mis_slab, mis_layout, mis_outs)):
        views = slab_views(sl, lay)
        for o in os_:
            o.zero_()
        torch._foreach_copy_(os_, views)
        want = device_pack.unpack_slab_plain(sl, lay, [o.dtype for o in os_])
        check(all(torch.equal(o, w) for o, w in zip(os_, want)), f"_foreach_copy_ {what} differs from K2's plain version")
        lib_t[what] = time_ms_repeats(lambda os_=os_, views=views: torch._foreach_copy_(os_, views))
    print(f"K2 aligned (member 0 cast bf16 -> f32): {fmt_t(times['aligned'])}, bound {bound_ms:.4f} ms "
          f"({100 * bound_ms / times['aligned'][0]:.1f}%); misaligned identity: {fmt_t(times['misaligned'])}, "
          f"bound {mis_bound_ms:.4f} ms ({100 * mis_bound_ms / times['misaligned'][0]:.1f}%); "
          f"plain {fmt_t(plain_t)}; torch._foreach_copy_ from the slab's views aligned {fmt_t(lib_t['aligned'])}, "
          f"misaligned {fmt_t(lib_t['misaligned'])}")
    record = kernel_record(
        "slab_unpack", "torchsnapshot_tpu_torch/csrc/slab_unpack.cu",
        "torchsnapshot_tpu/ops/device_pack.py:86", 0.0, times["aligned"][0], plain_t[0],
        bound_ms, "bytes", lib_t["aligned"][0],
    )
    record.update(misaligned_ms=times["misaligned"][0], misaligned_bound_ms=mis_bound_ms,
                  misaligned_library_ms=lib_t["misaligned"][0])
    return record


def phase_k6(cfg):
    """K6 at full width: 32 MiB bf16 tiles of the embedding (vocab x d_model
    bf16, the budgeted read's tile size) cast into an f32 template, at
    offset 0 and as the last, ragged tile; bitwise against
    ``tile_update_plain``.  The full tile timed 5 times beside the plain
    version and the one PyTorch call computing the same thing,
    ``dst.view(-1)[off:off + n].copy_(tile)``."""
    g = torch.Generator(device="cuda").manual_seed(5)
    total = cfg.vocab * cfg.d_model
    emb = torch.randn(total, device="cuda", generator=g).to(torch.bfloat16)
    dst = torch.zeros(total, dtype=torch.float32, device="cuda")
    want = torch.zeros_like(dst)
    n_tile = READ_BUDGET // emb.element_size()
    last = (total - 1) // n_tile * n_tile
    err = 0.0
    for off in (0, last):
        tile = emb[off:off + n_tile]
        device_pack.tile_update(dst, off, tile)
        device_pack.tile_update_plain(want, off, tile)
        torch.cuda.synchronize()
        check(torch.equal(dst, want), f"K6 tile at {off} ({tile.numel()} elements) differs from its plain version")
        check(torch.equal(dst[off:off + tile.numel()], tile.float()), f"K6 tile at {off}: not the cast tile")
        err = max(err, float((dst - want).abs().max()))
    print(f"K6: bf16 -> f32 tiles of {n_tile} and {total - last} elements (offsets 0 and {last}) "
          "bitwise equal to the plain version")
    tile = emb[:n_tile]
    k6_t = time_ms_repeats(lambda: device_pack.tile_update(dst, 0, tile))
    plain_t = time_ms_repeats(lambda: device_pack.tile_update_plain(want, 0, tile))
    copy_t = time_ms_repeats(lambda: dst.view(-1)[0:n_tile].copy_(tile))
    bound_ms = (nbytes(tile) + n_tile * 4) / HBM_BYTES_PER_S * 1e3
    print(f"K6 timings, median of 5 (range), one {nbytes(tile)}-byte bf16 tile into f32: tile_update "
          f"{fmt_t(k6_t)}, {100 * bound_ms / k6_t[0]:.1f}% of its {bound_ms:.4f} ms bound "
          f"({(nbytes(tile) + n_tile * 4) / k6_t[0] / 1e6:.1f} GB/s); copy_ {fmt_t(copy_t)}; "
          f"plain {fmt_t(plain_t)}")
    return kernel_record(
        "tile_update", "torchsnapshot_tpu_torch/csrc/tile_update.cu",
        "torchsnapshot_tpu/ops/device_pack.py:138", err, k6_t[0], plain_t[0], bound_ms, "bytes",
        copy_t[0],
    )


def compare_partials(got, want, what):
    """Holds K3's partials to their tolerances; returns the normalised pv
    error and the largest absolute error of the kernel's own outputs (pv,
    finite m, l)."""
    pv, m, l = got
    wpv, wm, wl = want
    finite = torch.isfinite(wm)
    check(torch.equal(torch.isfinite(m), finite), f"{what}: masked rows differ")
    m_err = float((m - wm).abs()[finite].max()) if bool(finite.any()) else 0.0
    check(m_err <= 1e-3, f"{what}: m beyond atol 1e-3")
    denom = lambda x: torch.where(x == 0, 1.0, x)[..., None]  # noqa: E731
    err = float((pv / denom(l) - wpv / denom(wl)).abs().max())
    check(err <= 2e-2, f"{what}: normalised pv error {err} beyond 2e-2")
    check(bool(((l - wl).abs() <= 2e-2 * wl.abs() + 2e-2).all()), f"{what}: l beyond 2e-2")
    abs_err = max(float((pv - wpv).abs().max()), m_err, float((l - wl).abs().max()))
    return err, abs_err


def phase_k3():
    g = torch.Generator(device="cuda").manual_seed(3)
    bh, d = 32, 128
    scale = 1.0 / d ** 0.5

    def qkv(sq, sk):
        mk = lambda n: torch.randn((bh, n, d), device="cuda", generator=g).to(torch.bfloat16)  # noqa: E731
        return mk(sq), mk(sk), mk(sk)

    lib = kernels.lib("flash_attention_fwd")
    stream = torch.cuda.current_stream().cuda_stream

    def launch_at(q, k, v, qo, ko):
        """K3's launch alone (as K4/K5 are timed) at these offsets."""
        sq, sk = q.shape[1], k.shape[1]
        outs = [torch.empty((bh, sq, d), device="cuda"), torch.empty((bh, sq), device="cuda"),
                torch.empty((bh, sq), device="cuda")]
        return lambda: lib.tsnp_flash_fwd(  # noqa: E731
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *(t.data_ptr() for t in outs),
            bh, sq, sk, d, scale, 1, qo, ko, sq, sk, 1, stream)

    offset_cases = {}
    for what, sq, sk, qo, ko in K3_CASES:
        q, k, v = qkv(sq, sk)
        got = flash_attention.attend_partials(q, k, v, qo, ko, True, scale)
        want = flash_attention.attend_partials_plain(q, k, v, qo, ko, True, scale, sq, sk)
        err, abs_err = compare_partials(got, want, f"K3 {what}")
        print(f"K3 {what} (sq={sq}, sk={sk}, q_offset={qo}, k_offset={ko}): normalised pv error {err:.3e}, "
              f"max abs err of pv, m, l {abs_err:.3e}")
        if what == "k_offset_masked":
            # the ring's block wholly above the diagonal: no row sees a key
            pv, m, l = got
            m_safe = torch.where(torch.isfinite(m), m, 0.0)
            check(not bool((l > 0).any()) and not bool(pv.any()) and not bool(m_safe.any()),
                  "K3 k_offset_masked: a row is valid, or pv, l or m_safe is not 0")
        if what == "main" or what.startswith("k_offset"):
            again = flash_attention.attend_partials(q, k, v, qo, ko, True, scale)
            for name, a, b in zip(("pv", "m", "l"), got, again):
                check(torch.equal(a, b), f"K3 {what}: a second call gives other bits in {name}")
            print(f"K3 {what}: a second call gives the same pv, m and l bitwise")
        if what == "main":
            main_err, main = (err, abs_err), (q, k, v)
        elif what.startswith("k_offset"):
            launch = launch_at(q, k, v, qo, ko)
            kernels.check(launch(), "flash_fwd")
            t = time_ms_repeats(launch)
            flops = 4 * bh * d * causal_pairs(sq, sk, qo - ko)
            # a block no row sees reads no input: it writes its outputs only
            io_bytes = (3 * bh * sk * d * 2 if flops else 0) + bh * sq * d * 4 + 2 * bh * sq * 4
            bound = max(flops / BF16_FLOP_PER_S, io_bytes / HBM_BYTES_PER_S) * 1e3
            offset_cases[what] = {"normalised_pv_err": err, "max_abs_err": abs_err, "ms": t[0],
                                  "bound_ms": bound}
            print(f"K3 {what}: {fmt_t(t)}, {100 * bound / t[0]:.1f}% of its {bound:.4f} ms bound")
        del got, want
    q, k, v = main
    # the launch alone, as K4/K5 are timed, and attend_partials as called
    launch = launch_at(q, k, v, 0, 0)
    kernels.check(launch(), "flash_fwd")
    k3_t = time_ms_repeats(launch)
    called_t = time_ms_repeats(lambda: flash_attention.attend_partials(q, k, v, 0, 0, True, scale))
    plain_t = time_ms_repeats(
        lambda: flash_attention.attend_partials_plain(q, k, v, 0, 0, True, scale, SEQ, SEQ), repeats=3, iters=3
    )
    qs, ks, vs = (t.unsqueeze(0) for t in (q, k, v))  # [1, h, s, d]
    sdpa_t = time_ms_repeats(
        lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    )
    flops = 4 * bh * d * causal_pairs(SEQ, SEQ, 0)
    io_bytes = 3 * bh * SEQ * d * 2 + bh * SEQ * d * 4 + 2 * bh * SEQ * 4
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, io_bytes / HBM_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    print(f"K3 timings, median of 5 (range): flash_attention_fwd {fmt_t(k3_t)}, "
          f"{flops / k3_t[0] / 1e9:.1f} TFLOP/s, {100 * bound_ms / k3_t[0]:.1f}% of its {bound_ms:.4f} ms "
          f"bound; attend_partials as called {fmt_t(called_t)}; SDPA forward {fmt_t(sdpa_t)} "
          f"({flops / sdpa_t[0] / 1e9:.1f} TFLOP/s, bf16 output, K3 writes pv in f32); plain {fmt_t(plain_t)}")
    record = kernel_record(
        "flash_attention_fwd", "torchsnapshot_tpu_torch/csrc/flash_attention_fwd.cu",
        "torchsnapshot_tpu/ops/flash_attention.py:136", main_err[1], k3_t[0], plain_t[0],
        bound_ms, "operations" if t_ops >= t_bytes else "bytes", sdpa_t[0],
    )
    record.update(normalised_pv_err=main_err[0], called_ms=called_t[0], offset_cases=offset_cases)
    return record


def causal_pairs(sq, sk, offset):
    """(query, key) pairs a causal block sees: row i sees keys ≤ offset + i
    (``offset`` = q_offset - k_offset)."""
    return sum(min(sk, max(0, offset + i + 1)) for i in range(sq))


# the blocks a causal ring of two ranks of SEQ positions each computes:
# rank 0 at step 1 (wholly above the diagonal), rank 1 at step 0 (the
# diagonal at an offset) and rank 1 at step 1 (no mask at all)
RING_OFFSET_CASES = [("k_offset_masked", SEQ, SEQ, 0, SEQ), ("k_offset_diag", SEQ, SEQ, SEQ, SEQ),
                     ("k_offset_unmasked", SEQ, SEQ, SEQ, 0)]
K3_CASES = [("main", SEQ, SEQ, 0, 0), ("ragged", 2000, 1900, 0, 0), ("q_offset", 1024, SEQ, 1024, 0),
            *RING_OFFSET_CASES]


def time_ms_repeats(fn, repeats=5, iters=10):
    """``time_ms`` ``repeats`` times: (median, min, max)."""
    times = sorted(time_ms(fn, iters=iters) for _ in range(repeats))
    return times[len(times) // 2], times[0], times[-1]


def phase_k4_k5():
    """K4 (dq, amax) and K5 (dk, dv) against their plain version at the
    ring-attention shape (bh = 32, s = 2048, d = 128, bf16, causal), a
    ragged case, a q_offset case and a tile-edge case (s = 2047); m is
    K3's, the cotangents random.  Two calls at the main shape must give
    the same bits (no float atomics)."""
    g = torch.Generator(device="cuda").manual_seed(4)
    bh, d = 32, 128
    scale = 1.0 / d ** 0.5
    mk = lambda *shape: torch.randn(shape, device="cuda", generator=g)  # noqa: E731
    cases = [("main", SEQ, SEQ, 0, 0), ("ragged", 2000, 1900, 0, 0), ("q_offset", 1024, SEQ, 1024, 0),
             ("tile_edge", SEQ - 1, SEQ - 1, 0, 0), *RING_OFFSET_CASES]
    lib_dq, lib_dkv = kernels.lib("flash_attention_bwd_dq"), kernels.lib("flash_attention_bwd_dkv")
    stream = torch.cuda.current_stream().cuda_stream

    def launches_at(q, k, v, m, gpv, gl, qo, ko):
        """K4's and K5's launches alone, as ``flash_bwd`` makes them."""
        sq, sk = q.shape[1], k.shape[1]
        outs = [torch.empty((bh, n, d), device="cuda") for n in (sq, sk, sk)]
        amax = torch.empty((bh, sq), dtype=torch.int32, device="cuda")
        ins = [t.data_ptr() for t in (q, k, v, m, gpv, gl)]
        args = (bh, sq, sk, d, scale, 1, qo, ko, sq, sk, 1, stream)
        return (lambda: lib_dq.tsnp_flash_bwd_dq(*ins, outs[0].data_ptr(), amax.data_ptr(), *args),
                lambda: lib_dkv.tsnp_flash_bwd_dkv(*ins, outs[1].data_ptr(), outs[2].data_ptr(), *args),
                outs, amax)

    errs, offset_cases = {}, {}
    for what, sq, sk, qo, ko in cases:
        q, k, v = (mk(bh, n, d).to(torch.bfloat16) for n in (sq, sk, sk))
        _, m, _ = flash_attention.attend_partials(q, k, v, qo, ko, True, scale)
        m = torch.where(torch.isfinite(m), m, 0.0).contiguous()
        # the ring path hands the kernels gpv in bf16 (pv is bf16)
        gpv, gl = mk(bh, sq, d).to(torch.bfloat16), mk(bh, sq)
        got = flash_attention.flash_bwd(q, k, v, m, gpv, gl, qo, ko, True, scale)
        want = flash_attention.flash_bwd_plain(q, k, v, m, gpv, gl, qo, ko, True, scale, sq, sk)
        torch.cuda.synchronize()
        if what == "main" or what.startswith("k_offset"):
            again = flash_attention.flash_bwd(q, k, v, m, gpv, gl, qo, ko, True, scale)
            torch.cuda.synchronize()
            for name, a, b in zip(("dq", "dk", "dv", "amax"), got, again):
                check(torch.equal(a, b), f"K4/K5 {what}: a second call gives other bits in {name}")
            del again
            print(f"K4/K5 {what}: a second call gives the same dq, dk, dv and amax bitwise")
        if what == "k_offset_masked":
            check(not any(bool(t.any()) for t in got[:3]) and bool((got[3] == -1).all()),
                  "K4/K5 k_offset_masked: a gradient is not 0 or a row has an argmax")
        case_errs = {}
        for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
            check(bool(torch.isfinite(a).all()), f"K4/K5 {what}: {name} not finite")
            abs_err = float((a - b).abs().max())
            rel = abs_err / max(float(b.abs().max()), 1e-30)
            check(rel <= 2e-2, f"K4/K5 {what}: {name} relative error {rel} beyond 2e-2")
            case_errs[name] = (abs_err, rel)
        mask = flash_attention._visible(sq, sk, qo, ko, True, sq, sk, q.device)
        top = flash_attention._scores(q, k, scale, mask).topk(2, dim=-1).values
        clear = (top[..., 0] - top[..., 1] > 1e-2 * (1 + top[..., 0].abs())) | ~torch.isfinite(top[..., 1])
        case_errs["amax_moved"] = int((got[3] != want[3]).sum())
        check(torch.equal(got[3][clear], want[3][clear]), f"K4 {what}: argmax differs on clear rows")
        print(f"K4/K5 {what} (sq={sq}, sk={sk}, q_offset={qo}, k_offset={ko}): max abs err (max error / max "
              "|plain|) "
              + ", ".join(f"{n} {case_errs[n][0]:.3e} ({case_errs[n][1]:.3e})" for n in ("dq", "dk", "dv"))
              + f"; argmax: {case_errs['amax_moved']} of {bh * sq} rows differ, all within near-ties "
              f"({int(clear.sum())} clear rows equal)")
        errs[what] = case_errs
        if what == "main":
            main = (q, k, v, m, gpv, gl)
        elif what.startswith("k_offset"):
            dq_launch, dkv_launch, _, _ = launches_at(q, k, v, m, gpv, gl, qo, ko)
            pairs = causal_pairs(sq, sk, qo - ko) * bh
            # a block no row sees reads no input: it writes its outputs only
            in_bytes = 3 * nbytes(q) + nbytes(m) + nbytes(gpv) + nbytes(gl) if pairs else 0
            row = {"max_abs_err": {n: case_errs[n][0] for n in ("dq", "dk", "dv")}}
            for name, fn, flop_per_pair, out_bytes in (
                ("dq", dq_launch, 6 * d, bh * sq * d * 4 + bh * sq * 4),
                ("dkv", dkv_launch, 8 * d, 2 * bh * sk * d * 4),
            ):
                kernels.check(fn(), f"flash_bwd_{name}")
                t = time_ms_repeats(fn)
                bound = max(flop_per_pair * pairs / BF16_FLOP_PER_S, (in_bytes + out_bytes) / HBM_BYTES_PER_S) * 1e3
                row[f"{name}_ms"], row[f"{name}_bound_ms"] = t[0], bound
            offset_cases[what] = row
            print(f"K4/K5 {what}: K4 {row['dq_ms']:.4f} ms ({100 * row['dq_bound_ms'] / row['dq_ms']:.1f}% of its "
                  f"{row['dq_bound_ms']:.4f} ms bound), K5 {row['dkv_ms']:.4f} ms "
                  f"({100 * row['dkv_bound_ms'] / row['dkv_ms']:.1f}% of its {row['dkv_bound_ms']:.4f} ms bound)")
        del q, k, v, got, want, mask, top
    q, k, v, m, gpv, gl = main
    dq_launch, dkv_launch, outs, amax = launches_at(q, k, v, m, gpv, gl, 0, 0)
    # each kernel alone, as flash_bwd launches it; 5 timings of 10 calls each
    dq_t = time_ms_repeats(dq_launch)
    dkv_t = time_ms_repeats(dkv_launch)
    plain_t = time_ms_repeats(
        lambda: flash_attention.flash_bwd_plain(q, k, v, m, gpv, gl, 0, 0, True, scale, SEQ, SEQ), iters=3
    )
    # yardstick for K4 + K5 together: SDPA's backward, graph retained
    qs, ks, vs = (t.unsqueeze(0).detach().requires_grad_() for t in (q, k, v))  # [1, h, s, d]
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    go = torch.randn(out.shape, device="cuda", generator=g).to(out.dtype)
    sdpa_t = time_ms_repeats(lambda: torch.autograd.grad(out, (qs, ks, vs), go, retain_graph=True))
    pairs = causal_pairs(SEQ, SEQ, 0) * bh
    in_bytes = 3 * nbytes(q) + nbytes(m) + nbytes(gpv) + nbytes(gl)
    main_errs = errs["main"]
    records, lines = [], []
    # each record holds its own outputs' absolute error at the main shape
    for name, source, line, t, flop_per_pair, out_bytes, err, library_ms in (
        ("flash_attention_bwd_dq", "flash_attention_bwd_dq.cu", 293, dq_t, 6 * d,
         nbytes(outs[0]) + nbytes(amax), main_errs["dq"][0], None),
        ("flash_attention_bwd_dkv", "flash_attention_bwd_dkv.cu", 375, dkv_t, 8 * d,
         nbytes(outs[1]) + nbytes(outs[2]), max(main_errs["dk"][0], main_errs["dv"][0]), sdpa_t[0]),
    ):
        flops = flop_per_pair * pairs
        t_ops = flops / BF16_FLOP_PER_S
        t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
        bound_ms = max(t_ops, t_bytes) * 1e3
        records.append(kernel_record(
            name, f"torchsnapshot_tpu_torch/csrc/{source}",
            f"torchsnapshot_tpu/ops/flash_attention.py:{line}",
            err, t[0], plain_t[0], bound_ms,
            "operations" if t_ops >= t_bytes else "bytes", library_ms,
        ))
        lines.append(f"{name} {t[0]:.4f} ms (range {t[1]:.4f}-{t[2]:.4f}), "
                     f"{flops / t[0] / 1e9:.1f} TFLOP/s, {100 * bound_ms / t[0]:.1f}% of its "
                     f"{bound_ms:.4f} ms bound")
    # K4's other output: argmax rows that a near-tie moved at the main shape
    records[0]["argmax_rows_moved"] = main_errs["amax_moved"]
    for rec, name in zip(records, ("dq", "dkv")):
        rec["offset_cases"] = {
            what: {"ms": row[f"{name}_ms"], "bound_ms": row[f"{name}_bound_ms"],
                   "max_abs_err": row["max_abs_err"]["dq"] if name == "dq"
                   else max(row["max_abs_err"]["dk"], row["max_abs_err"]["dv"])}
            for what, row in offset_cases.items()
        }
    both = dq_t[0] + dkv_t[0]
    print(f"K4/K5 timings, median of 5 (range): {'; '.join(lines)}; K4 + K5 {both:.4f} ms, "
          f"{14 * d * pairs / both / 1e9:.1f} TFLOP/s; plain backward (both) {plain_t[0]:.3f} ms "
          f"({plain_t[1]:.3f}-{plain_t[2]:.3f}); SDPA backward (yardstick for K4 + K5) "
          f"{sdpa_t[0]:.4f} ms ({sdpa_t[1]:.4f}-{sdpa_t[2]:.4f})")
    return records


def adamw_step(model, tokens):
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=0.01)
    logits = model(tokens[:, :-1])
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1)
    )
    loss.backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    return opt


def state_bytes(model, opt):
    total = sum(nbytes(t) for t in model.state_dict().values())
    for st in opt.state_dict()["state"].values():
        total += sum(nbytes(v) for v in st.values() if isinstance(v, torch.Tensor))
    return total


def phase_main_path(cfg, model, opt, root):
    g = torch.Generator(device="cuda").manual_seed(7)
    eval_tokens = torch.randint(0, cfg.vocab, (1, 64), device="cuda", generator=g)
    with torch.no_grad():
        logits = model(eval_tokens)
    nb = state_bytes(model, opt)

    torch.cuda.synchronize()
    tts.obs.reset_metrics()
    t0 = time.perf_counter()
    snap = tts.Snapshot.take(
        root, {"model": model, "optim": opt, "rng": tts.RNGState(), "meta": tts.StateDict(step=1)}
    )
    take_s = time.perf_counter() - t0
    print(f"take phases (flight record): {phases_of(tts.obs.aggregate.read_obsrecord(root))}")

    torch.manual_seed(1)
    model2 = TransformerLM(cfg, device="cuda")
    opt2 = adamw_step(model2, torch.randint(0, cfg.vocab, (1, 65), device="cuda", generator=g))
    meta2 = tts.StateDict(step=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tts.Snapshot(root).restore({"model": model2, "optim": opt2, "rng": tts.RNGState(), "meta": meta2})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    print(f"restore phases (flight record): {phases_of(tts.obs.aggregate.last_record('restore'))}")

    for (name, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        check(a.dtype == b.dtype and torch.equal(a, b), f"restored model tensor {name} differs")
    s1, s2 = opt.state_dict(), opt2.state_dict()
    check(s1["param_groups"] == s2["param_groups"], "optimizer param_groups differ")
    for i, st in s1["state"].items():
        for k, v in st.items():
            check(torch.equal(v, s2["state"][i][k]), f"optimizer state {i}/{k} differs")
    with torch.no_grad():
        check(torch.equal(model2(eval_tokens), logits), "logits differ after restore")
    check(meta2["step"] == 1, "meta step not restored")
    wq = snap.read_object("0/model/layer0.attn.wq.weight")  # a new tensor on cuda
    check(wq.is_cuda and torch.equal(wq, model.layer0.attn.wq.weight), "read_object differs")
    print(f"main path: state {nb} bytes; take {take_s:.3f} s ({nb / take_s / 1e9:.3f} GB/s), "
          f"restore {restore_s:.3f} s ({nb / restore_s / 1e9:.3f} GB/s)")
    print("restore members routed to the host path before launch: "
          f"{json.dumps(misses(tts.obs.READ_UNPACK_MISSES))}; K1 members made contiguous "
          f"first: {device_pack.COUNTS['made_contiguous']}; counters: "
          f"{json.dumps(tts.obs.counters())}")
    return model2


def host_digest_rate():
    """crc32 + adler32 over the same 256 MiB (the digests every staged
    byte pays during take), median of 3: zlib's two passes on one thread,
    the native one-pass ``tsnp_digest`` on one thread and on 4 threads at
    once (the staging threads; the GIL is released), and the native
    ``tsnp_copy_digest`` (the host slab pack).  Every result must equal
    zlib's."""
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from torchsnapshot_tpu_torch import _csrc

    lib = _csrc.load()
    buf = np.random.default_rng(0).integers(0, 256, 256 << 20, dtype=np.uint8)
    dst = np.empty_like(buf)
    want = (zlib.crc32(buf), zlib.adler32(buf))

    def median_s(fn):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = fn()
            times.append(time.perf_counter() - t0)
            check(got == want, f"host digest {got} != zlib's {want}")
        return sorted(times)[1]

    zlib_s = median_s(lambda: (zlib.crc32(buf), zlib.adler32(buf)))
    native_s = median_s(lambda: _csrc.digest(lib, buf))
    with ThreadPoolExecutor(4) as pool:
        def four():
            res = list(pool.map(lambda _: _csrc.digest(lib, buf), range(4)))
            check(all(r == want for r in res), "threaded native digest differs from zlib")
            return res[0]
        four_s = median_s(four)
    copy_s = median_s(lambda: _csrc.copy_digest(lib, dst, buf))
    check(bool((dst == buf).all()), "copy_digest copied the wrong bytes")
    gb = buf.nbytes / 1e9
    print(f"host digest rate (crc32 + adler32 of 256 MiB, median of 3, equal to zlib's): "
          f"zlib one thread {gb / zlib_s:.3f} GB/s; native tsnp_digest one thread "
          f"{gb / native_s:.3f} GB/s, 4 threads together {4 * gb / four_s:.3f} GB/s; "
          f"native tsnp_copy_digest one thread {gb / copy_s:.3f} GB/s; host cores: {os.cpu_count()}")


FASTIO_SETTINGS = {  # label → (FASTIO, FASTIO_DIRECT)
    "FASTIO=0": (False, False),
    "FASTIO=1": (True, False),
    "FASTIO=1+FASTIO_DIRECT=1": (True, True),
}
# two runs a setting (three until the stripe_codec path joined the script,
# to keep the whole run near 300 s)
FASTIO_REPEATS = 1  # 2 until the cloud_interop path came
FASTIO_COUNTERS = (
    "FASTIO_BYTES_WRITTEN", "FASTIO_BYTES_READ", "FASTIO_FUSED_DIGESTS", "FASTIO_POOL_WAITS",
    "FASTIO_DIRECT_PARTS", "FASTIO_BUFFERED_PARTS", "FASTIO_DONTNEED_READS",
)


def snapshot_digests(root):
    """The manifest's digests: each entry's crc32 and each stored object's
    [crc32, adler32, size]."""
    md = tts.Snapshot(root).metadata
    return {k: getattr(e, "crc32", None) for k, e in md.manifest.items()}, md.objects


def zero_state(model, opt):
    with torch.no_grad():
        for t in model.state_dict().values():
            t.zero_()
        for st in opt.state_dict()["state"].values():
            for v in st.values():
                if isinstance(v, torch.Tensor):
                    v.zero_()


def phase_fastio(cfg, model, opt, work):
    """The serving state taken and restored under FASTIO=0 (the fs
    plugin's pure-Python legs), FASTIO=1 (the engine, buffered) and
    FASTIO=1 + FASTIO_DIRECT=1, ``FASTIO_REPEATS`` times each in
    alternating order, each snapshot deleted after use.  Every restore
    lands in a zeroed model and optimizer and must equal the state
    bitwise; every snapshot's manifest digests must equal the first's.
    The restores run under MMAP=0, so they read through the engine."""
    from torchsnapshot_tpu_torch import _csrc, knobs
    from torchsnapshot_tpu_torch.storage.fs import FSStoragePlugin

    root = os.path.join(work, "fastio")
    os.makedirs(root)
    with knobs.override_fastio_direct(True):
        probe = FSStoragePlugin(root)
    check(probe._fastio is not None, "the fast-I/O engine did not load with the knobs at their defaults")
    direct = probe._fastio.direct
    probe.sync_close()
    print(f"fastio: library {_csrc.LOADED['path']} built from {_csrc.SOURCE}, g++ flags "
          f"'{_csrc.LOADED['flags']}'; O_DIRECT on the work directory {root}: "
          f"{'active' if direct else 'refused (buffered legs + posix_fadvise DONTNEED)'}")
    nb = state_bytes(model, opt)
    model2, opt2 = deterministic_state(cfg, 3)
    labels = list(FASTIO_SETTINGS)
    times = {label: {"take": [], "restore": []} for label in labels}
    counts = {label: dict.fromkeys(FASTIO_COUNTERS, 0) for label in labels}
    ref_digests = None
    for rep in range(FASTIO_REPEATS):
        for label in labels if rep % 2 == 0 else labels[::-1]:
            fio, fdirect = FASTIO_SETTINGS[label]
            snap_dir = os.path.join(root, f"rep{rep}")
            zero_state(model2, opt2)
            t0 = time.perf_counter()
            os.sync()  # no earlier run's dirty pages in this one's way
            sync_s = time.perf_counter() - t0
            before = tts.obs.counters()
            # MMAP=0: a mapped restore never reaches the engine's reads
            with knobs.override_fastio(fio), knobs.override_fastio_direct(fdirect), knobs.override_mmap(False):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tts.Snapshot.take(snap_dir, {"model": model, "optim": opt})
                times[label]["take"].append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                tts.Snapshot(snap_dir).restore({"model": model2, "optim": opt2})
                torch.cuda.synchronize()
                times[label]["restore"].append(time.perf_counter() - t0)
            after = tts.obs.counters()
            print(f"fastio run {rep} {label}: take {times[label]['take'][-1]:.4f} s, phases "
                  f"{phases_of(tts.obs.aggregate.read_obsrecord(snap_dir))}; restore "
                  f"{times[label]['restore'][-1]:.4f} s, phases "
                  f"{phases_of(tts.obs.aggregate.last_record('restore'))}; os.sync before it {sync_s:.3f} s")
            for c in FASTIO_COUNTERS:
                name = getattr(tts.obs, c)
                counts[label][c] += after.get(name, 0) - before.get(name, 0)
            differs = same_state((model, opt), (model2, opt2))
            check(differs is None, f"fastio {label} run {rep}: restored {differs} differs")
            digests = snapshot_digests(snap_dir)
            ref_digests = ref_digests or digests
            check(digests == ref_digests, f"fastio {label} run {rep}: manifest digests differ")
            shutil.rmtree(snap_dir)
    check(counts["FASTIO=0"]["FASTIO_BYTES_WRITTEN"] == 0, "FASTIO=0 went through the engine")
    check(counts["FASTIO=1"]["FASTIO_FUSED_DIGESTS"] > 0, "FASTIO=1 fused no digest into a write")
    check((counts["FASTIO=1+FASTIO_DIRECT=1"]["FASTIO_DIRECT_PARTS"] > 0) == direct,
          "FASTIO_DIRECT=1 did not take the direct legs the probe found")
    for label in labels:
        line = [f"fastio {label}: state {nb} bytes"]
        for op in ("take", "restore"):
            ts = sorted(times[label][op])
            med = ts[len(ts) // 2]
            line.append(f"{op} median {med:.4f} s [{ts[0]:.4f}-{ts[-1]:.4f}] "
                        f"({nb / med / 1e9:.3f} GB/s), runs {[round(t, 4) for t in times[label][op]]}")
        counters = {getattr(tts.obs, c): v for c, v in counts[label].items()}
        print("; ".join(line) + f"; counters over its runs {json.dumps(counters)}")
    print(f"fastio: {FASTIO_REPEATS} runs per setting in alternating order, every restore bitwise, "
          "every manifest's digests equal; a buffered restore reads the files its take wrote just "
          "before, from the page cache, so its seconds are not disk bandwidth")
    del model2, opt2


STRIPE_REPEATS = 1  # 2 until the cloud_interop path came
# raw bytes a frame of the embedding read back in 32 MiB tiles: not a
# divisor or multiple of the tile, so tiles straddle frames
READ_FRAME_BYTES = 40 << 20
STRIPE_COUNTERS = ("STRIPE_WRITES", "STRIPE_READS", "STRIPE_STREAMED_WRITES", "STRIPE_PARTS_WRITTEN",
                   "STRIPE_PARTS_READ", "STRIPE_ABORTS")


def counter_delta(before, names):
    after = tts.obs.counters()
    return {n: after.get(n, 0) - before.get(n, 0) for n in names}


def median_range(ts):
    ts = sorted(ts)
    return f"median {ts[len(ts) // 2]:.4f} s [{ts[0]:.4f}-{ts[-1]:.4f}], runs {[round(t, 4) for t in ts]}"


def temp_files(root):
    return [f for _, _, fs in os.walk(root) for f in fs if ".tsnp-tmp-" in f]


def object_dtypes(md):
    """location → the dtypes of the entries stored in it."""
    out = {}
    for e in md.manifest.values():
        dt = getattr(e, "dtype", None)
        if isinstance(getattr(e, "location", None), str) and dt:
            out.setdefault(e.location, set()).add(dt)
        for piece in (getattr(e, "chunks", None) or ()) + (getattr(e, "shards", None) or ()):
            out.setdefault(piece.location, set()).add(dt)
    return out


def codec_report(md):
    """Stored/raw bytes per dtype (an object of mixed dtypes under
    "mixed") from the codec tables, and the raw bytes of the frames that
    were encoded (raw-fallback frames are raw + 24 bytes)."""
    per, encoded_raw = {}, 0
    dtypes = object_dtypes(md)
    for loc, tbl in md.codecs.items():
        ds = dtypes.get(loc, {"?"})
        key = next(iter(ds)) if len(ds) == 1 else "mixed"
        raw, stored = per.get(key, (0, 0))
        per[key] = (raw + tbl["raw_size"], stored + sum(tbl["parts"]))
        for i, n in enumerate(tbl["parts"]):
            raw_i = min(tbl["part_size"], tbl["raw_size"] - i * tbl["part_size"])
            if n != raw_i + 24:
                encoded_raw += raw_i
    return {k: {"raw": r, "stored": s, "ratio": round(s / r, 4)} for k, (r, s) in sorted(per.items())}, encoded_raw


def expected_striped_reads(md, keys, threshold):
    """Striped reads a restore of ``keys`` makes: each key reads its own
    entries, a location's byte ranges merged into one spanning read (a
    slab holding two keys' members is read once for each), a whole
    object as one read; those of ``threshold`` bytes or more stripe."""
    n = 0
    for key in keys:
        spans, whole = {}, set()
        for p, e in md.manifest.items():
            if not p.startswith(f"0/{key}/"):
                continue
            pieces = [(getattr(e, "location", None), getattr(e, "byte_range", None))]
            pieces += [(c.location, c.byte_range) for c in getattr(e, "chunks", None) or ()]
            for loc, rng in pieces:
                if not isinstance(loc, str):
                    continue
                if rng is None:
                    whole.add(loc)
                else:
                    lo, hi = spans.get(loc, (rng[0], rng[1]))
                    spans[loc] = (min(lo, rng[0]), max(hi, rng[1]))
        n += sum(1 for loc in whole if md.objects[loc][2] >= threshold)
        n += sum(1 for lo, hi in spans.values() if hi - lo >= threshold)
    return n


def hist_delta(name, before):
    h = tts.obs.histogram(name).to_dict()
    return h["sum"] - before.get("sum", 0.0), h["count"] - before.get("count", 0)


def flip_byte_in_frame(src, dst, loc, table):
    """A copy of snapshot ``src`` at ``dst`` with the byte in the middle of
    the second frame of ``loc`` flipped (the other files hardlinked)."""
    shutil.copytree(src, dst, copy_function=os.link)
    path = os.path.join(dst, loc)
    data = bytearray(open(path, "rb").read())
    os.remove(path)  # never write through the shared inode
    pos = table["parts"][0] + table["parts"][1] // 2
    data[pos] ^= 0xFF
    with open(path, "wb") as f:
        f.write(data)


def phase_stripe_codec(cfg, model, opt, work):
    """The stripe engine and the codec layer on the serving state:
    striping at the default knobs against STRIPE_MIN_OBJECT_SIZE_BYTES=0,
    CODEC=huff on the whole state (restore K2, a budgeted read of the
    encoded embedding through K6), CODEC=zlib on the embedding and LM
    head with an incremental take that links them, a deep verify and a
    corrupted frame, then a transient and a permanent part-write fault."""
    from torchsnapshot_tpu_torch import codec as codec_mod
    from torchsnapshot_tpu_torch import knobs, resilience
    from torchsnapshot_tpu_torch.storage import stripe

    root = os.path.join(work, "stripe_codec")
    os.makedirs(root)
    nb = state_bytes(model, opt)
    model2, opt2 = deterministic_state(cfg, 5)
    threshold = knobs.get_stripe_min_object_size_bytes()
    part = knobs.get_stripe_part_size_bytes()
    names = [getattr(tts.obs, c) for c in STRIPE_COUNTERS]
    app = {"model": model, "optim": opt}

    # 1. striping at the default knobs: one take and restore counted
    snap_dir = os.path.join(root, "default")
    before = tts.obs.counters()
    t0 = time.perf_counter()
    tts.Snapshot.take(snap_dir, app)
    take_s = time.perf_counter() - t0
    wrote = counter_delta(before, names)
    md = tts.Snapshot(snap_dir).metadata
    ref_digests = snapshot_digests(snap_dir)
    big = sorted(loc for loc, rec in md.objects.items() if rec[2] >= threshold)
    zero_state(model2, opt2)
    before = tts.obs.counters()
    t0 = time.perf_counter()
    # MMAP=0 here and in the comparison below: a mapped read is never striped
    with knobs.override_mmap(False):
        tts.Snapshot(snap_dir).restore({"model": model2, "optim": opt2})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    read = counter_delta(before, names)
    differs = same_state((model, opt), (model2, opt2))
    check(differs is None, f"stripe_codec: restored {differs} differs")
    check(wrote["storage.stripe.writes"] == len(big),
          f"{wrote['storage.stripe.writes']} striped writes for {len(big)} objects of {threshold} bytes or more")
    want_reads = expected_striped_reads(md, ("model", "optim"), threshold)
    check(read["storage.stripe.reads"] == want_reads,
          f"{read['storage.stripe.reads']} striped reads where the manifest implies {want_reads}")
    check(wrote["storage.stripe.aborts"] == 0, "a striped write aborted")
    print(f"stripe_codec striping: threshold {threshold} bytes, parts {part} bytes; {len(big)} of "
          f"{len(md.objects)} objects at the threshold or above (sizes {[md.objects[b][2] for b in big]}); "
          f"take {take_s:.4f} s counters {json.dumps(wrote)}; restore {restore_s:.4f} s counters "
          f"{json.dumps(read)} ({want_reads} reads of the threshold or more, a slab holding both keys' "
          f"members read once for each); restore bitwise")
    shutil.rmtree(snap_dir)
    times = {label: {"take": [], "restore": []} for label in ("striped", "STRIPE_MIN_OBJECT_SIZE_BYTES=0")}
    for rep in range(STRIPE_REPEATS):
        for label in (list(times) if rep % 2 == 0 else list(times)[::-1]):
            snap_dir = os.path.join(root, f"rep{rep}")
            zero_state(model2, opt2)
            os.sync()
            with knobs.override_stripe_min_object_size_bytes(threshold if label == "striped" else 0), \
                    knobs.override_mmap(False):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tts.Snapshot.take(snap_dir, app)
                times[label]["take"].append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                tts.Snapshot(snap_dir).restore({"model": model2, "optim": opt2})
                torch.cuda.synchronize()
                times[label]["restore"].append(time.perf_counter() - t0)
            differs = same_state((model, opt), (model2, opt2))
            check(differs is None, f"stripe_codec {label} run {rep}: restored {differs} differs")
            shutil.rmtree(snap_dir)
    for label, t in times.items():
        print(f"stripe_codec {label}: state {nb} bytes; take {median_range(t['take'])}; "
              f"restore {median_range(t['restore'])}")

    # 3. CODEC=huff on the whole state, plus f32 copies of one layer's
    # moments (a mixed-precision master keeps its moments in f32)
    st = opt.state_dict()["state"]
    w1 = [i for i, p in enumerate(model.parameters()) if p is model.layer0.mlp.w1.weight][0]
    f32 = tts.StateDict(exp_avg=st[w1]["exp_avg"].float(), exp_avg_sq=st[w1]["exp_avg_sq"].float())
    snap_dir = os.path.join(root, "huff")
    enc_h, dec_h = "storage.codec.encode_latency_s.huff", "storage.codec.decode_latency_s.huff"
    h0 = tts.obs.histogram(enc_h).to_dict()
    before = tts.obs.counters()
    with knobs.override_codec("huff"):
        t0 = time.perf_counter()
        tts.Snapshot.take(snap_dir, {"model": model, "optim": opt, "f32": f32})
        take_s = time.perf_counter() - t0
    enc_s, enc_parts = hist_delta(enc_h, h0)
    c = counter_delta(before, ("storage.codec.parts_encoded", "storage.codec.parts_raw_fallback",
                                "storage.codec.bytes_in", "storage.codec.bytes_out"))
    check(c["storage.codec.parts_encoded"] > 0, "CODEC=huff encoded no part (a quiet degrade to raw)")
    md = tts.Snapshot(snap_dir).metadata
    per_dtype, encoded_raw = codec_report(md)
    check(md.codecs and "bfloat16" in per_dtype and "float32" in per_dtype,
          f"huff codec tables cover {sorted(per_dtype)}")
    zero_state(model2, opt2)
    f32_back = tts.StateDict(exp_avg=torch.zeros_like(f32["exp_avg"]), exp_avg_sq=torch.zeros_like(f32["exp_avg_sq"]))
    h0 = tts.obs.histogram(dec_h).to_dict()
    k2 = device_pack.LAUNCHES["slab_unpack"]
    t0 = time.perf_counter()
    tts.Snapshot(snap_dir).restore({"model": model2, "optim": opt2, "f32": f32_back})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    dec_s, dec_parts = hist_delta(dec_h, h0)
    check(device_pack.LAUNCHES["slab_unpack"] > k2, "the huff restore launched no K2")
    differs = same_state((model, opt), (model2, opt2))
    check(differs is None and all(torch.equal(f32[k], f32_back[k]) for k in f32),
          f"huff restore: {differs or 'the f32 moments'} differ")
    print(f"stripe_codec huff: take {take_s:.4f} s of {nb + 2 * nbytes(f32['exp_avg'])} bytes; counters "
          f"{json.dumps(c)}; stored/raw per dtype {json.dumps(per_dtype)}; encode {enc_parts} parts, "
          f"{c['storage.codec.bytes_in'] / max(enc_s, 1e-9) / 1e9:.3f} GB/s a thread "
          f"({c['storage.codec.bytes_in']} bytes in {enc_s:.3f} s summed over parts); decode {dec_parts} "
          f"frames, {encoded_raw / max(dec_s, 1e-9) / 1e9:.3f} GB/s a thread ({encoded_raw} bytes in "
          f"{dec_s:.3f} s); restore {restore_s:.4f} s, bitwise, K2 launches "
          f"{device_pack.LAUNCHES['slab_unpack'] - k2}")
    shutil.rmtree(snap_dir)
    # the embedding alone in 40 MiB frames, read back into an f32 template
    # in 32 MiB tiles (K6), several of which straddle two frames
    emb = model.embed.weight.detach()
    snap_dir = os.path.join(root, "huff_embed")
    with knobs.override_codec("huff"), knobs.override_stripe_part_size_bytes(READ_FRAME_BYTES):
        tts.Snapshot.take(snap_dir, {"m": tts.StateDict(embed=emb)})
    table = tts.Snapshot(snap_dir).metadata.codecs["0/m/embed"]
    tile = READ_BUDGET
    straddle = sum(
        1 for lo in range(0, nbytes(emb), tile)
        if lo // READ_FRAME_BYTES != (min(lo + tile, nbytes(emb)) - 1) // READ_FRAME_BYTES
    )
    check(straddle > 0 and len(table["parts"]) > 1, "no tile of the budgeted read straddles two frames")
    tmpl = torch.zeros(emb.shape, dtype=torch.float32, device="cuda")
    k6 = device_pack.LAUNCHES["tile_update"]
    t0 = time.perf_counter()
    tts.Snapshot(snap_dir).read_object("0/m/embed", obj_out=tmpl, memory_budget_bytes=READ_BUDGET)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    launches = device_pack.LAUNCHES["tile_update"] - k6
    check(launches > 0 and torch.equal(tmpl, emb.float()), "the budgeted read of the encoded embedding differs")
    print(f"stripe_codec huff budgeted read: embedding {nbytes(emb)} bytes in {len(table['parts'])} frames "
          f"of {READ_FRAME_BYTES} raw bytes, stored {sum(table['parts'])}; {READ_BUDGET}-byte budget into "
          f"f32: {launches} K6 launches, {straddle} tiles straddle two frames, {read_s:.4f} s, equal to the "
          f"cast on the card")
    del tmpl
    shutil.rmtree(snap_dir)

    # 4. CODEC=zlib on the embedding and LM head (a fine-tune's frozen
    # tensors), an incremental take linking them, deep verify, a flipped
    # byte inside a frame
    frozen = {"frozen": tts.StateDict(embed=model.embed.weight.detach(), lm_head=model.lm_head.weight.detach())}
    base, inc = os.path.join(root, "zlib_base"), os.path.join(root, "zlib_inc")
    with knobs.override_codec("zlib"):
        t0 = time.perf_counter()
        tts.Snapshot.take(base, frozen)
        zlib_s = time.perf_counter() - t0
        before = tts.obs.counters()
        t0 = time.perf_counter()
        tts.Snapshot.take(inc, frozen, base=base)
        inc_s = time.perf_counter() - t0
    deduped = counter_delta(before, (tts.obs.BYTES_DEDUPED,))[tts.obs.BYTES_DEDUPED]
    bm, im = tts.Snapshot(base).metadata, tts.Snapshot(inc).metadata
    check(deduped == 2 * nbytes(model.embed.weight) == 524_288_000, f"incremental zlib take deduped {deduped} bytes")
    check(im.codecs == bm.codecs and set(im.codecs) == set(im.objects), "the linked objects' codec tables were not carried")
    for loc in im.codecs:
        check(os.stat(os.path.join(inc, loc)).st_ino == os.stat(os.path.join(base, loc)).st_ino,
              f"{loc} is not a hardlink of its base")
    t0 = time.perf_counter()
    res = tts.Snapshot(inc).verify(deep=True)
    verify_s = time.perf_counter() - t0
    check(res.ok and res.complete, f"deep verify of the zlib snapshot: {res}")
    loc, table = sorted(im.codecs.items())[0]
    bad = os.path.join(root, "zlib_bad")
    flip_byte_in_frame(inc, bad, loc, table)
    res_bad = tts.Snapshot(bad).verify(deep=True)
    check(not res_bad.ok, "deep verify passed a flipped byte inside a frame")
    print(f"stripe_codec zlib: embedding and LM head ({2 * nbytes(model.embed.weight)} bytes) stored "
          f"{sum(sum(t['parts']) for t in bm.codecs.values())} bytes in {zlib_s:.3f} s; incremental take "
          f"{inc_s:.3f} s, bytes_deduped {deduped}, tables carried; deep verify {verify_s:.3f} s {res}; "
          f"a flipped byte in a frame of {loc}: {res_bad}")
    for d in (base, inc, bad):
        shutil.rmtree(d)

    # 5. faults at storage.fs.part.write: one transient, then permanent
    snap_dir = os.path.join(root, "fault")
    before = tts.obs.counters()
    try:
        with knobs.override_retry_backoff_cap_s(0.05), \
                knobs.override_failpoints("storage.fs.part.write=eintr::1"):
            tts.Snapshot.take(snap_dir, app)
        fault = counter_delta(before, ("resilience.retries", "resilience.fs.retries",
                                       "resilience.failpoints_fired", *names))
        md = tts.Snapshot(snap_dir).metadata
        parts = sum(len(stripe.plan_parts(rec[2], part)) for rec in md.objects.values() if rec[2] >= threshold)
        check(fault["resilience.retries"] == fault["resilience.fs.retries"] == 1
              and fault["resilience.failpoints_fired"] == 1,
              f"one transient part fault: {json.dumps(fault)}")
        check(fault["storage.stripe.parts_written"] == parts and fault["storage.stripe.aborts"] == 0,
              f"{fault['storage.stripe.parts_written']} parts written for {parts}")
        check(snapshot_digests(snap_dir) == ref_digests,
              "the take after a transient fault differs from the first take (digests)")
        shutil.rmtree(snap_dir)
        print(f"stripe_codec transient fault: committed after one retry, {parts} parts each written once "
              f"(the failed attempt sent none), every digest equal to the first take's; counters "
              f"{json.dumps(fault)}")
        failed = None
        with knobs.override_failpoints("storage.fs.part.write=io"):
            try:
                tts.Snapshot.take(snap_dir, app)
            except OSError as e:
                failed = e
        check(failed is not None, "a permanent part-write failure did not fail the take")
        check(not os.path.exists(os.path.join(snap_dir, ".snapshot_metadata")),
              "a failed take wrote .snapshot_metadata")
        check(not temp_files(snap_dir), f"a failed take left temp files {temp_files(snap_dir)}")
        print(f"stripe_codec permanent fault: the take raised {failed!r}; no .snapshot_metadata, no temp "
              f"file; fs breaker {resilience.get_breaker('fs').state} (reset after)")
    finally:
        resilience.release_hangs()
        resilience.reset_breakers()
    shutil.rmtree(root)
    del model2, opt2, f32, f32_back
    print(f"stripe_codec: codecs available {codec_mod.available_codecs()}")


TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "traces")
TRACE_COST_REPEATS = 1  # 2 until the continuous path came
# span name -> its label on an operation's critical path (a storage write
# or read whose parent is the operation itself, or no span on the async
# commit thread, is its metadata commit or read; the pipeline's own sit
# inside pipeline/io)
CRITICAL_LABELS = {
    "take/plan": "plan", "offload/eager": "offload", "pipeline/staging": "stage",
    "pipeline/io": "io", "pipeline/consume": "consume", "obs/publish": "record",
    "obs/write_obsrecord": "record", "obs/exchange_and_merge": "record",
    "restore/load_stateful": "load",
}


def critical_path(spans, start_ns, end_ns, root_id):
    """Partition [start_ns, end_ns] by which labelled spans are active:
    label set -> seconds, summing to the window exactly.  ``load`` (a
    restore key's whole span) shows only where nothing inside it runs."""
    events = []
    for s in spans:
        label = CRITICAL_LABELS.get(s.name)
        if s.name in ("storage/write", "storage/read") and s.parent_id in (root_id, None):
            label = "metadata"
        a, b = max(s.start_ns, start_ns), min(s.end_ns, end_ns)
        if label and s.end_ns and b > a:
            events += [(a, 1, label), (b, -1, label)]
    active, out, prev = {}, {}, start_ns
    for t, d, label in sorted(events) + [(end_ns, 0, None)]:
        if t > prev:
            on = sorted(k for k, c in active.items() if c > 0)
            key = "+".join(k for k in on if k != "load") or ("load" if on else "other")
            out[key] = out.get(key, 0) + t - prev
            prev = t
        if label:
            active[label] = active.get(label, 0) + d
    return {k: round(v / 1e9, 4) for k, v in sorted(out.items(), key=lambda kv: -kv[1])}


def report_trace(op, wall_s, root_name, phases, window=None):
    """Prints one traced operation: its wall seconds, the critical path of
    its root span (or of ``window``), the phase rollup, the span count and
    the 10 longest spans; writes its Perfetto JSON under ``TRACE_DIR``."""
    tracer = tts.obs.get_tracer()
    spans = tracer.spans()
    roots = [s for s in spans if s.name == root_name]
    check(len(roots) == 1, f"trace {op}: {len(roots)} {root_name!r} spans")
    root = roots[0]
    start_ns, end_ns = window or (root.start_ns, root.end_ns)
    cp = critical_path(spans, start_ns, end_ns, root.span_id)
    check(abs(sum(cp.values()) - (end_ns - start_ns) / 1e9) < 1e-3, f"trace {op}: the critical path does not add up")
    longest = sorted(spans, key=lambda s: s.duration_ns, reverse=True)[:10]
    os.makedirs(TRACE_DIR, exist_ok=True)
    out = os.path.join(TRACE_DIR, f"{op}.json")
    n = tts.obs.write_trace(out)
    json.load(open(out))  # parses
    print(f"trace {op}: wall {wall_s:.4f} s; critical path (s, adds up to {(end_ns - start_ns) / 1e9:.4f} s "
          f"of the {root_name} span{' to the durable commit' if window else ''}): {json.dumps(cp)}; "
          f"phases (summed over concurrent tasks): {phases}")
    print(f"trace {op}: {n} spans ({tracer.dropped} dropped); 10 longest: "
          + json.dumps([[s.name, round(s.duration_ns / 1e9, 4), s.attrs.get("path"), s.attrs.get("bytes")]
                        for s in longest]))
    print(f"trace {op}: perfetto {os.path.relpath(out)} {os.path.getsize(out)} bytes")
    tracer.reset()


def restore_legs(snap_dir, threads=16):
    """What the restore's read and consume phases are made of, on the
    snapshot's files (in the page cache): the largest files read at once
    on ``threads`` threads (the read concurrency) into fresh host buffers,
    as the restore reads, then again into the same, already-touched
    buffers, then into pinned ones; and the largest file copied to the
    card from a pageable and from a pinned buffer."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from torchsnapshot_tpu_torch.io_types import ReadIO
    from torchsnapshot_tpu_torch.storage.fs import FSStoragePlugin

    files = sorted(
        (os.path.relpath(os.path.join(r, f), snap_dir) for r, _, fs in os.walk(snap_dir) for f in fs
         if not f.startswith(".snapshot_")),
        key=lambda f: -os.path.getsize(os.path.join(snap_dir, f)),
    )[:threads]
    sizes = [os.path.getsize(os.path.join(snap_dir, f)) for f in files]
    storage = FSStoragePlugin(snap_dir)

    def read_all(bufs):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(lambda fb: storage.sync_read(ReadIO(path=fb[0], into=fb[1])), zip(files, bufs)))
        return time.perf_counter() - t0

    fresh = [np.empty(n, dtype=np.uint8) for n in sizes]
    fresh_s = read_all(fresh)
    touched_s = read_all(fresh)
    pinned = [torch.empty(n, dtype=torch.uint8, pin_memory=True) for n in sizes]
    pinned_s = read_all([p.numpy() for p in pinned])
    storage.sync_close()
    dev = torch.empty(sizes[0], dtype=torch.uint8, device="cuda")
    h2d = {}
    for label, host in (("pageable", torch.from_numpy(fresh[0])), ("pinned", pinned[0])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev.copy_(host, non_blocking=True)
        torch.cuda.synchronize()
        h2d[label] = time.perf_counter() - t0
        check(torch.equal(dev.cpu(), torch.from_numpy(fresh[0])), f"H2D from {label} memory differs")
    gb, one = sum(sizes) / 1e9, sizes[0] / 1e9
    print(f"restore legs: {len(files)} largest files ({sum(sizes)} bytes) read at once on {threads} threads "
          f"from the page cache into fresh host buffers {fresh_s:.4f} s ({gb / fresh_s:.3f} GB/s), into the "
          f"same buffers again {touched_s:.4f} s ({gb / touched_s:.3f} GB/s), into pinned buffers "
          f"{pinned_s:.4f} s ({gb / pinned_s:.3f} GB/s); one file of {sizes[0]} bytes to the card from "
          f"pageable memory {h2d['pageable']:.4f} s ({one / h2d['pageable']:.3f} GB/s), from pinned "
          f"{h2d['pinned']:.4f} s ({one / h2d['pinned']:.3f} GB/s)")


def phase_trace(cfg, model, opt, work):
    """With TRACE=1 (``knobs.override_trace``), on the serving state: a
    sync take, an async_take and its wait(), a restore into a zeroed
    model and optimizer, and a budgeted read_object of the embedding into
    an f32 CUDA template (K6).  Each prints its critical path, phases,
    longest spans and Perfetto file; each take's flight record must read
    back with bytes_written equal to the take's own counter delta.  Then
    the tracer's cost: sync takes under TRACE=0 and TRACE=1, 2 each in
    alternating order.  ``restore_legs`` times what the restore's phases
    are made of."""
    root = os.path.join(work, "trace")
    os.makedirs(root)
    knobs, agg, tracer = tts.knobs, tts.obs.aggregate, tts.obs.get_tracer()
    app = {"model": model, "optim": opt}
    nb = state_bytes(model, opt)
    model2, opt2 = deterministic_state(cfg, 3)
    zero_state(model2, opt2)

    def written():
        return tts.obs.counters().get(tts.obs.BYTES_WRITTEN, 0)

    with knobs.override_trace(1):
        for op in ("take", "async_take"):
            snap_dir = os.path.join(root, op)
            tracer.reset()
            os.sync()
            torch.cuda.synchronize()
            w0, t0 = written(), time.perf_counter()
            if op == "take":
                tts.Snapshot.take(snap_dir, app)
                window = None
            else:
                pending = tts.Snapshot.async_take(snap_dir, app)
                unblock_s = time.perf_counter() - t0
                pending.wait()
                commits = [s for s in tracer.spans() if s.name == "goodput/durable_commit"]
                first = min(s.start_ns for s in tracer.spans() if s.name == "async_take")
                window = (first, commits[-1].end_ns)
            wall_s = time.perf_counter() - t0
            rec = agg.read_obsrecord(snap_dir)
            check(rec["merged"]["counters"].get(tts.obs.BYTES_WRITTEN) == written() - w0 > 0,
                  f"{op}: the flight record's bytes_written is not the take's counter delta")
            report_trace(op, wall_s, op, phases_of(rec), window)
            if op == "async_take":
                gp = tts.obs.goodput.block()
                check(gp["time_to_unblock_s"] < gp["durability_lag_s"], "async_take was durable before it unblocked")
                print(f"trace async_take: goodput time to unblock {gp['time_to_unblock_s']} s (the call "
                      f"returned after {unblock_s:.4f} s), durability lag {gp['durability_lag_s']} s, "
                      f"overhead fraction {gp['overhead_fraction']}")
        k2 = device_pack.LAUNCHES["slab_unpack"]
        tracer.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tts.Snapshot(os.path.join(root, "take")).restore({"model": model2, "optim": opt2})
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        differs = same_state((model, opt), (model2, opt2))
        check(differs is None and device_pack.LAUNCHES["slab_unpack"] > k2,
              f"traced restore: {differs or 'no K2 launch'}")
        report_trace("restore", wall_s, "restore", phases_of(agg.last_record("restore")))
        del model2, opt2
        restore_legs(os.path.join(root, "take"))
        src = model.embed.weight.detach()
        template = torch.empty(src.shape, device="cuda")
        tracer.reset()
        before = agg.capture()
        k6 = device_pack.LAUNCHES["tile_update"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tts.Snapshot(os.path.join(root, "take")).read_object(
            "0/model/embed.weight", obj_out=template, memory_budget_bytes=READ_BUDGET)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        check(torch.equal(template, src.float()) and device_pack.LAUNCHES["tile_update"] > k6,
              "traced budgeted read: differs or launched no K6")
        report_trace("read_object", wall_s, "read_object",
                     json.dumps(agg.rank_payload(0, "read_object", before)["phases"], sort_keys=True))
    for op in ("take", "async_take"):
        shutil.rmtree(os.path.join(root, op))

    times = {0: [], 1: []}
    spans_per_take = []
    for rep in range(TRACE_COST_REPEATS):
        for trace in (0, 1) if rep % 2 == 0 else (1, 0):
            snap_dir = os.path.join(root, f"cost{rep}_{trace}")
            os.sync()
            with knobs.override_trace(trace):
                tracer.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tts.Snapshot.take(snap_dir, app)
                times[trace].append(time.perf_counter() - t0)
                if trace:
                    spans_per_take.append(len(tracer))
            tracer.reset()
            shutil.rmtree(snap_dir)
    line = []
    for trace in (0, 1):
        ts = sorted(times[trace])
        line.append(f"TRACE={trace} median {ts[len(ts) // 2]:.4f} s [{ts[0]:.4f}-{ts[-1]:.4f}], "
                    f"runs {[round(t, 4) for t in times[trace]]}")
    print(f"trace cost: sync take of {nb} bytes, {TRACE_COST_REPEATS} runs each in alternating order: "
          + "; ".join(line) + f"; spans recorded per traced take {spans_per_take}")
    shutil.rmtree(root)


def phase_attention(cfg, model):
    q, k, v = restored_layer0_qkv(cfg, model)
    with torch.no_grad():
        out = ring_attention(q, k, v, causal=True)
        want = dense_attention(q.float(), k.float(), v.float(), causal=True)
    torch.cuda.synchronize()
    err = float((out.float() - want).abs().max())
    check(bool(torch.isfinite(out).all()) and out.shape == q.shape, "ring attention output malformed")
    check(err <= 2e-2, f"ring attention vs dense: max abs err {err} beyond 2e-2")
    print(f"ring attention on restored layer0 (s={SEQ}): max abs err vs f32 dense {err:.3e}")


def restored_layer0_qkv(cfg, model):
    g = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab, (1, SEQ), device="cuda", generator=g)
    positions = torch.arange(SEQ, device="cuda").expand(tokens.shape)
    layer = model.layer0
    with torch.no_grad():
        return layer.attn.qkv(layer.norm1(model.embed(tokens)), positions)


def phase_ring_gradient(cfg, model):
    """The gradient of a loss through bf16 ring attention (K3 forward,
    K4/K5 backward) against f32 dense attention's autograd gradient."""
    q, k, v = (t.detach().requires_grad_() for t in restored_layer0_qkv(cfg, model))
    g = torch.Generator(device="cuda").manual_seed(12)
    ct = torch.randn(q.shape, device="cuda", generator=g)
    grads = torch.autograd.grad((ring_attention(q, k, v, causal=True).float() * ct).sum(), (q, k, v))
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad((dense_attention(qf, kf, vf, causal=True) * ct).sum(), (qf, kf, vf))
    torch.cuda.synchronize()
    errs = []
    for name, a, b in zip("qkv", grads, want):
        check(a is not None and a.dtype == q.dtype and bool(torch.isfinite(a).all()),
              f"ring gradient d{name} missing or malformed")
        rel = float((a.float() - b).abs().max()) / float(b.abs().max())
        check(rel <= 3e-2, f"ring gradient d{name}: error {rel} beyond 3e-2 of the largest gradient")
        errs.append(f"d{name} {rel:.3e}")
    print(f"ring-attention gradient on restored layer0 (s={SEQ}) vs f32 dense autograd, "
          f"max error / max |gradient|: {', '.join(errs)}")


def host_clone_state(model, opt):
    """The state on the host: a device clone would sit beside the next
    step in memory the step's peak did not count."""
    return (
        {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()},
        {i: {k: v.to("cpu", copy=True) for k, v in st.items()} for i, st in opt.state_dict()["state"].items()},
    )


def step_peak(model, opt, tokens):
    """``train_step`` from an emptied allocator cache with the peaks reset:
    the step's own reserved footprint, fragmentation included, which the
    async take's device-copy budget reads."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loss = train_step(model, opt, tokens)
    torch.cuda.synchronize()
    return loss, torch.cuda.max_memory_reserved()


# one take each; (striped, 0, 0, striped) until the continuous path came
STREAM_SETTINGS = ("striped", "STRIPE_MIN_OBJECT_SIZE_BYTES=0")


def pressure_async_takes(model, opt, root):
    """``async_take`` of the training state with the device-copy budget
    pushed below half the smallest object at the stripe threshold (extra
    ballast grown until the budget async_take reads is that low), so
    every tensor takes a blocking pinned copy and the large leaves
    part-stream from those copies: at the default stripe knobs and at
    STRIPE_MIN_OBJECT_SIZE_BYTES=0 (``STREAM_SETTINGS``), each waited for
    and deleted.  Each snapshot's digests (every entry's crc32, every
    object's crc32, adler32 and size) must equal those of a sync take of
    the same state; the default runs must stream, the others must not."""
    from torchsnapshot_tpu_torch import knobs

    device = torch.device("cuda", torch.cuda.current_device())
    threshold = knobs.get_stripe_min_object_size_bytes()
    leaf = min(nbytes(t) for t in model.state_dict().values() if nbytes(t) >= threshold)
    extra = []
    for _ in range(400):
        if host_offload.device_copy_budget_bytes(device) < leaf // 2:
            break
        extra.append(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
    budget = host_offload.device_copy_budget_bytes(device)
    check(budget < leaf // 2, f"the device-copy budget stayed at {budget} bytes")
    app = {"model": model, "optim": opt}
    ref_dir = os.path.join(root, "pressure_ref")
    tts.Snapshot.take(ref_dir, app)
    ref = snapshot_digests(ref_dir)
    shutil.rmtree(ref_dir)
    runs = {label: {"unblock": [], "lag": [], "streamed": 0} for label in STREAM_SETTINGS}
    for i, label in enumerate(STREAM_SETTINGS):
        snap_dir = os.path.join(root, f"pressure{i}")
        before = tts.obs.counters()
        with knobs.override_stripe_min_object_size_bytes(threshold if label == "striped" else 0):
            t0 = time.perf_counter()
            pending = tts.Snapshot.async_take(snap_dir, app)
            unblock_s = time.perf_counter() - t0
            offload = dict(host_offload.LAST_OFFLOAD_STATS)
            pending.wait()
            lag_s = time.perf_counter() - t0
        streamed = counter_delta(before, (tts.obs.STRIPE_STREAMED_WRITES,))[tts.obs.STRIPE_STREAMED_WRITES]
        check((streamed > 0) == (label == "striped"), f"pressure run {i} ({label}): {streamed} streamed writes")
        check(snapshot_digests(snap_dir) == ref, f"pressure run {i} ({label}): digests differ from the sync take's")
        runs[label]["unblock"].append(unblock_s)
        runs[label]["lag"].append(lag_s)
        runs[label]["streamed"] += streamed
        print(f"stripe_codec streamed async_take run {i} ({label}): unblock {unblock_s:.4f} s, to commit "
              f"{lag_s:.4f} s, device copies {offload['device_copy_bytes']} bytes, blocking host copies "
              f"{offload['blocking_host_bytes']} bytes, streamed writes "
              f"{streamed}, goodput {json.dumps(tts.obs.goodput.block())}")
        shutil.rmtree(snap_dir)
    del extra
    for label in ("striped", "STRIPE_MIN_OBJECT_SIZE_BYTES=0"):
        r = runs[label]
        print(f"stripe_codec streamed async_take {label}: device-copy budget {budget} bytes (below half of "
              f"{leaf}); unblock {median_range(r['unblock'])}; durability lag {median_range(r['lag'])}; "
              f"streamed writes {r['streamed']}; digests equal to a sync take's")


def phase_resumable_training(cfg, root):
    """train_step at s = 2048 on a batch whose activations fill most of
    the card, async_take, the next train_step while the snapshot drains,
    restore into a differently seeded state, resume bitwise."""
    g = torch.Generator(device="cuda").manual_seed(21)
    batch = lambda n: torch.randint(0, cfg.vocab, (n, SEQ + 1), device="cuda", generator=g)  # noqa: E731
    model, opt = make_train_state(cfg, seed=0, device="cuda")
    train_step(model, opt, batch(1))  # AdamW's moments exist from here on
    nb = state_bytes(model, opt)
    # the step's peak at 4 and 8 sequences, where activations outweigh
    # the optimizer's temporaries, gives its footprint per sequence
    _, peak4 = step_peak(model, opt, batch(4))
    _, peak8 = step_peak(model, opt, batch(8))
    per_seq = (peak8 - peak4) // 4
    check(per_seq > 0, f"the step's peak does not grow with the batch ({peak4}, {peak8})")
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    capacity = free + torch.cuda.memory_reserved()
    # Aim the step's peak where half of the state's device copies fit
    # beside the next step, so both kinds of copy run: as many sequences
    # as fit under that peak, and a ballast tensor (memory the process
    # holds for something else) for the rest of the way, first short of
    # it by 2 GB, then corrected by what the linear estimate missed.
    target = capacity - int(total * host_offload.HEADROOM_FRACTION) - nb // 2
    n_seq = 8 + (target - peak8) // per_seq
    check(n_seq >= 8, f"the card holds too little for the training phase ({capacity} bytes)")
    batch_a, batch_b = batch(n_seq), batch(n_seq)
    ballast_bytes = max(0, target - peak8 - (n_seq - 8) * per_seq - 2 * 10**9)
    ballast = torch.empty(ballast_bytes, dtype=torch.uint8, device="cuda")
    _, first_peak = step_peak(model, opt, batch_a)
    ballast_bytes = max(0, ballast_bytes + target - first_peak)
    del ballast
    torch.cuda.empty_cache()  # the new ballast takes a segment of its own
    ballast = torch.empty(ballast_bytes, dtype=torch.uint8, device="cuda")
    # the allocator's high-water mark over two steps, as a loop that never
    # resets it keeps it: what the take's budget reads
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        train_step(model, opt, batch_a)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_reserved()
    print(f"resumable training: reserved step peaks {peak4} (4 sequences), {peak8} (8), {first_peak} "
          f"({n_seq}, short of the target), {peak} (two steps of {n_seq}, ballast {ballast_bytes}); "
          f"target {target}")
    params_at_take, opt_at_take = host_clone_state(model, opt)
    # what async_take's own budget will read
    budget = host_offload.device_copy_budget_bytes(torch.device("cuda", torch.cuda.current_device()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = tts.Snapshot.async_take(
        root, {"model": model, "optim": opt, "rng": tts.RNGState(), "meta": tts.StateDict(step=1)}
    )
    unblock_s = time.perf_counter() - t0
    offload = dict(host_offload.LAST_OFFLOAD_STATS)
    torch.cuda.reset_peak_memory_stats()  # the next step's peaks, the copies' pool included
    loss_b = train_step(model, opt, batch_b)  # changes the state in place
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0 - unblock_s
    drained_during_step = pending.done()
    step_peak_with_copies = torch.cuda.max_memory_reserved()
    t1 = time.perf_counter()
    pending.wait()
    wait_s = time.perf_counter() - t1
    total_s = time.perf_counter() - t0
    print(f"async_take phases (flight record): {phases_of(tts.obs.aggregate.read_obsrecord(root))}")
    pressure_async_takes(model, opt, os.path.dirname(root))
    del model, opt, ballast, pending
    gc.collect()
    live = sum(host_offload._LIVE_COPY_BYTES.values())
    check(live == 0, f"{live} bytes of device copies still live after wait()")
    torch.cuda.empty_cache()

    model2, opt2 = make_train_state(cfg, seed=1, device="cuda")
    train_step(model2, opt2, batch(1))
    meta2 = tts.StateDict(step=0)
    tts.Snapshot(root).restore({"model": model2, "optim": opt2, "rng": tts.RNGState(), "meta": meta2})
    for name, t in model2.state_dict().items():
        check(torch.equal(t.cpu(), params_at_take[name]), f"resumed tensor {name} differs from the clone")
    for i, st in opt2.state_dict()["state"].items():
        for k, v in st.items():
            check(torch.equal(v.cpu(), opt_at_take[i][k]), f"resumed optimizer state {i}/{k} differs")
    check(meta2["step"] == 1, "meta step not restored")
    loss_b2 = train_step(model2, opt2, batch_b)
    check(torch.equal(loss_b2, loss_b), f"resumed loss {float(loss_b2)!r} != {float(loss_b)!r}")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    train_step(model2, opt2, batch_b)  # the same step with no snapshot draining
    torch.cuda.synchronize()
    lone_step_s = time.perf_counter() - t1
    print(f"resumable training: batch {n_seq} x {SEQ} tokens; allocator capacity {capacity} bytes of "
          f"{total}; reserved step peak {peak} bytes ({per_seq} per sequence); "
          f"device-copy budget {budget} bytes; reserved peak of the next step beside the copies "
          f"{step_peak_with_copies} bytes")
    print(f"resumable training: state {nb} bytes; async_take unblocked in {unblock_s:.4f} s "
          f"(device copies {offload['device_copy_bytes']} bytes, host copies "
          f"{offload['host_copy_bytes']} bytes, blocking host copies {offload['blocking_host_bytes']} "
          f"bytes); next train_step {step_s:.4f} s beside the drain (snapshot done by then: "
          f"{drained_during_step}), the same step alone {lone_step_s:.4f} s; "
          f"wait() {wait_s:.3f} s; async_take to commit {total_s:.3f} s ({nb / total_s / 1e9:.3f} GB/s); "
          f"step loss {float(loss_b)!r} equal bitwise after restore")
    t0 = time.perf_counter()
    pinned = torch.empty(nb, dtype=torch.uint8, pin_memory=True)
    pin_alloc_s = time.perf_counter() - t0
    del pinned
    print(f"for comparison: allocating {nb} bytes of pinned host memory takes {pin_alloc_s:.3f} s")


def budgeted_read(snap, path, template, want, label):
    """One ``read_object`` with ``READ_BUDGET``; checks the result bitwise
    and prints its tiles, seconds, K6 launches, the pinned tile high-water
    mark and the rise in allocated device memory."""
    tiles0 = tts.obs.counters().get(tts.obs.TILES_READ, 0)
    k6_0 = device_pack.LAUNCHES["tile_update"]
    pinned_gauge().reset_max()
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = snap.read_object(path, obj_out=template, memory_budget_bytes=READ_BUDGET, device=want.device)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rise = torch.cuda.max_memory_allocated() - alloc0
    tiles = tts.obs.counters().get(tts.obs.TILES_READ, 0) - tiles0
    k6 = device_pack.LAUNCHES["tile_update"] - k6_0
    hw = pinned_gauge().max
    check(template is None or out is template, f"{label}: the template was not filled in place")
    check(out.dtype == want.dtype and out.device == want.device and torch.equal(out, want),
          f"{label}: the result differs from the source")
    check(hw <= 2 * READ_BUDGET, f"{label}: {hw} bytes of pinned tiles beyond the budget and one tile")
    nb = want.numel() * want.element_size()
    print(f"budgeted read {label}: {tiles} tiles, {dt:.4f} s ({nb / dt / 1e9:.3f} GB/s of result), "
          f"K6 launches {k6}, pinned tile high water {hw} bytes (budget {READ_BUDGET}), "
          f"device memory rise {rise} bytes")
    return out, k6


def phase_budgeted_reads(model, work, snap_dir):
    """read_object of the embedding and the LM head with a 32 MiB budget
    out of the serving path's snapshot, and of the embedding chunked (64
    MiB chunks): into bf16 CUDA templates (identity: copies only), f32
    CUDA templates (K6), no template (a fresh CUDA tensor) and CPU
    templates; again under VERIFY_ON_RESTORE=1, plus a corrupted copy of
    the chunked snapshot that must raise, leaving the template usable."""
    chunked_dir = os.path.join(work, "chunked")
    with tts.knobs.override_max_chunk_size_bytes(64 << 20):
        tts.Snapshot.take(chunked_dir, {"emb": tts.StateDict(embed=model.embed.weight.detach())})
    snap, chunked = tts.Snapshot(snap_dir), tts.Snapshot(chunked_dir)
    check(type(chunked.metadata.manifest["0/emb/embed"]).__name__ == "ChunkedArrayEntry",
          "the chunked snapshot's embedding is not chunked")
    sources = (
        ("embedding", snap, "0/model/embed.weight", model.embed.weight.detach()),
        ("LM head", snap, "0/model/lm_head.weight", model.lm_head.weight.detach()),
        ("chunked embedding", chunked, "0/emb/embed", model.embed.weight.detach()),
    )
    for name, sn, path, src in sources:
        budgeted_read(sn, path, torch.empty_like(src), src, f"{name} -> bf16 CUDA template")
        _, k6 = budgeted_read(sn, path, torch.empty(src.shape, device="cuda"), src.float(),
                              f"{name} -> f32 CUDA template")
        check(k6 > 0, f"{name}: the read into an f32 template launched no K6")
        budgeted_read(sn, path, None, src, f"{name} -> no template (fresh CUDA tensor)")
        budgeted_read(sn, path, torch.empty(src.shape, dtype=src.dtype), src.cpu(), f"{name} -> CPU template")
    src = model.embed.weight.detach()
    f32 = torch.empty(src.shape, device="cuda")
    with tts.knobs.override_verify_on_restore(True):
        for name, sn, path in (("embedding", snap, "0/model/embed.weight"),
                               ("chunked embedding", chunked, "0/emb/embed")):
            budgeted_read(sn, path, f32, src.float(), f"{name} -> f32 CUDA template, VERIFY_ON_RESTORE=1")
        budgeted_read(chunked, "0/emb/embed", None, src, "chunked embedding -> no template, VERIFY_ON_RESTORE=1")
        corrupt_dir = os.path.join(work, "corrupt")
        shutil.copytree(chunked_dir, corrupt_dir)
        victim = max((os.path.join(r, f) for r, _, fs in os.walk(corrupt_dir) for f in fs
                      if f != ".snapshot_metadata"), key=os.path.getsize)
        with open(victim, "r+b") as f:
            f.seek(os.path.getsize(victim) // 2)
            b = f.read(1)
            f.seek(os.path.getsize(victim) // 2)
            f.write(bytes([b[0] ^ 0x40]))
        try:
            tts.Snapshot(corrupt_dir).read_object("0/emb/embed", obj_out=f32, memory_budget_bytes=READ_BUDGET)
        except RuntimeError as e:
            check("crc32" in str(e), f"the corrupted read raised something else: {e}")
            print(f"budgeted read of a corrupted copy ({os.path.basename(victim)}, one byte flipped) "
                  f"raised: {str(e)[:160]}")
        else:
            raise RuntimeError("check failed: a corrupted payload read back under VERIFY_ON_RESTORE=1")
        budgeted_read(chunked, "0/emb/embed", f32, src.float(),
                      "chunked embedding -> the same f32 template after the failed read")
    print(f"budgeted reads: tile misses {json.dumps(misses(tts.obs.READ_TILE_MISSES))}")
    shutil.rmtree(chunked_dir)
    shutil.rmtree(corrupt_dir)


def deterministic_state(cfg, seed):
    """The full-width model from ``seed`` and its AdamW after one step on
    gradients drawn from ``seed`` (elementwise work only, so every
    process builds the same bits)."""
    model, opt = make_train_state(cfg, seed=seed, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    for p in model.parameters():
        p.grad = (torch.randn(p.shape, device="cuda", generator=g) * 1e-3).to(p.dtype)
    opt.step()
    opt.zero_grad(set_to_none=True)
    return model, opt


def same_state(a, b):
    (m1, o1), (m2, o2) = a, b
    for (name, x), y in zip(m1.state_dict().items(), m2.state_dict().values()):
        if not (x.dtype == y.dtype and torch.equal(x, y)):
            return f"model tensor {name}"
    s1, s2 = o1.state_dict(), o2.state_dict()
    for i, st in s1["state"].items():
        for k, v in st.items():
            if not torch.equal(v, s2["state"][i][k]):
                return f"optimizer state {i}/{k}"
    return None


def many_ranks_child(rank, world, port, root):
    """One rank of the many_ranks path (see ``phase_many_ranks``); prints
    one ``many_ranks result`` JSON line and exits non-zero on a failure."""
    import torch.distributed as dist

    from torchsnapshot_tpu_torch.resilience.abort import SnapshotAbortedError

    if not torch.cuda.is_available():
        print("many_ranks child: no CUDA device", file=sys.stderr)
        return 2
    # gloo is initialized only for its TCPStore, which the snapshots'
    # coordinator uses; no collective runs
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    coord = tts.get_default_coordinator()
    check(isinstance(coord, tts.TorchStoreCoordinator), f"default coordinator is {type(coord).__name__}")
    cfg = TransformerConfig(n_layers=MANY_RANKS_LAYERS)
    model, opt = deterministic_state(cfg, seed=0)
    mine = tts.StateDict(t=torch.full((1 << 20,), float(rank), device="cuda"), rank=rank)
    rng = tts.RNGState()
    rng_at_take = rng.state_dict()
    app = {"model": tts.Replicated(model), "optim": tts.Replicated(opt), "mine": mine, "rng": rng}
    repl_bytes = state_bytes(model, opt)
    for table in (device_pack.LAUNCHES,):
        for k in table:
            table[k] = 0
    out = {"rank": rank, "replicated_bytes": repl_bytes}

    def written():
        return tts.obs.counters().get(tts.obs.BYTES_WRITTEN, 0)

    sync_dir, async_dir, fail_dir = (os.path.join(root, n) for n in ("sync", "async", "failed"))
    torch.cuda.synchronize()
    w0, t0 = written(), time.perf_counter()
    tts.Snapshot.take(sync_dir, app)
    out["take_s"], out["take_bytes"] = time.perf_counter() - t0, written() - w0
    share = out["take_bytes"] / repl_bytes
    check(0.4 <= share <= 0.6, f"rank {rank} wrote {share:.3f} of the replicated bytes")

    model2, opt2 = deterministic_state(cfg, seed=1)
    mine2 = tts.StateDict(t=torch.zeros(1 << 20, device="cuda"), rank=-1)
    torch.manual_seed(1234)  # moves the RNG streams off their state at the take
    t0 = time.perf_counter()
    tts.Snapshot(sync_dir).restore(
        {"model": tts.Replicated(model2), "optim": tts.Replicated(opt2), "mine": mine2, "rng": rng}
    )
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    diff = same_state((model, opt), (model2, opt2))
    check(diff is None, f"rank {rank}: restored {diff} differs")
    check(torch.equal(mine2["t"], mine["t"]) and mine2["rank"] == rank, f"rank {rank}: per-rank state differs")
    check(torch.equal(rng.state_dict()["torch"], rng_at_take["torch"]), f"rank {rank}: RNG state not restored")
    del model2, opt2

    t0 = time.perf_counter()
    pending = tts.Snapshot.async_take(async_dir, app)
    out["async_unblock_s"] = time.perf_counter() - t0
    pending.wait()
    out["async_commit_s"] = time.perf_counter() - t0
    coord.barrier()
    check(os.path.exists(os.path.join(async_dir, ".snapshot_metadata")), "async take left no metadata")

    import torchsnapshot_tpu_torch.snapshot as snapmod
    from torchsnapshot_tpu_torch.storage.fs import FSStoragePlugin

    class FailingWrites(FSStoragePlugin):
        async def write(self, write_io):
            raise OSError(f"rank {rank}: injected storage failure")

    real = snapmod.url_to_storage_plugin
    if rank == 1:
        snapmod.url_to_storage_plugin = lambda p: FailingWrites(root=p)
    t0 = time.perf_counter()
    try:
        tts.Snapshot.take(fail_dir, app)
    except SnapshotAbortedError as e:
        out["failure"] = f"SnapshotAbortedError: {str(e)[:120]}"
        check(rank != 1, "the failing rank raised an abort, not its own error")
    except OSError as e:
        out["failure"] = f"OSError: {e}"
        check(rank == 1, f"rank {rank} raised the injected error")
    else:
        raise RuntimeError(f"check failed: rank {rank}'s take did not fail")
    finally:
        snapmod.url_to_storage_plugin = real
    out["failure_s"] = time.perf_counter() - t0
    check(out["failure_s"] < 10, f"rank {rank} took {out['failure_s']:.1f} s to raise")
    coord.barrier()  # outside the abort scope: both ranks are done
    check(not os.path.exists(os.path.join(fail_dir, ".snapshot_metadata")), "a failed take wrote metadata")
    out["launches"] = dict(device_pack.LAUNCHES)
    print("many_ranks result " + json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


SHARD_BOX_BYTES = 64 << 20  # MAX_SHARD_SIZE_BYTES on the sharded path


def spawn_ranks(flag, root, world=2, timeout_s=300, expect_rc=None):
    """Start this script ``world`` times as ``flag <rank> <world> <port>
    <root>``; returns each child's JSON result (the line starting with
    ``flag``'s word and ``result``), in rank order.  A child whose exit
    code is not 0 (or ``expect_rc[rank]``) fails the path."""
    return finish_ranks(start_ranks(flag, root, world), timeout_s, expect_rc)


def start_ranks(flag, root, world=2, gated=False):
    """``spawn_ranks``'s start: the children run while this process goes
    on; ``finish_ranks`` waits for them (``stop_ranks`` kills them).
    ``gated``: each child reaches the card, then waits for
    ``finish_ranks`` before it starts its work, so a path can start its
    children while the path before it runs."""
    port = free_port()
    os.makedirs(root, exist_ok=True)
    gate = os.path.join(root, f"{flag.strip('-')}.gate") if gated else None
    env = {**os.environ, CHILD_GATE_ENV: gate} if gated else None
    # each child writes to a file: a pipe the parent is not reading could
    # fill and stall a child while its peer waits for it
    logs = [open(os.path.join(root, f"{flag.strip('-')}{r}.log"), "w+") for r in range(world)]
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, str(r), str(world), str(port), root],
            stdout=logs[r], stderr=subprocess.STDOUT, text=True, env=env,
        )
        for r in range(world)
    ]
    return {"flag": flag, "world": world, "logs": logs, "procs": procs, "gate": gate}


CHILD_GATE_ENV = "CHIP_SMOKE_CHILD_GATE"
CHILD_GATE_DEADLINE_S = 1200


def wait_child_gate():
    """In a child started gated: reach the card, then wait for the gate."""
    gate = os.environ.get(CHILD_GATE_ENV)
    if not gate or not torch.cuda.is_available():
        return
    torch.zeros(1, device="cuda")
    deadline = time.monotonic() + CHILD_GATE_DEADLINE_S
    while not os.path.exists(gate):
        check(time.monotonic() < deadline, "the parent never released this child")
        time.sleep(0.01)


def stop_ranks(job):
    for p in job["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()


def finish_ranks(job, timeout_s=300, expect_rc=None):
    flag, world, logs, procs = job["flag"], job["world"], job["logs"], job["procs"]
    if job["gate"]:
        open(job["gate"], "w").close()  # children started gated wait for this
    tag = f"{flag.strip('-').replace('-child', '').replace('-', '_')} result "
    try:
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        stop_ranks(job)
    results = []
    for r, (p, f) in enumerate(zip(procs, logs)):
        f.seek(0)
        text = f.read()
        f.close()
        for line in text.splitlines():
            if line.startswith(tag):
                results.append(json.loads(line[len(tag):]))
        if p.returncode != (expect_rc or {}).get(r, 0):
            print(text[-4000:])
            raise RuntimeError(f"check failed: {flag} rank {r} exited {p.returncode}")
    check(len(results) == world, f"a {flag} child printed no result")
    return sorted(results, key=lambda x: x["rank"])


def start_clis(jobs, root):
    """Start ``python -m torchsnapshot_tpu_torch <argv>`` for every
    ``(name, argv)`` of ``jobs`` at once (each process reaches the card
    on its own, so starting them together keeps their start-ups off the
    script's clock); returns a handle for ``finish_clis``.  Output goes
    to files under ``root``: a pipe nobody reads could stall a process."""
    repo = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, argv in jobs:
        out = open(os.path.join(root, f"cli_{name}.out"), "w+")
        err = open(os.path.join(root, f"cli_{name}.err"), "w+")
        procs[name] = (subprocess.Popen([sys.executable, "-m", "torchsnapshot_tpu_torch", *argv], cwd=repo,
                                        stdout=out, stderr=err, text=True), out, err)
    return t0, procs


def finish_clis(handle, timeout_s=600):
    """Wait for the processes of ``start_clis``; name → (exit code,
    stdout, stderr, seconds from the common start to its exit)."""
    t0, procs = handle
    done = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(done) < len(procs):
            for name, (p, _, _) in procs.items():
                if name not in done and p.poll() is not None:
                    done[name] = time.perf_counter() - t0
            if time.monotonic() > deadline:
                raise RuntimeError(f"check failed: CLI processes {sorted(set(procs) - set(done))} still running")
            time.sleep(0.02)
    finally:
        for p, _, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    results = {}
    for name, (p, out, err) in procs.items():
        out.seek(0)
        err.seek(0)
        results[name] = (p.returncode, out.read(), err.read(), round(done[name], 2))
        out.close()
        err.close()
    return results


def phase_many_ranks(cfg, work):
    """Two processes on the one card, coordinated over a TCPStore on
    localhost: sync take at world 2 of a replicated model and optimizer
    plus per-rank state (each rank writes 40-60% of the replicated bytes),
    restore at world 2, async_take with its commit barrier, and a take in
    which rank 1's storage fails (both raise within 10 s, rank 0 a
    SnapshotAbortedError, no metadata); then a restore at world 1 here,
    bitwise for the replicated state.  Returns the children's launches."""
    root = os.path.join(work, "many_ranks")
    os.makedirs(root)
    results = spawn_ranks("--many-ranks-child", root)
    for res in results:
        print(f"many_ranks rank {res['rank']}: take {res['take_s']:.3f} s writing {res['take_bytes']} bytes "
              f"({res['take_bytes'] / res['replicated_bytes']:.3f} of the {res['replicated_bytes']} replicated "
              f"bytes); restore at world 2 {res['restore_s']:.3f} s; async_take unblocked in "
              f"{res['async_unblock_s']:.4f} s, committed in {res['async_commit_s']:.3f} s; failed take raised "
              f"after {res['failure_s']:.3f} s: {res['failure']}")
    model, opt = deterministic_state(cfg, seed=0)
    model2, opt2 = deterministic_state(cfg, seed=1)
    mine = tts.StateDict(t=torch.full((1 << 20,), -1.0, device="cuda"), rank=-1)
    t0 = time.perf_counter()
    tts.Snapshot(os.path.join(root, "sync")).restore(
        {"model": tts.Replicated(model2), "optim": tts.Replicated(opt2), "mine": mine}
    )
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    diff = same_state((model, opt), (model2, opt2))
    check(diff is None, f"world-1 restore: {diff} differs")
    check(mine["rank"] == 0 and bool((mine["t"] == 0).all()), "world-1 restore: rank 0's per-rank state differs")
    print(f"many_ranks: restore at world 1 of the world-2 snapshot {restore_s:.3f} s, bitwise")
    rec = tts.obs.aggregate.read_obsrecord(os.path.join(root, "sync"))
    written = sum(res["take_bytes"] for res in results)
    check(rec["ranks_reported"] == [0, 1] and rec["missing_ranks"] == [],
          f"the world-2 take's flight record reports ranks {rec['ranks_reported']}")
    check(rec["merged"]["counters"].get(tts.obs.BYTES_WRITTEN) == written,
          "the world-2 take's flight record disagrees with the ranks' bytes_written")
    print(f"many_ranks: the world-2 take's flight record: ranks {rec['ranks_reported']}, bytes_written "
          f"{written} (the ranks' own counters), straggler {json.dumps(rec['straggler'])}, phases by rank "
          f"{json.dumps({r: v['phases'] for r, v in rec['per_rank'].items()}, sort_keys=True)}")
    del model, opt, model2, opt2
    shutil.rmtree(root)
    launches = {}
    for res in results:
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


FLEET_PRIVATE_ELEMS = 2 << 20  # 4 MiB of bf16 each rank holds alone


class _RankView(tts.LocalCoordinator):
    """Reads a snapshot alone, as rank ``r`` of its ranks sees it."""

    def __init__(self, r):
        super().__init__()
        self._view_rank = r

    @property
    def rank(self):
        return self._view_rank


def _counter_snapshot():
    return dict(tts.obs.counters())


def fleet_child(rank, world, port, root):
    """One rank of the fleet path (see ``phase_fleet``); prints one
    ``fleet result`` JSON line.  Rank 1 prints it and then dies in the
    third take's commit (exit code 9); rank 0 exits 0."""
    import torch.distributed as dist

    from torchsnapshot_tpu_torch import transport as transport_mod
    from torchsnapshot_tpu_torch.topology import shared_read_locations
    from torchsnapshot_tpu_torch.transport.collective import BACKEND

    if not torch.cuda.is_available():
        print("fleet child: no CUDA device", file=sys.stderr)
        return 2
    # one slice of two hosts (the spec gives each rank a host of its own;
    # the host id knob says the same), no shared-host cache: fan-out runs
    os.environ["TORCHSNAPSHOT_TPU_TORCH_TOPOLOGY"] = "0,0"
    os.environ["TORCHSNAPSHOT_TPU_TORCH_TOPOLOGY_HOST_ID"] = f"host{rank}"
    os.environ.pop("TORCHSNAPSHOT_TPU_TORCH_CACHE_DIR", None)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    coord = tts.get_default_coordinator()
    cfg = TransformerConfig(n_layers=N_LAYERS)
    model, opt = deterministic_state(cfg, seed=0)
    mine = tts.StateDict(t=torch.full((FLEET_PRIVATE_ELEMS,), float(rank), dtype=torch.bfloat16, device="cuda"))
    app = {"model": tts.Replicated(model), "optim": tts.Replicated(opt), "mine": mine}
    repl_bytes = state_bytes(model, opt)
    for k in device_pack.LAUNCHES:
        device_pack.LAUNCHES[k] = 0
    out = {"rank": rank, "replicated_bytes": repl_bytes}
    take_dir, degraded_dir = os.path.join(root, "take"), os.path.join(root, "degraded")

    # 1. a take at world 2: the replicated writes spread over the hosts
    before = _counter_snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tts.Snapshot.take(take_dir, app)
    out["take_s"] = time.perf_counter() - t0
    d = counter_delta(before, (tts.obs.TOPOLOGY_REPLICATED_OBJECTS_WRITTEN, tts.obs.TOPOLOGY_REPLICATED_BYTES_WRITTEN,
                               tts.obs.BYTES_WRITTEN))
    out["share_objects"], out["share_bytes"], out["take_bytes"] = (
        d[tts.obs.TOPOLOGY_REPLICATED_OBJECTS_WRITTEN], d[tts.obs.TOPOLOGY_REPLICATED_BYTES_WRITTEN],
        d[tts.obs.BYTES_WRITTEN],
    )
    share = out["share_bytes"] / repl_bytes
    check(0.4 <= share <= 0.6, f"rank {rank} was elected for {share:.3f} of the replicated bytes")
    check(device_pack.LAUNCHES["slab_pack"] > 0, f"rank {rank}'s world-2 take launched no K1")

    # 2. the fan-out restore into differently seeded state, bitwise
    model2, opt2 = deterministic_state(cfg, seed=1)
    mine2 = tts.StateDict(t=torch.zeros(FLEET_PRIVATE_ELEMS, dtype=torch.bfloat16, device="cuda"))
    before = _counter_snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tts.Snapshot(take_dir).restore({"model": tts.Replicated(model2), "optim": tts.Replicated(opt2), "mine": mine2})
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    diff = same_state((model, opt), (model2, opt2))
    check(diff is None, f"rank {rank}: the fan-out restore's {diff} differs")
    check(torch.equal(mine2["t"], mine["t"]), f"rank {rank}: the fan-out restore's private state differs")
    check(device_pack.LAUNCHES["slab_unpack"] > 0, f"rank {rank}'s fan-out restore launched no K2")
    del model2, opt2, mine2
    out["fanout"] = counter_delta(before, (
        tts.obs.FANOUT_DURABLE_READS, tts.obs.FANOUT_DURABLE_GETS_SAVED, tts.obs.FANOUT_BYTES_REDISTRIBUTED,
        tts.obs.FANOUT_FALLBACKS, tts.obs.TRANSPORT_COLLECTIVE_OPS, tts.obs.TRANSPORT_COLLECTIVE_BYTES,
        tts.obs.TRANSPORT_KV_BYTES, tts.obs.TRANSPORT_FALLBACKS,
    ))
    out["engine"] = transport_mod.current_engine()
    out["backend"] = BACKEND
    manifest = tts.Snapshot(take_dir).metadata.manifest
    shared = shared_read_locations(manifest)
    out["shared_objects"] = len(shared)
    out["shared_bytes"] = sum(os.path.getsize(os.path.join(take_dir, p)) for p in shared)
    out["launches_before_death"] = dict(device_pack.LAUNCHES)
    coord.barrier()

    # 3. a take in which rank 1 dies where it would publish its commit
    # payload; rank 0 commits degraded by write takeover
    with tts.knobs.override_liveness_timeout_s(2.0), tts.knobs.override_liveness_interval_s(0.2):
        if rank == 1:
            def die(*a, **k):
                print("fleet result " + json.dumps(out), flush=True)
                os._exit(9)

            tts.snapshot._TakePlan.local_payload = die
        before = _counter_snapshot()
        t0 = time.perf_counter()
        snap = tts.Snapshot.take(degraded_dir, app)
        out["degraded_commit_s"] = time.perf_counter() - t0
    out["takeover"] = counter_delta(before, (
        tts.obs.TAKEOVER_OBJECTS, tts.obs.TAKEOVER_BYTES, tts.obs.TAKEOVER_DEGRADED_COMMITS,
        tts.obs.LIVENESS_DEAD_RANKS,
    ))
    out["degraded"] = snap.metadata.degraded
    out["launches"] = dict(device_pack.LAUNCHES)
    print("fleet result " + json.dumps(out), flush=True)
    # the peer is dead: no teardown of the process group can complete
    os._exit(0)


def phase_fleet(cfg, work):
    """Fleets: two processes on the card (gloo, a TCPStore on localhost),
    one slice of two hosts, the full-width state replicated plus 4 MiB of
    bf16 each rank holds alone.  A take at world 2 (each rank elected for
    40-60% of the replicated bytes), a fan-out restore at world 2 (each
    shared object read once for the slice, the other rank served by
    broadcasts on the collective engine, no fallback, bitwise), and a take
    in which rank 1 dies mid-commit: rank 0 commits degraded within 30 s,
    having re-written rank 1's elected share.  Then here: a restore at
    world 1 of the degraded snapshot (bitwise for the replicated state),
    rank 1's view refused with DegradedSnapshotError, verify degraded,
    a continuous mirror of rank 1 (``continuous/store.py``), repair,
    verify complete, the healed leaf read back whole and under a 1 MiB
    budget into an f32 template (K6).  Returns the children's launches."""
    from torchsnapshot_tpu_torch.continuous import ContinuousStore
    from torchsnapshot_tpu_torch.resilience.liveness import DegradedSnapshotError
    from torchsnapshot_tpu_torch.verify import verify_snapshot

    root = os.path.join(work, "fleet")
    os.makedirs(root)
    results = spawn_ranks("--fleet-child", root, expect_rc={1: 9})
    r0, r1 = results
    for res in results:
        print(f"fleet rank {res['rank']}: take at world 2 {res['take_s']:.3f} s, elected for "
              f"{res['share_objects']} replicated objects, {res['share_bytes']} bytes "
              f"({res['share_bytes'] / res['replicated_bytes']:.3f} of {res['replicated_bytes']}); fan-out restore "
              f"{res['restore_s']:.3f} s ({res['replicated_bytes'] / res['restore_s'] / 1e9:.2f} GB/s of the "
              f"replicated state), engine {res['engine']} over {res['backend']}, counters {json.dumps(res['fanout'])}")
    total = {k: r0["fanout"][k] + r1["fanout"][k] for k in r0["fanout"]}
    n_shared, shared_bytes = r0["shared_objects"], r0["shared_bytes"]
    check(r0["engine"] == r1["engine"] == "collective", f"the fan-out ran on {r0['engine']}/{r1['engine']}")
    check(total[tts.obs.TRANSPORT_FALLBACKS] == 0 and total[tts.obs.FANOUT_FALLBACKS] == 0,
          f"the fan-out degraded: {json.dumps(total)}")
    check(total[tts.obs.FANOUT_DURABLE_READS] == n_shared, f"{total[tts.obs.FANOUT_DURABLE_READS]} durable "
          f"reads of {n_shared} shared objects")
    check(total[tts.obs.FANOUT_DURABLE_GETS_SAVED] == n_shared, "durable reads saved differ from the shared objects")
    # each shared payload is counted once by its source's broadcast and
    # once by the sibling that keeps it (both packages count so)
    check(total[tts.obs.TRANSPORT_COLLECTIVE_BYTES] == 2 * shared_bytes,
          f"{total[tts.obs.TRANSPORT_COLLECTIVE_BYTES]} bytes on the collective engine, "
          f"not twice the {shared_bytes} shared bytes")
    print(f"fleet: {n_shared} shared objects ({shared_bytes} bytes) read once for the slice, "
          f"{total[tts.obs.TRANSPORT_COLLECTIVE_BYTES]} bytes on the collective engine, 0 fallbacks")
    tk = r0["takeover"]
    print(f"fleet: rank 1 died mid-commit; rank 0 committed degraded in {r0['degraded_commit_s']:.3f} s, "
          f"took over {tk[tts.obs.TAKEOVER_OBJECTS]} objects / {tk[tts.obs.TAKEOVER_BYTES]} bytes "
          f"(rank 1's elected share {r1['share_objects']} / {r1['share_bytes']}), degraded {json.dumps(r0['degraded'])}")
    check(r0["degraded_commit_s"] < 30, f"the degraded commit took {r0['degraded_commit_s']:.1f} s")
    check(tk[tts.obs.TAKEOVER_OBJECTS] == r1["share_objects"] and tk[tts.obs.TAKEOVER_BYTES] == r1["share_bytes"],
          "the takeover differs from rank 1's elected share")
    check(tk[tts.obs.TAKEOVER_DEGRADED_COMMITS] == 1, "no degraded commit was counted")
    check(sorted(r0["degraded"]) == ["mine/t"] and r0["degraded"]["mine/t"]["origin_rank"] == 1,
          f"degraded section {r0['degraded']}")

    snap_dir = os.path.join(root, "degraded")
    model, opt = deterministic_state(cfg, seed=0)
    model2, opt2 = deterministic_state(cfg, seed=1)
    mine = tts.StateDict(t=torch.zeros(FLEET_PRIVATE_ELEMS, dtype=torch.bfloat16, device="cuda"))
    t0 = time.perf_counter()
    tts.Snapshot(snap_dir).restore({"model": tts.Replicated(model2), "optim": tts.Replicated(opt2), "mine": mine})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    diff = same_state((model, opt), (model2, opt2))
    check(diff is None, f"world-1 restore of the degraded snapshot: {diff} differs")
    check(bool((mine["t"] == 0).all()), "world-1 restore: rank 0's private state differs")
    del model, opt, model2, opt2
    try:
        tts.Snapshot(snap_dir, coordinator=_RankView(1)).restore({"mine": tts.StateDict(t=torch.zeros(1))})
    except DegradedSnapshotError as e:
        refused = str(e)[:100]
    else:
        raise RuntimeError("check failed: rank 1's lost leaf restored from a degraded snapshot")
    res = verify_snapshot(tts.Snapshot(snap_dir), rank=1)
    check(res.ok and not res.complete and res.degraded == ["mine/t"] and not res.missing,
          f"verify of rank 1's view: {res}")
    lost = torch.full((FLEET_PRIVATE_ELEMS,), 1.0, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    ContinuousStore(os.path.join(root, "r1")).write_state(1, {"mine/t": lost})
    mirror_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    repaired = tts.Snapshot(snap_dir).repair_degraded([root])
    repair_s = time.perf_counter() - t0
    check(repaired == ["mine/t"], f"repair returned {repaired}")
    res = verify_snapshot(tts.Snapshot(snap_dir), deep=True, rank=1)
    check(res.ok and res.complete, f"verify after repair: {res}")
    healed = tts.Snapshot(snap_dir).read_object("1/mine/t")
    check(torch.equal(healed.cpu(), lost), "the healed leaf differs from rank 1's state")
    template = torch.zeros(FLEET_PRIVATE_ELEMS, dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    tts.Snapshot(snap_dir).read_object("1/mine/t", obj_out=template, memory_budget_bytes=1 << 20)
    torch.cuda.synchronize()
    budget_s = time.perf_counter() - t0
    check(torch.equal(template.cpu(), lost.float()), "the healed leaf read into f32 differs")
    print(f"fleet: world-1 restore of the degraded snapshot {restore_s:.3f} s, bitwise; rank 1's view refused "
          f"({refused}...); mirror written in {mirror_s:.3f} s, repair {repair_s:.3f} s, verify complete; the "
          f"healed leaf into f32 under 1 MiB {budget_s:.4f} s")
    shutil.rmtree(root)
    launches = {}
    for res in results:
        for k, v in res.get("launches", res["launches_before_death"]).items():
            launches[k] = launches.get(k, 0) + v
    return launches


def full_state(model, opt):
    """``"model/<name>"`` and ``"optim/<i>/<key>"`` → the tensors of a
    plain (unsharded) model and its optimizer: the reference a sharded
    restore is held against."""
    out = {f"model/{n}": p.detach() for n, p in model.named_parameters()}
    for i, st in opt.state_dict()["state"].items():
        out.update({f"optim/{i}/{k}": v for k, v in st.items()})
    return out


def local_of(full, dt):
    """The part of ``full`` that DTensor ``dt``'s local tensor holds."""
    from torchsnapshot_tpu_torch.preparers.sharded import box_at

    mesh = dt.device_mesh
    offsets, sizes = box_at(full.shape, mesh.shape, mesh.get_coordinate(), dt.placements)
    return full[tuple(slice(o, o + n) for o, n in zip(offsets, sizes))]


def check_restored(ref, params, opt_state, label):
    """Every restored parameter (name → tensor or DTensor) and optimizer
    state (index → key → tensor) bitwise equal to ``ref`` cast to its
    dtype (a DTensor's local tensor to its box of ``ref``)."""
    items = [(f"model/{n}", t) for n, t in params.items()]
    items += [(f"optim/{i}/{k}", t) for i, st in opt_state.items() for k, t in st.items()]
    check(len(items) == len(ref), f"{label}: {len(items)} tensors restored, {len(ref)} taken")
    for key, t in items:
        got, want = (t.to_local(), local_of(ref[key], t)) if hasattr(t, "device_mesh") else (t, ref[key])
        check(torch.equal(got, want.to(got.device, got.dtype)), f"{label}: {key} differs")


def sharded_templates(model, opt, mesh, place=list, dtype=None):
    """Zero DTensor templates of ``model``'s parameters and ``opt``'s state,
    each moment laid out as ``place(placements)`` of its parameter, in
    ``dtype`` (the state's own by default): ``model`` and ``optim`` app
    state for a restore."""
    from torchsnapshot_tpu_torch.parallel.mesh import distribute

    def zeros(t):
        return distribute(
            torch.zeros(t.shape, dtype=dtype or t.dtype, device="cuda"), mesh, place(t.placements)
        )

    sd = opt.state_dict()
    state = {
        i: {k: v.clone() if k == "step" else zeros(p) for k, v in sd["state"][i].items()}
        for i, p in enumerate(model.parameters())
    }
    model_t = tts.StateDict({n: zeros(p) for n, p in model.named_parameters()})
    return model_t, tts.StateDict(state=state, param_groups=sd["param_groups"])


def swapped(placements):
    """The transposed layout: Shard(0) ↔ Shard(1)."""
    from torch.distributed.tensor import Shard

    return [Shard(1 - p.dim) if p.is_shard() else p for p in placements]


def sharded_bytes(ref):
    return sum(nbytes(t) for k, t in ref.items() if not k.endswith("/step"))


def sharded_child(rank, world, port, root):
    """One rank of the sharded path's part 2 (see ``phase_sharded``);
    prints one ``sharded result`` JSON line, exits non-zero on a
    failure."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from torchsnapshot_tpu_torch.parallel.mesh import shard_train_state

    if not torch.cuda.is_available():
        print("sharded child: no CUDA device", file=sys.stderr)
        return 2
    # gloo: its TCPStore is the snapshots' coordinator; the take and the
    # restore run no collective of the mesh
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    coord = tts.get_default_coordinator()
    out = {"rank": rank}
    mesh = DeviceMesh("cuda", list(range(world)), mesh_dim_names=("tp",))
    out["mesh"] = mesh.device_type
    cfg = TransformerConfig(n_layers=N_LAYERS)
    ref = full_state(*deterministic_state(cfg, seed=0))
    model, opt = shard_train_state(*deterministic_state(cfg, seed=0), mesh)
    for k in device_pack.LAUNCHES:
        device_pack.LAUNCHES[k] = 0
    tile_misses = misses(tts.obs.READ_TILE_MISSES)
    written = tts.obs.counters().get(tts.obs.BYTES_WRITTEN, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tts.knobs.override_max_shard_size_bytes(SHARD_BOX_BYTES):
        tts.Snapshot.take(os.path.join(root, "world2"), {"model": model, "optim": opt}, coordinator=coord)
    out["take_s"] = time.perf_counter() - t0
    out["take_bytes"] = tts.obs.counters().get(tts.obs.BYTES_WRITTEN, 0) - written
    out["sharded_bytes"] = sharded_bytes(ref)
    share = out["take_bytes"] / out["sharded_bytes"]
    check(0.4 <= share <= 0.6, f"rank {rank} wrote {share:.3f} of the state's bytes")

    model_t, optim_t = sharded_templates(model, opt, mesh, place=swapped)
    del model, opt
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tts.Snapshot(os.path.join(root, "world2"), coordinator=coord).restore(
        {"model": model_t, "optim": optim_t}
    )
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    check_restored(ref, model_t, optim_t["state"], f"rank {rank} restore into the transposed layout")
    check(misses(tts.obs.READ_TILE_MISSES) == tile_misses, f"rank {rank}: a box missed the device path")
    out["launches"] = dict(device_pack.LAUNCHES)
    check(out["launches"]["slab_pack"] > 0, f"rank {rank}: the take at world 2 launched no K1")
    print("sharded result " + json.dumps(out), flush=True)
    coord.barrier()  # both ranks are done with the snapshot
    dist.destroy_process_group()
    return 0


def phase_sharded(cfg, work):
    """DTensor state at full width.  Part 1, in this process on a 1-rank
    CUDA mesh of shape (1, 1) named ("dp", "tp"): the model and AdamW
    laid out by ``parallel/mesh.py``'s rules, boxes subdivided at
    ``SHARD_BOX_BYTES``; sync take, async_take and ``wait()``, restores
    into bf16 DTensors (a fresh sharded model and optimizer), f32 DTensors
    (K6) and plain CUDA tensors, and a budgeted ``read_object`` of the
    embedding, all bitwise.  Part 2, two processes on the card over gloo,
    DTensors on a "tp" mesh of 2: a take at world 2 and a restore at
    world 2 into the transposed layout; then, here, the restore at world
    1 of that snapshot onto the 1-rank mesh and into plain tensors.
    Returns the children's launches."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from torchsnapshot_tpu_torch.parallel.mesh import shard_train_state

    root = os.path.join(work, "sharded")
    os.makedirs(root)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cuda", [[0]], mesh_dim_names=("dp", "tp"))
        ref = full_state(*deterministic_state(cfg, seed=0))
        model, opt = shard_train_state(*deterministic_state(cfg, seed=0), mesh)
        nb = sharded_bytes(ref)
        tile_misses = misses(tts.obs.READ_TILE_MISSES)
        sync_dir, async_dir = os.path.join(root, "sync"), os.path.join(root, "async")
        with tts.knobs.override_max_shard_size_bytes(SHARD_BOX_BYTES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            snap = tts.Snapshot.take(sync_dir, {"model": model, "optim": opt})
            take_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            pending = tts.Snapshot.async_take(async_dir, {"model": model, "optim": opt})
            unblock_s = time.perf_counter() - t0
            pending.wait()
            wait_s = time.perf_counter() - t0
        entry = snap.metadata.manifest["0/model/embed.weight"]
        check(len(entry.shards) == 4 and entry.spec == [None, "tp"] and entry.mesh_shape == [1, 1],
              f"the embedding's entry: {len(entry.shards)} boxes, spec {entry.spec}, mesh {entry.mesh_shape}")
        print(f"sharded: state {nb} bytes in DTensors on a (1, 1) cuda mesh; take {take_s:.3f} s "
              f"({nb / take_s / 1e9:.3f} GB/s); async_take unblocked in {unblock_s:.4f} s, wait() returned "
              f"{wait_s:.3f} s after the call; the embedding in {len(entry.shards)} boxes of "
              f"{SHARD_BOX_BYTES} bytes at most")
        del model, opt

        m2, o2 = shard_train_state(*deterministic_state(cfg, seed=1), mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tts.Snapshot(sync_dir).restore({"model": m2, "optim": o2})
        torch.cuda.synchronize()
        bf16_s = time.perf_counter() - t0
        check_restored(ref, dict(m2.named_parameters()), o2.state_dict()["state"], "restore into bf16 DTensors")
        model_t, optim_t = sharded_templates(m2, o2, mesh, dtype=torch.float32)
        del m2, o2
        k6 = device_pack.LAUNCHES["tile_update"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tts.Snapshot(async_dir).restore({"model": model_t, "optim": optim_t})
        torch.cuda.synchronize()
        f32_s = time.perf_counter() - t0
        k6 = device_pack.LAUNCHES["tile_update"] - k6
        check(k6 > 0, "the f32 restore launched no K6")
        check_restored(ref, model_t, optim_t["state"], "restore of the async snapshot into f32 DTensors")
        del model_t, optim_t
        plain_m, plain_o = deterministic_state(cfg, seed=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tts.Snapshot(sync_dir).restore({"model": plain_m, "optim": plain_o})
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        check_restored(ref, dict(plain_m.named_parameters()), plain_o.state_dict()["state"],
                       "restore into plain CUDA tensors")
        del plain_m, plain_o
        tiles0 = tts.obs.counters().get(tts.obs.TILES_READ, 0)
        pinned_gauge().reset_max()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb = snap.read_object("0/model/embed.weight", memory_budget_bytes=READ_BUDGET)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        tiles = tts.obs.counters().get(tts.obs.TILES_READ, 0) - tiles0
        hw = pinned_gauge().max
        check(emb.is_cuda and torch.equal(emb, ref["model/embed.weight"]), "budgeted read of the embedding differs")
        # its boxes split by rows, so its tiles land in place
        check(0 < hw <= 2 * READ_BUDGET, f"the sharded budgeted read held {hw} bytes of pinned tiles")
        print(f"sharded: restore into bf16 DTensors {bf16_s:.3f} s, into f32 DTensors {f32_s:.3f} s "
              f"({k6} K6 launches), into plain CUDA tensors {plain_s:.3f} s, all bitwise; budgeted read of "
              f"the embedding ({nbytes(emb)} bytes, budget {READ_BUDGET}): {tiles} row tiles, {read_s:.4f} s, "
              f"pinned tile high water {hw} bytes (row tiles landed in place)")
        del emb
        check(misses(tts.obs.READ_TILE_MISSES) == tile_misses,
              f"a box missed the device path: {misses(tts.obs.READ_TILE_MISSES)}")
        gc.collect()
        torch.cuda.empty_cache()

        results = spawn_ranks("--sharded-child", root)
        for res in results:
            check(res["mesh"] == "cuda", f"sharded rank {res['rank']} ran on a {res['mesh']} mesh")
            print(f"sharded rank {res['rank']} (DTensors on a {res['mesh']} mesh): take at world 2 "
                  f"{res['take_s']:.3f} s writing {res['take_bytes']} bytes ({res['take_bytes'] / res['sharded_bytes']:.3f} "
                  f"of the {res['sharded_bytes']} bytes of DTensor state); restore at world 2 into the "
                  f"transposed layout {res['restore_s']:.3f} s, bitwise")
        world2 = os.path.join(root, "world2")
        m3, o3 = shard_train_state(*deterministic_state(cfg, seed=1), mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tts.Snapshot(world2).restore({"model": m3, "optim": o3})
        torch.cuda.synchronize()
        w1_s = time.perf_counter() - t0
        check_restored(ref, dict(m3.named_parameters()), o3.state_dict()["state"], "world-1 restore onto the mesh")
        del m3, o3
        plain_m, plain_o = deterministic_state(cfg, seed=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tts.Snapshot(world2).restore({"model": plain_m, "optim": plain_o})
        torch.cuda.synchronize()
        w1_plain_s = time.perf_counter() - t0
        check_restored(ref, dict(plain_m.named_parameters()), plain_o.state_dict()["state"],
                       "world-1 restore into plain tensors")
        print(f"sharded: restore at world 1 of the world-2 snapshot onto the (1, 1) mesh {w1_s:.3f} s, "
              f"into plain CUDA tensors {w1_plain_s:.3f} s, bitwise")
        del plain_m, plain_o, ref
    finally:
        dist.destroy_process_group()
    shutil.rmtree(root)
    launches = {}
    for res in results:
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


LIFECYCLE_PRIORITY = ["model/embed*", "model/layer0.*"]
LIFECYCLE_REPEATS = 1  # 2 until the continuous path came
# phase_lifecycle's save seconds, printed beside cas_mmap's
LIFECYCLE_SAVE_S = {}
MMAP_REPEATS = 1  # restores per MMAP setting, alternating; 2 until the continuous path came


def fine_tune_state(cfg, seed):
    """The full-width model laid out as a fine-tune: the embedding and the
    LM head frozen (``requires_grad=False``, outside the optimizer), the
    layers trained by AdamW."""
    torch.manual_seed(seed)
    model = TransformerLM(cfg, device="cuda")
    for p in (model.embed.weight, model.lm_head.weight):
        p.requires_grad_(False)
    opt = torch.optim.AdamW([p for p in model.parameters() if p.requires_grad], lr=1e-4, weight_decay=0.01)
    return model, opt


def fine_tune_step(model, opt, tokens):
    opt.zero_grad(set_to_none=True)
    logits = model(tokens[:, :-1])
    loss = torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
    loss.backward()
    opt.step()
    return loss.detach()


def clone_state(model, opt, meta):
    return (
        {k: v.clone() for k, v in model.state_dict().items()},
        {i: {k: v.clone() for k, v in st.items()} for i, st in opt.state_dict()["state"].items()},
        dict(meta),
    )


def state_differs(saved, model, opt, meta):
    """The first tensor of ``(model, opt, meta)`` that is not bitwise the
    ``saved`` clone's, or None."""
    params, moments, meta0 = saved
    for name, v in model.state_dict().items():
        if not (v.dtype == params[name].dtype and torch.equal(v, params[name])):
            return f"model tensor {name}"
    for i, st in opt.state_dict()["state"].items():
        for k, v in st.items():
            if not torch.equal(v, moments[i][k]):
                return f"optimizer state {i}/{k}"
    return None if dict(meta) == meta0 else f"meta {dict(meta)} != {meta0}"


def spans_named(name):
    return [s for s in tts.obs.get_tracer().spans() if s.name == name]


def first_class_done(priority, model, snap):
    """Restores the snapshot's model into ``model`` with ``priority``
    (None: the default order), traced; returns (seconds from the
    restore's start to the end of the last consume of an object holding a
    member of the first class, seconds of the whole restore)."""
    manifest = snap.get_manifest()
    first = {
        loc
        for lpath, e in manifest.items()
        if fnmatch.fnmatch(lpath.split("/", 1)[1], LIFECYCLE_PRIORITY[0])
        for loc in [getattr(e, "location", None)] if loc
    }
    tracer = tts.obs.get_tracer()
    with tts.knobs.override_trace(1):
        tracer.reset()
        torch.cuda.synchronize()
        snap.restore({"model": model}, priority=priority)
        torch.cuda.synchronize()
        root = spans_named("restore")[-1]
        ends = [s.end_ns for s in spans_named("pipeline/consume") if s.attrs.get("path") in first]
    tracer.reset()
    check(ends, "no consume of the first priority class was traced")
    return (max(ends) - root.start_ns) / 1e9, (root.end_ns - root.start_ns) / 1e9


def phase_lifecycle(cfg, work):
    """``SnapshotManager`` on a fine-tune at full width (see the module
    docstring, path g): incremental saves under retention, resume, warm
    start, serving order, the checkpoint-precision transform, and
    inspection."""
    root = os.path.join(work, "lifecycle")
    mgr = tts.SnapshotManager(root, keep_last_n=2)
    model, opt = fine_tune_state(cfg, seed=31)
    meta = tts.StateDict(step=0)
    app = {"model": model, "optim": opt, "rng": tts.RNGState(), "meta": meta}
    g = torch.Generator(device="cuda").manual_seed(32)

    def batch():
        return torch.randint(0, cfg.vocab, (1, 129), device="cuda", generator=g)

    frozen = ("model/embed.weight", "model/lm_head.weight")
    frozen_bytes = sum(nbytes(model.get_parameter(p.split("/", 1)[1])) for p in frozen)

    def deduped():
        return tts.obs.counters().get(tts.obs.BYTES_DEDUPED, 0)

    # 1. incremental saves with retention: step 0 full (sync), step 1
    # incremental async, step 2 incremental sync (retention evicts 0)
    fine_tune_step(model, opt, batch())
    saved, times, dedup = {}, {}, {}
    deleted = []
    real_delete = FSStoragePlugin.delete

    async def recording_delete(plugin, path):
        deleted.append((plugin.root, path))
        return await real_delete(plugin, path)

    for step in range(3):
        if step:
            fine_tune_step(model, opt, batch())
        meta["step"] = step
        saved[step] = clone_state(model, opt, meta)
        d0 = deduped()
        FSStoragePlugin.delete = recording_delete
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if step == 1:
                handle = mgr.save(app, step=step, incremental=True, async_=True)
                unblock_s = time.perf_counter() - t0
                handle.wait()
            else:
                mgr.save(app, step=step, incremental=step > 0)
            times[step] = time.perf_counter() - t0
        finally:
            FSStoragePlugin.delete = real_delete
        dedup[step] = deduped() - d0
        # the frozen tensors' files: step 0's inodes, then links to them
        files = {lp: os.path.join(mgr.path_for_step(step), mgr.snapshot(step).get_manifest()[f"0/{lp}"].location)
                 for lp in frozen}
        if step == 0:
            inodes = {lp: os.stat(f).st_ino for lp, f in files.items()}
        else:
            check(all(os.stat(f).st_ino == inodes[lp] and os.stat(f).st_nlink >= 2 for lp, f in files.items()),
                  f"step {step}: the frozen tensors are not hardlinks of step 0's files")
            check(dedup[step] >= frozen_bytes,
                  f"step {step}: deduped {dedup[step]} < the frozen {frozen_bytes} bytes")
    step0 = mgr.path_for_step(0)
    gone = [p for r, p in deleted if r == step0]
    check(mgr.steps() == [1, 2] and not os.path.exists(step0), f"retention kept {mgr.steps()}")
    check(gone and gone[0] == ".snapshot_metadata", f"retention deleted {gone[:1]} of step 0 first")
    model1, opt1 = fine_tune_state(cfg, seed=33)
    fine_tune_step(model1, opt1, batch())
    zero_state(model1, opt1)
    meta1 = tts.StateDict(step=-1)
    mgr.snapshot(1).restore({"model": model1, "optim": opt1, "rng": tts.RNGState(), "meta": meta1})
    differs = state_differs(saved[1], model1, opt1, meta1)
    check(differs is None, f"step 1 after retention: {differs}")
    LIFECYCLE_SAVE_S.update(full=times[0], unblock=unblock_s, incremental_async=times[1],
                            incremental_sync=times[2])
    print(f"lifecycle saves: full (step 0, sync) {times[0]:.3f} s; incremental async (step 1) unblocked in "
          f"{unblock_s:.4f} s, committed in {times[1]:.3f} s; incremental sync (step 2) {times[2]:.3f} s; "
          f"deduped bytes {dedup[1]} and {dedup[2]} (the frozen tensors: {frozen_bytes}); retention deleted "
          f"step 0 ({len(gone)} deletes, .snapshot_metadata first), step 1 restores bitwise")

    # 2. resume: restore_latest into a zeroed model and optimizer
    k2 = device_pack.LAUNCHES["slab_unpack"]
    zero_state(model1, opt1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = mgr.restore_latest({"model": model1, "optim": opt1, "rng": tts.RNGState(), "meta": meta1})
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    differs = state_differs(saved[2], model1, opt1, meta1)
    check(step == 2 and differs is None, f"restore_latest: step {step}, {differs}")
    check(device_pack.LAUNCHES["slab_unpack"] > k2, "restore_latest launched no K2")
    tokens = batch()
    loss = fine_tune_step(model, opt, tokens)
    loss1 = fine_tune_step(model1, opt1, tokens)
    check(torch.equal(loss, loss1), f"resumed loss {loss1.item()} != {loss.item()}")
    print(f"lifecycle resume: restore_latest step {step} in {resume_s:.3f} s, bitwise; next loss "
          f"{loss.item()!r} equal bitwise; K2 launches {device_pack.LAUNCHES['slab_unpack'] - k2}")
    del model1, opt1

    # 3. warm start: the parameters only, into a fresh optimizer
    model3, opt3 = fine_tune_state(cfg, seed=34)
    fine_tune_step(model3, opt3, batch())
    fresh = {i: {k: v.clone() for k, v in st.items()} for i, st in opt3.state_dict()["state"].items()}
    mgr.snapshot(2).restore({"model": model3, "optim": opt3}, paths=["model/**"])
    params = saved[2][0]
    check(all(torch.equal(v, params[k]) for k, v in model3.state_dict().items()), "warm start: parameters differ")
    check(all(torch.equal(v, fresh[i][k]) for i, st in opt3.state_dict()["state"].items() for k, v in st.items()),
          "warm start: the optimizer state did not keep its fresh values")
    print("lifecycle warm start: restore(paths=['model/**']) restored the parameters bitwise; the optimizer "
          "kept its fresh state")

    # 4. serving order: the model restored with and without priority
    snap = mgr.snapshot(2)
    runs = {"priority": [], "default": []}
    for rep in range(LIFECYCLE_REPEATS):
        for kind in ("priority", "default") if rep % 2 == 0 else ("default", "priority"):
            runs[kind].append(first_class_done(LIFECYCLE_PRIORITY if kind == "priority" else None,
                                               model3, snap))
    check(all(torch.equal(v, params[k]) for k, v in model3.state_dict().items()), "serving restores differ")
    line = []
    for kind, rs in runs.items():
        line.append(f"{kind}: first class done at {[round(a, 4) for a, _ in rs]} s of restores "
                    f"{[round(b, 4) for _, b in rs]} s")
    print(f"lifecycle serving order ({LIFECYCLE_PRIORITY}, {LIFECYCLE_REPEATS} runs each, alternating; first "
          f"class = objects holding {LIFECYCLE_PRIORITY[0]}): " + "; ".join(line))
    del model3, opt3

    # 5. checkpoint precision: f32 moments (a mixed-precision master's:
    # the bf16 moments, each moved by a seeded fraction of its last bf16
    # place) written as bf16, restored into f32 templates whole and
    # through a budgeted read_object
    master = tts.StateDict({
        f"{i}.{k}": v.float() * (1 + (torch.rand(v.shape, device="cuda", generator=g) - 0.5) * 2 ** -8)
        for i, st in opt.state_dict()["state"].items()
        for k, v in st.items() if k in ("exp_avg", "exp_avg_sq")
    })
    ck = os.path.join(work, "lifecycle_bf16")

    def to_bf16(path, leaf):
        return leaf.to(torch.bfloat16) if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float32 else leaf

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tts.Snapshot.take(ck, {"master": master}, leaf_transform=to_bf16)
    take_s = time.perf_counter() - t0
    check(all(e.dtype == "bfloat16" for p, e in tts.Snapshot(ck).get_manifest().items() if hasattr(e, "dtype")),
          "the transform did not store bf16")
    want = {k: v.to(torch.bfloat16).float() for k, v in master.items()}
    dest = tts.StateDict({k: torch.zeros_like(v) for k, v in master.items()})
    tts.Snapshot(ck).restore({"master": dest})
    check(all(dest[k].dtype == torch.float32 and torch.equal(dest[k], want[k]) for k in want),
          "bf16 checkpoint restored into f32 differs from the bf16-rounded moments")
    check(any(not torch.equal(want[k], master[k]) for k in want), "the moments had no precision to lose")
    biggest = max(master, key=lambda k: master[k].numel())
    template = torch.zeros_like(master[biggest])
    k6 = device_pack.LAUNCHES["tile_update"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tts.Snapshot(ck).read_object(f"0/master/{biggest}", obj_out=template, memory_budget_bytes=READ_BUDGET)
    torch.cuda.synchronize()
    budget_s = time.perf_counter() - t0
    check(torch.equal(template, want[biggest]), "budgeted bf16 read into f32 differs")
    check(device_pack.LAUNCHES["tile_update"] > k6, "the budgeted cast read launched no K6")
    print(f"lifecycle precision: {sum(nbytes(v) for v in master.values())} bytes of f32 moments taken as bf16 in "
          f"{take_s:.3f} s; restored into f32 bitwise the bf16-rounded values; budgeted read of {biggest} "
          f"({nbytes(template)} bytes f32, budget {READ_BUDGET}) {budget_s:.4f} s, "
          f"{device_pack.LAUNCHES['tile_update'] - k6} K6 launches")
    shutil.rmtree(ck)
    del master, dest, want, template

    # 6. inspection: materialize, get_manifest, verify, the CLI
    step2 = mgr.path_for_step(2)
    snap = tts.Snapshot(step2)
    saved_flat = {}
    for key, sd in (("model", saved[2][0]), ("optim", {"state": saved[2][1]})):
        saved_flat.update(flatten(sd, prefix=key)[1])
    for where in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = snap.materialize(device=where)
        torch.cuda.synchronize()
        mat_s = time.perf_counter() - t0
        got_flat = {}
        for key in ("model", "optim"):
            sd = got[key] if key == "model" else {"state": got[key]["state"]}
            got_flat.update(flatten(sd, prefix=key)[1])
        bad = [p for p, v in saved_flat.items()
               if not (got_flat[p].device.type == where and torch.equal(got_flat[p].to(v.device), v))]
        check(not bad and got["meta"]["step"] == 2, f"materialize({where}) differs: {bad[:3]}")
        print(f"lifecycle materialize({where}): {len(got_flat)} tensors in {mat_s:.3f} s, equal to the state")
        del got, got_flat
    n_entries = len(snap.get_manifest())
    t0 = time.perf_counter()
    res = snap.verify(deep=True)
    verify_s = time.perf_counter() - t0
    check(res.ok and res.complete, f"deep verify: {res}")
    # a copy of step 2 whose files are hardlinks, but for one object of
    # its own with one byte flipped
    bad_dir = os.path.join(work, "lifecycle_corrupt")
    shutil.copytree(step2, bad_dir, copy_function=os.link)
    victim = snap.get_manifest()["0/model/layer1.mlp.w2.weight"].location
    os.remove(os.path.join(bad_dir, victim))
    shutil.copyfile(os.path.join(step2, victim), os.path.join(bad_dir, victim))
    with open(os.path.join(bad_dir, victim), "r+b") as f:
        f.seek(4097)
        b = f.read(1)
        f.seek(4097)
        f.write(bytes([b[0] ^ 0x20]))
    bad_res = tts.Snapshot(bad_dir).verify(deep=True)
    check(not bad_res.ok and [c[0] for c in bad_res.corrupt] == [victim], f"corrupted copy: {bad_res}")
    done = finish_clis(start_clis([(str(i), ["verify", path, "--deep"]) for i, path in enumerate((step2, bad_dir))],
                                  os.path.join(root, "cli")))
    cli = [(rc, out.strip()[:120], s_) for rc, out, _, s_ in (done["0"], done["1"])]
    check(cli[0][0] == 0 and cli[1][0] == 1, f"CLI verify exit codes {cli}")
    print(f"lifecycle inspection: get_manifest {n_entries} entries; verify(deep=True) {verify_s:.3f} s: {res}; "
          f"one flipped byte in {victim}: {str(bad_res)[:160]}; CLI verify --deep, both started together "
          f"(exit, output, s): {cli}")
    shutil.rmtree(bad_dir)
    shutil.rmtree(root)


def mount_of(path):
    """(mount point, filesystem type) holding ``path``, from /proc/mounts."""
    path = os.path.realpath(path)
    best = ("/", "?")
    with open("/proc/mounts") as f:
        for line in f:
            mnt, fstype = line.split()[1:3]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) and len(mnt) >= len(best[0]):
                best = (mnt, fstype)
    return best


def map_against_read(path):
    """One file to the card, page cache warm, best of 3 each: mapped
    (``mmap_read``, then the host-to-device copy straight from its pages)
    against read into a fresh buffer first (the copying restore's legs)."""
    import numpy as np

    from torchsnapshot_tpu_torch.storage.fs import mmap_read

    size = os.path.getsize(path)
    best = {}
    for label in ("mapped", "read", "mapped", "read", "mapped", "read"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if label == "mapped":
            host = mmap_read(path, None)
        else:
            host = np.empty(size, np.uint8)
            with open(path, "rb", buffering=0) as f:
                check(f.readinto(host) == size, f"short read of {path}")
        dev = torch.frombuffer(memoryview(host), dtype=torch.uint8).to("cuda")
        torch.cuda.synchronize()
        best[label] = min(best.get(label, 1e9), time.perf_counter() - t0)
        del host, dev
    return size, best


def cas_pool_keys(pool):
    return {f for _, _, files in os.walk(os.path.join(pool, "objects")) for f in files}


def phase_cas_mmap(cfg, work):
    """The chunk store on the fine-tune and mapped reads on the serving
    state (see the module docstring, path h)."""
    import zlib

    from torchsnapshot_tpu_torch import cas as cas_mod
    from torchsnapshot_tpu_torch import knobs
    from torchsnapshot_tpu_torch.io_types import is_mmap_backed

    root = os.path.join(work, "cas_mmap")
    pool = os.path.join(root, "cas")
    mgr = tts.SnapshotManager(root, keep_last_n=2, cas=True)
    model, opt = fine_tune_state(cfg, seed=41)
    meta = tts.StateDict(step=0)
    app = {"model": model, "optim": opt, "rng": tts.RNGState(), "meta": meta}
    g = torch.Generator(device="cuda").manual_seed(42)

    def batch():
        return torch.randint(0, cfg.vocab, (1, 129), device="cuda", generator=g)

    frozen_bytes = nbytes(model.embed.weight) + nbytes(model.lm_head.weight)
    cas_names = (tts.obs.CAS_BYTES_WRITTEN, tts.obs.CAS_BYTES_SHARED)
    device = torch.device("cuda", torch.cuda.current_device())

    # 1. saves: step 0 sync, step 1 incremental async under pressure
    # (traced), step 2 sync (retention evicts step 0)
    saved, times, moved = {}, {}, {}
    deleted = []
    real_delete = FSStoragePlugin.delete

    async def recording_delete(plugin, path):
        deleted.append((plugin.root, path))
        return await real_delete(plugin, path)

    fine_tune_step(model, opt, batch())
    for step in range(3):
        if step:
            fine_tune_step(model, opt, batch())
        meta["step"] = step
        saved[step] = clone_state(model, opt, meta)
        extra = []
        if step == 1:
            # blocking pinned copies for the large leaves: they stream
            for _ in range(400):
                if host_offload.device_copy_budget_bytes(device) < nbytes(model.embed.weight) // 2:
                    break
                extra.append(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
            budget = host_offload.device_copy_budget_bytes(device)
            check(budget < nbytes(model.embed.weight) // 2, f"the device-copy budget stayed at {budget} bytes")
        before = tts.obs.counters()
        FSStoragePlugin.delete = recording_delete
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if step == 1:
                with knobs.override_trace(1):
                    tts.obs.get_tracer().reset()
                    handle = mgr.save(app, step=step, incremental=True, async_=True)
                    unblock_s = time.perf_counter() - t0
                    offload = dict(host_offload.LAST_OFFLOAD_STATS)
                    handle.wait()
                    streams = len(spans_named("cas/stream_write"))
                tts.obs.get_tracer().reset()
            else:
                mgr.save(app, step=step, incremental=step > 0)
            times[step] = time.perf_counter() - t0
        finally:
            FSStoragePlugin.delete = real_delete
        del extra
        moved[step] = counter_delta(before, cas_names)
        tables = mgr.snapshot(step).metadata.cas["chunks"]
        taken = sum(int(t["size"]) for t in tables.values())
        check(sum(moved[step].values()) == taken,
              f"step {step}: {moved[step]} written and shared, {taken} bytes taken")
        check(not [f for f in os.listdir(mgr.path_for_step(step)) if not f.startswith(".")],
              f"step {step} holds per-step objects")
    check(streams > 0, "step 1 streamed no chunk (no cas/stream_write span)")
    check(moved[1][tts.obs.CAS_BYTES_SHARED] >= frozen_bytes,
          f"step 1 shared {moved[1][tts.obs.CAS_BYTES_SHARED]} < the frozen {frozen_bytes} bytes")
    step0 = mgr.path_for_step(0)
    gone = [p for r, p in deleted if r == step0]
    check(mgr.steps() == [1, 2] and not os.path.exists(step0), f"retention kept {mgr.steps()}")
    check(gone and gone[0] == ".snapshot_metadata", f"retention deleted {gone[:1]} of step 0 first")
    index = cas_mod.ChunkIndex.load(cas_mod.ChunkStore(pool))
    check(not any(cas_mod.norm_ref(step0) in e["refs"] for e in index.chunks.values()),
          "retention left step 0's refs in the index")
    lc = LIFECYCLE_SAVE_S
    print(f"cas_mmap saves (chunk {knobs.get_cas_chunk_size_bytes()} bytes): step 0 sync {times[0]:.3f} s "
          f"[hardlinked lifecycle full {lc.get('full', float('nan')):.3f} s], written/shared {json.dumps(moved[0])}; "
          f"step 1 incremental async unblock {unblock_s:.4f} s, committed {times[1]:.3f} s [lifecycle "
          f"{lc.get('unblock', float('nan')):.4f} / {lc.get('incremental_async', float('nan')):.3f} s], device-copy "
          f"budget {budget} bytes, device copies {offload['device_copy_bytes']} bytes, blocking host copies "
          f"{offload['blocking_host_bytes']} bytes, {streams} cas/stream_write spans, written/shared "
          f"{json.dumps(moved[1])}; step 2 sync {times[2]:.3f} s [lifecycle "
          f"{lc.get('incremental_sync', float('nan')):.3f} s], written/shared {json.dumps(moved[2])}; retention "
          f"deleted step 0 ({len(gone)} deletes, .snapshot_metadata first) and released its refs")

    # 2. restore from the pool
    model1, opt1 = fine_tune_state(cfg, seed=43)
    fine_tune_step(model1, opt1, batch())
    zero_state(model1, opt1)
    meta1 = tts.StateDict(step=-1)
    k2 = device_pack.LAUNCHES["slab_unpack"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = mgr.restore_latest({"model": model1, "optim": opt1, "rng": tts.RNGState(), "meta": meta1})
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    differs = state_differs(saved[2], model1, opt1, meta1)
    check(step == 2 and differs is None, f"cas restore_latest: step {step}, {differs}")
    check(device_pack.LAUNCHES["slab_unpack"] > k2, "the restore from the pool launched no K2")
    tokens = batch()
    loss, loss1 = fine_tune_step(model, opt, tokens), fine_tune_step(model1, opt1, tokens)
    check(torch.equal(loss, loss1), f"resumed loss {loss1.item()} != {loss.item()}")
    del model1, opt1
    template = torch.zeros(model.embed.weight.shape, dtype=torch.float32, device="cuda")
    k6 = device_pack.LAUNCHES["tile_update"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.snapshot(2).read_object("0/model/embed.weight", obj_out=template, memory_budget_bytes=READ_BUDGET)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    check(torch.equal(template, saved[2][0]["embed.weight"].float()), "budgeted read of the pooled embedding differs")
    check(device_pack.LAUNCHES["tile_update"] > k6, "the budgeted read from the pool launched no K6")
    print(f"cas_mmap restore: restore_latest step 2 from the pool in {resume_s:.3f} s, bitwise, K2 launches "
          f"{device_pack.LAUNCHES['slab_unpack'] - k2}, next loss {loss.item()!r} equal bitwise; read_object of "
          f"the embedding into f32 under {READ_BUDGET} bytes {read_s:.4f} s, K6 launches "
          f"{device_pack.LAUNCHES['tile_update'] - k6}, equal to the cast")
    del template

    # 3. GC and audit
    referenced = set()
    for s_ in (1, 2):
        for t in mgr.snapshot(s_).metadata.cas["chunks"].values():
            referenced.update(t["keys"])
    pool_before = cas_pool_keys(pool)
    t0 = time.perf_counter()
    swept = mgr.cas_gc(grace_s=0)
    gc_s = time.perf_counter() - t0
    check(set(cas_mod.ChunkIndex.load(cas_mod.ChunkStore(pool)).chunks) == referenced == cas_pool_keys(pool),
          "cas_gc did not leave exactly the chunks committed steps reference")
    verify_s = []
    for s_ in (1, 2):
        t0 = time.perf_counter()
        res = mgr.snapshot(s_).verify(deep=True)
        verify_s.append(round(time.perf_counter() - t0, 3))
        check(res.ok and res.complete, f"deep verify of step {s_}: {res}")
    live = cas_mod.ChunkIndex.load(cas_mod.ChunkStore(pool)).live_keys()
    os.remove(os.path.join(pool, cas_mod.CHUNK_INDEX_FNAME))
    t0 = time.perf_counter()
    rebuilt = mgr.fsck()
    fsck_s = time.perf_counter() - t0
    check(cas_mod.ChunkIndex.load(cas_mod.ChunkStore(pool)).live_keys() == live, "fsck rebuilt other live keys")
    # 5. the CLI on the pool and the CAS step (the pool state is 3's):
    # its four processes started together
    traces = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "traces")
    os.makedirs(traces, exist_ok=True)
    out_file = os.path.join(traces, "materialize.json")
    done = finish_clis(start_clis((("cas", ["cas", pool, "--json"]),
                                   ("stats", ["stats", mgr.path_for_step(2), "--json"]),
                                   ("doctor", ["doctor", mgr.path_for_step(2)]),
                                   ("trace", ["trace", mgr.path_for_step(2), "--out", out_file])),
                                  os.path.join(root, "cli")))
    for name, (rc, _, err, _) in done.items():
        check(rc == 0, f"{name} exited {rc}: {err[-300:]}")
    cli = {name: (s_, out) for name, (_, out, _, s_) in done.items()}
    rollup = json.loads(cli["cas"][1])["index"]
    print(f"cas_mmap gc: {len(pool_before)} chunks in the pool, cas_gc(grace_s=0) {gc_s:.3f} s swept "
          f"{swept['swept_chunks']} ({swept['swept_bytes']} bytes), {len(referenced)} referenced kept; deep verify "
          f"steps 1, 2 {verify_s} s; fsck {fsck_s:.3f} s rebuilt {rebuilt['chunks']} chunks, the same "
          f"{len(live)} live keys; cas --json {cli['cas'][0]} s: {rollup['live_chunks']} live, "
          f"{rollup['live_bytes']} bytes, refcounts {rollup['refcount_histogram']}")
    cas_stats = json.loads(cli["stats"][1])["cas"]
    check(cas_stats["chunked_objects"] > 0 and "cas:" in cli["doctor"][1], "stats/doctor show no chunks")
    print(f"cas_mmap CLI (started together with cas --json): stats --json {cli['stats'][0]} s ({cas_stats['chunked_objects']} chunked objects, "
          f"{cas_stats['distinct_chunks']} chunks); doctor {cli['doctor'][0]} s "
          f"({[ln.strip() for ln in cli['doctor'][1].splitlines() if ln.strip().startswith('cas:')]}); trace on the "
          f"card {cli['trace'][0]} s: {cli['trace'][1].strip()}, {os.path.getsize(out_file)} bytes")
    del model, opt, app, saved
    shutil.rmtree(root)
    gc.collect()
    torch.cuda.empty_cache()

    # 4. mapped against copying reads on the serving state
    where, fstype = mount_of(work)
    model, opt = deterministic_state(cfg, 3)
    model2, opt2 = deterministic_state(cfg, 4)
    snap_dir = os.path.join(work, "mmap")
    tts.Snapshot.take(snap_dir, {"model": model, "optim": opt})
    md = tts.Snapshot(snap_dir).metadata
    big = max(md.objects, key=lambda loc: md.objects[loc][2])
    size, legs = map_against_read(os.path.join(snap_dir, big))
    print(f"cas_mmap map: the work directory {work} is on {where} ({fstype}); {big} ({size} bytes) to the card "
          f"mapped {legs['mapped']:.4f} s ({size / legs['mapped'] / 1e9:.3f} GB/s) against read into a fresh "
          f"buffer first {legs['read']:.4f} s ({size / legs['read'] / 1e9:.3f} GB/s), best of 3")
    real_read = FSStoragePlugin.read
    asked = []

    async def counting_read(plugin, read_io):
        if not read_io.path.startswith("."):  # the metadata is read whole, never mapped
            asked.append(read_io.want_mmap)
        return await real_read(plugin, read_io)

    runs = {"MMAP=1": [], "MMAP=0": []}
    mapped_bytes = 0
    for rep in range(MMAP_REPEATS):
        for label in (("MMAP=1", "MMAP=0") if rep % 2 == 0 else ("MMAP=0", "MMAP=1")):
            zero_state(model2, opt2)
            asked.clear()
            before = tts.obs.counters()
            FSStoragePlugin.read = counting_read
            try:
                with knobs.override_mmap(label == "MMAP=1"):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    tts.Snapshot(snap_dir).restore({"model": model2, "optim": opt2})
                    torch.cuda.synchronize()
                    runs[label].append(time.perf_counter() - t0)
            finally:
                FSStoragePlugin.read = real_read
            d = counter_delta(before, (tts.obs.MMAP_READS, tts.obs.MMAP_BYTES_MAPPED))
            differs = same_state((model, opt), (model2, opt2))
            check(differs is None, f"mmap {label} run {rep}: restored {differs} differs")
            want = len(asked) if label == "MMAP=1" else 0
            check(all(asked) == (label == "MMAP=1") and d[tts.obs.MMAP_READS] == want,
                  f"mmap {label} run {rep}: {d[tts.obs.MMAP_READS]} mapped reads of {len(asked)} reads")
            mapped_bytes += d[tts.obs.MMAP_BYTES_MAPPED]
            print(f"cas_mmap restore {label} run {rep}: {runs[label][-1]:.4f} s, {len(asked)} reads, "
                  f"{d[tts.obs.MMAP_READS]} mapped ({d[tts.obs.MMAP_BYTES_MAPPED]} bytes), phases "
                  f"{phases_of(tts.obs.aggregate.last_record('restore'))}")
    nb = state_bytes(model, opt)
    for label, ts in runs.items():
        print(f"cas_mmap restore {label}: state {nb} bytes; {median_range(ts)}")
    print(f"cas_mmap: storage.mmap.bytes_mapped over the MMAP=1 restores {mapped_bytes}")
    del model2, opt2
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = tts.Snapshot(snap_dir).materialize(device="cpu")
    cpu_s = time.perf_counter() - t0
    leaves = {p: t for p, t in flatten(got["model"], prefix="model")[1].items() if isinstance(t, torch.Tensor)}
    leaves.update({p: t for p, t in flatten(got["optim"], prefix="optim")[1].items() if isinstance(t, torch.Tensor)})
    # a slab member at an offset its dtype does not divide is copied to
    # align it (torch needs aligned storage); the rest stay views
    unaligned = {
        p.split("/", 1)[1] for p, e in md.manifest.items()
        if getattr(e, "byte_range", None) and e.byte_range[0] % string_to_dtype(e.dtype).itemsize
    }
    unmapped = [p for p, t in leaves.items() if not is_mmap_backed(t) and p not in unaligned]
    check(not unmapped, f"materialize(cpu) leaves not over a mapping: {unmapped[:3]}")
    emb = md.manifest["0/model/embed.weight"].location
    got["model"]["embed.weight"].fill_(1.0)
    with open(os.path.join(snap_dir, emb), "rb") as f:
        check(zlib.crc32(f.read()) == md.objects[emb][0], "writing a materialized leaf changed its file")
    del got, leaves
    t0 = time.perf_counter()
    got = tts.Snapshot(snap_dir).materialize(device="cuda")
    torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t0
    bad = [k for k, v in model.state_dict().items() if not torch.equal(got["model"][k], v)]
    check(not bad, f"materialize(cuda) differs: {bad[:3]}")
    print(f"cas_mmap materialize: cpu {cpu_s:.3f} s, every aligned leaf over a mapping ({len(unaligned)} "
          f"unaligned slab members copied), a written leaf left its file's crc32; cuda {cuda_s:.3f} s, bitwise")
    del got, model, opt
    shutil.rmtree(snap_dir)


TIER_SEED = 51


def local_root(work, need_bytes, name):
    """A directory for ``name`` on a local filesystem: under ``/dev/shm``
    when it has ``need_bytes`` free, else under the work directory.
    Returns (path, mount point, filesystem type)."""
    shm = "/dev/shm"
    try:
        room = os.path.isdir(shm) and os.access(shm, os.W_OK) and shutil.disk_usage(shm).free >= need_bytes
    except OSError:
        room = False
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_", dir=shm) if room else work, name)
    return (path, *mount_of(os.path.dirname(path)))


def perturb(model, step):
    """A step's own bits: the first row of the embedding set to ``step``."""
    with torch.no_grad():
        model.embed.weight[0].fill_(float(step))


def tier_cache_child(rank, world, port, root):
    """One reader of the tier_cache path's host-cache phase: restores the
    durable step 1 onto the card with the cache directory of
    ``root/child.json``, checks it bitwise against the state rebuilt from
    its seed, prints a ``tier_cache result`` JSON line."""
    from torchsnapshot_tpu_torch import knobs

    if not torch.cuda.is_available():
        print("tier_cache child: no CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(root, "child.json")) as f:
        job = json.load(f)
    cfg = TransformerConfig(n_layers=N_LAYERS)
    model, opt = deterministic_state(cfg, TIER_SEED)
    perturb(model, 1)
    model2, opt2 = deterministic_state(cfg, TIER_SEED + 1)
    zero_state(model2, opt2)
    meta = tts.StateDict(step=-1)
    for k in device_pack.LAUNCHES:
        device_pack.LAUNCHES[k] = 0
    names = (tts.obs.CACHE_MISSES, tts.obs.CACHE_HITS, tts.obs.CACHE_SINGLEFLIGHT_WAITS, tts.obs.MMAP_READS)
    before = tts.obs.counters()
    # both children start their restores together
    go = os.path.join(root, "go")
    with open(os.path.join(root, f"ready{rank}"), "w"):
        pass
    deadline = time.monotonic() + 120
    while not os.path.exists(go):
        check(time.monotonic() < deadline, "the parent never released the readers")
        time.sleep(0.005)
    with knobs.override_cache_dir(job["cache"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tts.Snapshot(job["snap"]).restore({"model": model2, "optim": opt2, "meta": meta})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    differs = same_state((model, opt), (model2, opt2))
    check(differs is None and meta["step"] == 1, f"tier_cache child {rank}: restored {differs}, step {meta['step']}")
    out = {"rank": rank, "restore_s": restore_s, "counts": counter_delta(before, names),
           "launches": dict(device_pack.LAUNCHES)}
    print("tier_cache result " + json.dumps(out), flush=True)
    return 0


def phase_tier_cache(cfg, work):
    """Tiered storage and the shared-host object cache on the serving state
    (see the module docstring, path i)."""
    import zlib

    from torchsnapshot_tpu_torch import knobs
    from torchsnapshot_tpu_torch import manager as manager_mod

    model, opt = deterministic_state(cfg, TIER_SEED)
    meta = tts.StateDict(step=0)
    app = {"model": model, "optim": opt, "meta": meta}
    nb = state_bytes(model, opt)
    check(nb == 4_001_488_980 or cfg.d_model != 4096, f"the serving state holds {nb} bytes")
    durable = os.path.join(work, "tier_durable")
    fast, fast_mnt, fast_fs = local_root(work, 3 * nb + (1 << 30), "tier_fast")
    card = card_line()
    print(f"tier_cache on {card}; roots: durable {durable} on {'%s (%s)' % mount_of(work)}; fast {fast} on {fast_mnt} "
          f"({fast_fs}); free bytes: work {shutil.disk_usage(work).free}, "
          f"/dev/shm {shutil.disk_usage('/dev/shm').free if os.path.isdir('/dev/shm') else 0}")
    mgr = tts.SnapshotManager(durable, tier=tts.TierConfig(fast_root=fast, fast_keep_last_n=2))
    names = (tts.obs.TIER_FAST_HITS, tts.obs.TIER_FAST_MISSES, tts.obs.TIER_FAST_CORRUPT,
             tts.obs.TIER_FAST_REPAIRS, tts.obs.BYTES_PROMOTED)

    def lag():
        h = tts.obs.metrics_snapshot()["histograms"].get(tts.obs.PROMOTION_LAG_S) or {"count": 0, "sum": 0.0}
        return h["count"], h["sum"]

    # every fast-copy eviction must find the step's durable marker
    evictions = []
    real_delete = manager_mod.delete_snapshot

    def watched_delete(path, *a, **kw):
        if path.startswith(fast):
            step = int(path.rsplit("_", 1)[1])
            evictions.append((step, os.path.exists(os.path.join(mgr.path_for_step(step), ".snapshot_metadata"))))
        return real_delete(path, *a, **kw)

    manager_mod.delete_snapshot = watched_delete
    try:
        # 1. step 0 write-through: both tiers committed on return
        perturb(model, 0)
        with knobs.override_tier_policy("write_through"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(app, step=0)
            wt_s = time.perf_counter() - t0
        check(all(os.path.exists(os.path.join(p, ".snapshot_metadata"))
                  for p in (mgr.path_for_step(0), mgr.fast_path_for_step(0))), "write-through left a tier uncommitted")
        # 2. step 1 sync write-back: returns at the fast commit
        perturb(model, 1)
        meta["step"] = 1
        before, lag0 = tts.obs.counters(), lag()
        os.sync()
        with knobs.override_trace(1):
            tts.obs.get_tracer().reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(app, step=1)
            wb_return_s = time.perf_counter() - t0
            fast_committed = os.path.exists(os.path.join(mgr.fast_path_for_step(1), ".snapshot_metadata"))
            tts.drain_promotions(timeout_s=600)
            wb_durable_s = time.perf_counter() - t0
        report_trace("tier_write_back_take", wb_return_s, "take",
                     phases_of(tts.obs.aggregate.read_obsrecord(mgr.fast_path_for_step(1))))
        lag1 = lag()
        promoted = counter_delta(before, names)[tts.obs.BYTES_PROMOTED]
        md1 = tts.Snapshot(mgr.fast_path_for_step(1)).metadata
        payload1 = sum(int(d[2]) for d in md1.objects.values())
        check(fast_committed and mgr.durable_steps() == [0, 1], f"write-back step 1: durable {mgr.durable_steps()}")
        check(promoted == payload1, f"tier.bytes_promoted {promoted} != the step's {payload1} payload bytes")
        check(lag1[0] == lag0[0] + 1, "no tier.promotion_lag_s observation for step 1")
        # 3. step 2 async write-back
        perturb(model, 2)
        meta["step"] = 2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = mgr.save(app, step=2, async_=True)
        unblock_s = time.perf_counter() - t0
        handle.wait()
        fast_commit_s = time.perf_counter() - t0
        tts.drain_promotions(timeout_s=600)
        durable_commit_s = time.perf_counter() - t0
        lag2 = lag()
        check(mgr.durable_steps() == [0, 1, 2], f"durable steps {mgr.durable_steps()}")
        print(f"tier_cache takes ({card}; state {nb} bytes): step 0 write_through {wt_s:.3f} s, both tiers committed; "
              f"step 1 write_back returned {wb_return_s:.3f} s (fast commit), durable {wb_durable_s:.3f} s, "
              f"tier.promotion_lag_s {lag1[1] - lag0[1]:.3f} s, tier.bytes_promoted {promoted} == payload "
              f"{payload1}; step 2 async_take unblock {unblock_s:.4f} s, fast commit {fast_commit_s:.3f} s, "
              f"durable {durable_commit_s:.3f} s (lag {lag2[1] - lag1[1]:.3f} s)")
        # 8. fast retention: after step 2's commit step 0's fast copy went,
        # and only once it was durable
        mgr.gc()
        check(mgr._scan_dir(fast, require_metadata=False) == [1, 2], f"fast steps {mgr._scan_dir(fast, False)}")
        check(evictions and all(ok for _, ok in evictions) and {s_ for s_, _ in evictions} == {0},
              f"fast evictions {evictions}")
    finally:
        manager_mod.delete_snapshot = real_delete

    model2, opt2 = deterministic_state(cfg, TIER_SEED + 1)
    meta2 = tts.StateDict(step=-1)
    app2 = {"model": model2, "optim": opt2, "meta": meta2}
    real_read = FSStoragePlugin.read
    fast_reads = []

    async def counting_read(plugin, read_io):
        if plugin.root.startswith(fast):
            fast_reads.append(read_io.path)
        return await real_read(plugin, read_io)

    def restore(label, fn):
        zero_state(model2, opt2)
        meta2["step"] = -1
        fast_reads.clear()
        before = tts.obs.counters()
        k2 = device_pack.LAUNCHES["slab_unpack"]
        FSStoragePlugin.read = counting_read
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            FSStoragePlugin.read = real_read
        differs = same_state((model, opt), (model2, opt2))
        check(differs is None and meta2["step"] == 2, f"tier_cache {label}: restored {differs}, step {meta2['step']}")
        check(device_pack.LAUNCHES["slab_unpack"] > k2, f"tier_cache {label} launched no K2")
        d = counter_delta(before, names + (tts.obs.MMAP_READS,))
        print(f"tier_cache restore {label} ({card}): {dt:.3f} s, bitwise, {len(fast_reads)} fast-tier reads, "
              f"K2 launches {device_pack.LAUNCHES['slab_unpack'] - k2}, {json.dumps(d)}")
        return d

    # 4. fast-first: every read a fast hit (traced)
    step = mgr.latest_step()
    check(step == 2, f"latest step {step}")
    with knobs.override_trace(1):
        tts.obs.get_tracer().reset()
        d = restore("fast-first", lambda: mgr.snapshot(2).restore(app2))
    report_trace("tier_fast_first_restore", float("nan"), "restore",
                 phases_of(tts.obs.aggregate.last_record("restore")))
    check(d[tts.obs.TIER_FAST_HITS] == len(fast_reads) and d[tts.obs.TIER_FAST_MISSES] == 0,
          f"fast-first: {d[tts.obs.TIER_FAST_HITS]} hits of {len(fast_reads)} fast reads")
    # what the fast-first restore adds: the first-read digest of every fast
    # object through its map, and where the fast root's pages come from
    from torchsnapshot_tpu_torch.storage.fs import mmap_read
    from torchsnapshot_tpu_torch.utils.checksums import crc32_fast

    md2 = tts.Snapshot(mgr.path_for_step(2)).metadata
    t0 = time.perf_counter()
    for loc, dig in md2.objects.items():
        check(crc32_fast(mmap_read(os.path.join(mgr.fast_path_for_step(2), loc), None)) == dig[0],
              f"fast copy of {loc} differs from its digest")
    digest_s = time.perf_counter() - t0
    big = max(md2.objects, key=lambda loc: md2.objects[loc][2])
    legs = {root_: map_against_read(os.path.join(root_, big))
            for root_ in (mgr.fast_path_for_step(2), mgr.path_for_step(2))}
    print(f"tier_cache legs ({card}): digest of the {len(md2.objects)} fast objects ({nb} bytes) through their maps "
          f"{digest_s:.3f} s ({nb / digest_s / 1e9:.3f} GB/s, one thread); {big} ({legs[mgr.path_for_step(2)][0]} "
          f"bytes) to the card, best of 3: "
          + "; ".join(f"{mount_of(r)[1]} mapped {v[1]['mapped']:.4f} s, read first {v[1]['read']:.4f} s"
                      for r, v in legs.items()))
    # 5. one flipped byte in a fast payload: found, served durably, repaired
    victim = min(md2.objects, key=lambda loc: md2.objects[loc][2])
    vpath = os.path.join(mgr.fast_path_for_step(2), victim)
    with open(vpath, "r+b") as f:
        f.seek(md2.objects[victim][2] // 2)
        b = f.read(1)
        f.seek(md2.objects[victim][2] // 2)
        f.write(bytes([b[0] ^ 0x40]))
    d = restore(f"after a flipped byte in {victim}", lambda: mgr.snapshot(2).restore(app2))
    check(d[tts.obs.TIER_FAST_CORRUPT] == 1 and d[tts.obs.TIER_FAST_REPAIRS] == 1, f"corrupt/repairs {d}")
    with open(vpath, "rb") as f:
        check(zlib.crc32(f.read()) == md2.objects[victim][0], "the repaired fast copy differs from its digest")
    # 6. the fast root of step 2 wiped: the durable tier serves it
    shutil.rmtree(mgr.fast_path_for_step(2))
    d = restore("after the fast copy was wiped", lambda: mgr.snapshot(2).restore(app2))
    check(d[tts.obs.TIER_FAST_MISSES] >= len(md2.objects) and d[tts.obs.TIER_FAST_REPAIRS] == len(md2.objects),
          f"durable fallback {d} for {len(md2.objects)} objects")
    del model2, opt2, app2
    gc.collect()
    torch.cuda.empty_cache()
    # 7. the embedding into an f32 template under 32 MiB, through the tier
    template = torch.zeros(model.embed.weight.shape, dtype=torch.float32, device="cuda")
    k6 = device_pack.LAUNCHES["tile_update"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.snapshot(2).read_object("0/model/embed.weight", obj_out=template, memory_budget_bytes=READ_BUDGET)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    check(torch.equal(template, model.embed.weight.float()), "budgeted tiered read of the embedding differs")
    check(device_pack.LAUNCHES["tile_update"] > k6, "the budgeted tiered read launched no K6")
    print(f"tier_cache read_object ({card}): the embedding into f32 under {READ_BUDGET} bytes through the tier "
          f"{read_s:.4f} s, K6 launches {device_pack.LAUNCHES['tile_update'] - k6}, equal to the cast")
    del template
    # 9. the CLI, started here and read after the host cache's readers
    # (it lists the tiers, which they only read)
    tiers_cli = start_clis((("tiers", ["tiers", durable, "--fast", fast, "--json"]),), os.path.join(work, "tier_cli"))

    # the host cache: two readers at once, then this process
    cache, cache_mnt, cache_fs = local_root(work, nb + (1 << 30), "tier_cache_dir")
    os.makedirs(cache, exist_ok=True)
    child_root = os.path.join(work, "tier_cache_children")
    os.makedirs(child_root, exist_ok=True)
    snap1 = mgr.path_for_step(1)
    with open(os.path.join(child_root, "child.json"), "w") as f:
        json.dump({"snap": snap1, "cache": cache}, f)
    n_objects = len(tts.Snapshot(snap1).metadata.objects)

    def release_when_ready():
        deadline = time.monotonic() + 300
        while not all(os.path.exists(os.path.join(child_root, f"ready{r}")) for r in range(2)):
            if time.monotonic() > deadline:
                return
            time.sleep(0.01)
        open(os.path.join(child_root, "go"), "w").close()

    import threading

    releaser = threading.Thread(target=release_when_ready, daemon=True)
    releaser.start()
    t0 = time.perf_counter()
    results = spawn_ranks("--tier-cache-child", child_root)
    children_s = time.perf_counter() - t0
    releaser.join(timeout=10)
    rc, out, err, tiers_s = finish_clis(tiers_cli)["tiers"]
    check(rc == 0, f"tiers exited {rc}: {err[-300:]}")
    rows = {r["step"]: r["status"] for r in json.loads(out)["steps"]}
    check(rows == {0: "durable", 1: "durable+fast", 2: "durable+fast"}, f"tiers: {rows}")
    print(f"tier_cache tiers CLI (beside the two readers): {tiers_s:.2f} s, {json.dumps(rows)}")
    counts = {k: sum(r["counts"][k] for r in results) for k in results[0]["counts"]}
    # this process: every read a hit, and mapped
    model3, opt3 = deterministic_state(cfg, TIER_SEED + 2)
    zero_state(model3, opt3)
    meta3 = tts.StateDict(step=-1)
    perturb(model, 1)  # the live state as step 1 took it
    before = tts.obs.counters()
    with knobs.override_cache_dir(cache):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tts.Snapshot(snap1).restore({"model": model3, "optim": opt3, "meta": meta3})
        torch.cuda.synchronize()
        parent_s = time.perf_counter() - t0
    d = counter_delta(before, (tts.obs.CACHE_MISSES, tts.obs.CACHE_HITS, tts.obs.CACHE_SINGLEFLIGHT_WAITS,
                               tts.obs.MMAP_READS))
    differs = same_state((model, opt), (model3, opt3))
    check(differs is None and meta3["step"] == 1, f"cached restore: {differs}, step {meta3['step']}")
    reads = d[tts.obs.CACHE_HITS]
    check(d[tts.obs.CACHE_MISSES] == 0 and reads >= n_objects and d[tts.obs.MMAP_READS] == reads,
          f"third restore: {d}")
    check(counts[tts.obs.CACHE_MISSES] == n_objects,
          f"{counts[tts.obs.CACHE_MISSES]} cache misses across the readers for {n_objects} objects")
    check(counts[tts.obs.CACHE_HITS] + counts[tts.obs.CACHE_SINGLEFLIGHT_WAITS] == 2 * reads - n_objects,
          f"readers' hits + waits {counts} against {reads} reads each and {n_objects} objects")
    cached = sum(len(fs) for _, _, fs in os.walk(os.path.join(cache, "objects")))
    print(f"tier_cache host cache ({card}): {cache} on {cache_mnt} ({cache_fs}); two readers at once {children_s:.1f} s "
          f"(restores {[round(r['restore_s'], 3) for r in results]} s), summed {json.dumps(counts)} for "
          f"{n_objects} objects, {reads} reads a restore; this process {parent_s:.3f} s, {json.dumps(d)}, "
          f"{cached} cache files")
    others = {}
    for r in results:
        for k, v in r["launches"].items():
            others[k] = others.get(k, 0) + v
    del model, opt, model3, opt3
    for p in (durable, fast, cache, child_root):
        shutil.rmtree(p, ignore_errors=True)
    for p in (fast, cache):
        if p.startswith("/dev/shm/"):
            shutil.rmtree(os.path.dirname(p), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return others


CLOUD_SEED = 61


def mem_available():
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return -1


def state_tree(model, opt):
    """The state the interop leg exports: the model's tensors and the
    optimizer's per-parameter state (its param_groups hold ``None``s the
    original format has no pickle-free entry for)."""
    return {"model": model.state_dict(), "optim": {"state": opt.state_dict()["state"]}}


def same_tree(want, got, where=""):
    """Where two nested states differ (tensors bitwise, on any device), or
    None.  Keys compare as strings: a native snapshot's paths hold an int
    key as its string."""
    if isinstance(want, dict):
        got = {str(k): v for k, v in got.items()}
        if sorted(map(str, want)) != sorted(got):
            return f"{where}: keys {sorted(got)}"
        for k in want:
            bad = same_tree(want[k], got[str(k)], f"{where}/{k}")
            if bad:
                return bad
        return None
    if isinstance(want, torch.Tensor):
        ok = isinstance(got, torch.Tensor) and want.dtype == got.dtype and torch.equal(want.cpu(), got.cpu())
        return None if ok else f"{where}: tensor differs"
    return None if want == got else f"{where}: {got!r}"


def phase_cloud_interop(cfg, work):
    """Object stores and the original torchsnapshot format on the serving
    state (see the module docstring, path j)."""
    from torchsnapshot_tpu_torch import knobs
    from torchsnapshot_tpu_torch.storage.gcs import _DEFAULT_CHUNK_BYTES
    from torchsnapshot_tpu_torch.tricks import read_torchsnapshot, write_torchsnapshot

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import cloud_fakes

    card = card_line()
    fake_note = "in-process fake store, no network measured"
    print(f"cloud_interop on {card}: MemAvailable {mem_available()} bytes before the path ({fake_note})")
    model, opt = deterministic_state(cfg, CLOUD_SEED)
    meta = tts.StateDict(step=0)
    app = {"model": model, "optim": opt, "meta": meta}
    nb = state_bytes(model, opt)
    check(nb == 4_001_488_980 or cfg.d_model != 4096, f"the serving state holds {nb} bytes")
    model2, opt2 = deterministic_state(cfg, CLOUD_SEED + 1)
    meta2 = tts.StateDict(step=-1)
    app2 = {"model": model2, "optim": opt2, "meta": meta2}
    threshold = knobs.get_stripe_min_object_size_bytes()
    launches = device_pack.LAUNCHES

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def restore_into_zeroed(url, label, **kw):
        zero_state(model2, opt2)
        meta2["step"] = -1
        k2 = launches["slab_unpack"]
        _, dt = timed(lambda: tts.Snapshot(url, **kw).restore(app2))
        differs = same_state((model, opt), (model2, opt2))
        check(differs is None and meta2["step"] == meta["step"], f"cloud_interop {label}: restored {differs}")
        check(launches["slab_unpack"] > k2, f"cloud_interop {label} launched no K2")
        return dt, launches["slab_unpack"] - k2

    # 1. s3://
    s3 = cloud_fakes.S3Fake()
    undo = cloud_fakes.install_s3(s3)
    try:
        k1 = launches["slab_pack"]
        _, take_s = timed(lambda: tts.Snapshot.take("s3://bkt/run/step0", app))
        md = tts.Snapshot("s3://bkt/run/step0").metadata
        big = sum(1 for d in md.objects.values() if d[2] >= threshold)
        check(s3.ops["create_multipart_upload"] == big == s3.ops["complete_multipart_upload"] and big > 0,
              f"s3 take: {s3.ops['create_multipart_upload']} multipart uploads for {big} objects >= {threshold} bytes")
        check(s3.multipart_uploads == {}, f"s3 take left {len(s3.multipart_uploads)} uploads in progress")
        take_ops = dict(s3.ops)
        restore_s, k2 = restore_into_zeroed("s3://bkt/run/step0", "s3 restore")
        print(f"cloud_interop s3 ({fake_note}; {card}): take {take_s:.3f} s ({nb / take_s / 1e9:.3f} GB/s), "
              f"K1 launches {launches['slab_pack'] - k1}, {len(md.objects)} objects, {big} multipart uploads "
              f"(objects >= {threshold} bytes), none in progress, calls {json.dumps(take_ops)}; restore bitwise "
              f"{restore_s:.3f} s ({nb / restore_s / 1e9:.3f} GB/s), K2 launches {k2}, ranged GETs "
              f"{len(s3.ranges)} (largest {max((n for _, n in s3.ranges), default=0)} bytes)")
        # a budgeted read of the embedding into an f32 template
        template = torch.zeros(model.embed.weight.shape, dtype=torch.float32, device="cuda")
        s3.ranges.clear()
        k6 = launches["tile_update"]
        _, read_s = timed(lambda: tts.Snapshot("s3://bkt/run/step0").read_object(
            "0/model/embed.weight", obj_out=template, memory_budget_bytes=READ_BUDGET))
        check(torch.equal(template, model.embed.weight.float()), "s3 budgeted read of the embedding differs")
        check(launches["tile_update"] > k6, "the s3 budgeted read launched no K6")
        largest = max((n for _, n in s3.ranges), default=0)
        check(s3.ranges and largest <= READ_BUDGET, f"s3 budgeted read: a GET of {largest} bytes")
        print(f"cloud_interop s3 read_object ({fake_note}; {card}): the embedding into f32 under {READ_BUDGET} "
              f"bytes {read_s:.4f} s ({nbytes(model.embed.weight) / read_s / 1e9:.3f} GB/s), {len(s3.ranges)} ranged GETs, largest {largest} bytes, K6 launches "
              f"{launches['tile_update'] - k6}, equal to the cast")
        del template
        # an incremental take: the embedding changes, the rest is copied
        # server-side
        perturb(model, 1)
        meta["step"] = 1
        before = dict(s3.ops)
        d0 = tts.obs.counters().get(tts.obs.BYTES_DEDUPED, 0)
        _, inc_s = timed(lambda: tts.Snapshot.take("s3://bkt/run/step1", app, base="s3://bkt/run/step0"))
        copies = s3.ops["copy_object"] - before.get("copy_object", 0)
        deduped = tts.obs.counters().get(tts.obs.BYTES_DEDUPED, 0) - d0
        md1 = tts.Snapshot("s3://bkt/run/step1").metadata
        same = sum(1 for loc, d in md1.objects.items() if md.objects.get(loc) == d)
        check(0 < copies and copies == same < len(md1.objects), f"s3 incremental take: {copies} copies, {same} "
              f"unchanged of {len(md1.objects)} objects")
        restore_s1, _ = restore_into_zeroed("s3://bkt/run/step1", "s3 incremental restore")
        print(f"cloud_interop s3 incremental take ({fake_note}; {card}): {inc_s:.3f} s ({nb / inc_s / 1e9:.3f} GB/s "
              f"of state), {copies} objects copied "
              f"server-side (copy_object) of {len(md1.objects)}, bytes_deduped {deduped}, uploads "
              f"{s3.ops['put_object'] - before.get('put_object', 0)} puts and "
              f"{s3.ops['upload_part'] - before.get('upload_part', 0)} parts; restore bitwise {restore_s1:.3f} s "
              f"({nb / restore_s1 / 1e9:.3f} GB/s)")
    finally:
        undo()
        s3.objects.clear()
        del s3
    gc.collect()

    # 2. gs://
    gcs = cloud_fakes.GCSFake()
    undo = cloud_fakes.install_gcs(gcs)
    try:
        chunk = _DEFAULT_CHUNK_BYTES
        k1 = launches["slab_pack"]
        _, take_s = timed(lambda: tts.Snapshot.take("gs://bkt/run/step1", app))
        md = tts.Snapshot("gs://bkt/run/step1").metadata
        # a striped object (at the stripe threshold, over the chunk at full
        # width) is composed from its parts too
        over = sum(1 for d in md.objects.values() if d[2] > chunk or d[2] >= threshold)
        names = list(gcs.bucket("bkt").data)
        check(gcs.ops["compose"] == over > 0, f"gs take: {gcs.ops['compose']} composes for {over} objects over "
              f"{chunk} bytes")
        check(not any(".part-" in n or ".compose-" in n for n in names), "gs take left part blobs")
        take_ops = dict(gcs.ops)
        gcs.ranges.clear()
        restore_s, k2 = restore_into_zeroed("gs://bkt/run/step1", "gs restore")
        check(gcs.ranges, "the gs restore made no ranged GET")
        print(f"cloud_interop gs ({fake_note}; {card}): take {take_s:.3f} s ({nb / take_s / 1e9:.3f} GB/s), "
              f"K1 launches {launches['slab_pack'] - k1}, {len(md.objects)} objects, {over} composed (over "
              f"{chunk} bytes or striped), no part blob left, calls {json.dumps(take_ops)}; restore bitwise {restore_s:.3f} s "
              f"({nb / restore_s / 1e9:.3f} GB/s), K2 launches {k2}, ranged GETs {len(gcs.ranges)} (largest "
              f"{max(n for _, n in gcs.ranges)} bytes)")
    finally:
        undo()
        gcs.buckets.clear()
        del gcs
    gc.collect()

    # 3. the original format on the work directory, and the CLI's convert
    ref = os.path.join(work, "cloud_ref")
    _, w_s = timed(lambda: write_torchsnapshot(ref, state_tree(model, opt)))
    # read_torchsnapshot onto the card runs in `convert` below (its result
    # restored bitwise) and on the exported copy, so this part does not
    # read it back itself
    native, back = os.path.join(work, "cloud_native"), os.path.join(work, "cloud_back")
    # --to-reference reads a native snapshot of the same tree, taken here
    # as convert would take it, so the two processes start together
    native_src = os.path.join(work, "cloud_native_src")
    tts.Snapshot.take(native_src, {k: tts.PyTreeState(v) for k, v in state_tree(model, opt).items()})
    done = finish_clis(start_clis((
        ("to_native", ["convert", ref, native, "--device", "cuda"]),
        ("to_reference", ["convert", "--to-reference", native_src, back, "--device", "cuda"]),
    ), os.path.join(work, "cloud_cli")))
    cli_s = {}
    for name, (rc, _out, err, secs) in done.items():
        cli_s[name] = secs
        check(rc == 0, f"convert {name} exited {rc}: {err[-2000:]}")
    # the converted native snapshot into a differently seeded state
    zero_state(model2, opt2)
    templates = {"model": tts.PyTreeState(model2.state_dict()),
                 "optim": tts.PyTreeState({"state": opt2.state_dict()["state"]})}
    k2 = launches["slab_unpack"]
    _, native_s = timed(lambda: tts.Snapshot(native).restore(templates))
    differs = same_state((model, opt), (model2, opt2))
    check(differs is None, f"the converted native snapshot restored {differs}")
    check(launches["slab_unpack"] > k2, "the converted native restore launched no K2")
    got = read_torchsnapshot(back, device="cuda")
    bad = same_tree(state_tree(model, opt), got)
    check(bad is None, f"convert --to-reference: {bad}")
    del got
    print(f"cloud_interop original format (the work directory, no object store, no network measured; {card}): "
          f"write_torchsnapshot from the card {w_s:.3f} s "
          f"({nb / w_s / 1e9:.3f} GB/s); python -m torchsnapshot_tpu_torch convert {cli_s['to_native']:.1f} s ({nb / cli_s['to_native'] / 1e9:.3f} GB/s) "
          f"and convert --to-reference {cli_s['to_reference']:.1f} s ({nb / cli_s['to_reference'] / 1e9:.3f} GB/s; "
          f"processes on the card started together, start-up included); the native result restored bitwise "
          f"{native_s:.3f} s ({nb / native_s / 1e9:.3f} GB/s, K2 launches {launches['slab_unpack'] - k2}), the exported one read back bitwise")
    del model, opt, model2, opt2, app, app2, templates
    for p in (ref, native, native_src, back):
        shutil.rmtree(p, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"cloud_interop: MemAvailable {mem_available()} bytes after the path ({fake_note})")


CONTINUOUS_SEED = 71
CONTINUOUS_STEPS = 3  # 4 until the publish path came
CONTINUOUS_PROMOTE_EVERY_N = 3  # promotes step 1 only; 2 (steps 1, 3) until the publish path came
CONTINUOUS_DURABLE_STEP = 1
CONTINUOUS_NOTICE_STEP = 3  # notify_preemption() right after this step


def hist_window(name, before):
    """(count, sum) a histogram gained since ``before`` = (count, sum)."""
    h = tts.obs.histogram(name).to_dict()
    return h["count"] - before[0], h["sum"] - before[1]


def phase_continuous(cfg, work):
    """The continuous per-step loop at full width (path l): the lifecycle
    fine-tune (the embedding and the LM head frozen) under one
    ``ContinuousCheckpointer``: the local store under ``/dev/shm`` when it
    has room, a standby host root and a durable root on the work
    directory, the collective transport (its device round trip carries
    every chunk bound for the standby), promotion every 3 steps.  Three
    steps, a preemption notice with step 3's replication in flight, then
    recoveries from the local store and, with the local and standby roots
    gone, from the durable one, each into a freshly built model and
    optimizer on the card, bitwise; the CLI's ``stats`` of the host root
    in a process beside the local recovery.  No kernel runs here: the
    leaves reach the host through ``encode_leaf``'s copies."""
    import threading

    from torchsnapshot_tpu_torch.continuous import ContinuousStore
    from torchsnapshot_tpu_torch.continuous import loop as loop_mod
    from torchsnapshot_tpu_torch.resilience import preemption
    from torchsnapshot_tpu_torch.tier.promoter import drain_promotions, get_promoter
    from torchsnapshot_tpu_torch.transport.collective import CollectiveTransport

    # timers around the blocked window's copies to the host and the
    # replica leg's round trips (the loop's own counters time neither)
    timing = {"encode_s": 0.0, "moves": []}
    timing_lock = threading.Lock()
    real_encode, real_move = loop_mod.encode_leaf, CollectiveTransport.device_move

    def timed_encode(leaf):
        t0 = time.perf_counter()
        out = real_encode(leaf)
        timing["encode_s"] += time.perf_counter() - t0
        return out

    def timed_move(self, buf):
        t0 = time.perf_counter()
        out = real_move(self, buf)
        with timing_lock:
            timing["moves"].append((t0, time.perf_counter(), len(out)))
        return out

    model, opt = fine_tune_state(cfg, seed=CONTINUOUS_SEED)
    meta = tts.StateDict(step=0)
    app = {"model": model, "optim": opt, "meta": meta}
    g = torch.Generator(device="cuda").manual_seed(CONTINUOUS_SEED + 1)

    def batch():
        return torch.randint(0, cfg.vocab, (1, 129), device="cuda", generator=g)

    fine_tune_step(model, opt, batch())  # the optimizer's state exists
    frozen_bytes = nbytes(model.embed.weight) + nbytes(model.lm_head.weight)
    total = state_bytes(model, opt)
    # the local store holds retain_steps complete steps plus the one landing
    local_host, mount, fstype = local_root(work, 4 * total, "continuous_local")
    retain = 2 if local_host.startswith("/dev/shm") else 1
    standby = os.path.join(work, "continuous_standby")
    durable = os.path.join(work, "continuous_durable")
    work_mount, work_fs = mount_of(work)
    print(f"continuous: state {total} bytes ({frozen_bytes} frozen); local store on {mount} ({fstype}), "
          f"retain_steps={retain} ({'/dev/shm has room' if retain == 2 else '/dev/shm lacks room'}); "
          f"standby and durable roots on the work directory ({work_mount}, {work_fs})")
    names = (tts.obs.CONTINUOUS_BYTES_REPLICATED, tts.obs.CONTINUOUS_BYTES_SKIPPED,
             tts.obs.CONTINUOUS_CHUNKS_REPLICATED, tts.obs.CONTINUOUS_CHUNKS_SKIPPED,
             tts.obs.CONTINUOUS_REPLICATION_ERRORS, tts.obs.TRANSPORT_DEVICE_MOVES,
             tts.obs.TRANSPORT_COLLECTIVE_BYTES, tts.obs.TRANSPORT_FALLBACKS, tts.obs.CONTINUOUS_PREEMPTION_DRAINS)
    hists = (tts.obs.CONTINUOUS_STEP_OVERHEAD_S, tts.obs.CONTINUOUS_REPLICATION_LAG_S)
    path_before = _counter_snapshot()
    clones, rows = {}, []
    loop_mod.encode_leaf, CollectiveTransport.device_move = timed_encode, timed_move
    with tts.knobs.override_transport("collective"):
        cc = tts.ContinuousCheckpointer(local_host, durable_root=durable, replica_roots=[standby],
                                        promote_every_n=CONTINUOUS_PROMOTE_EVERY_N, retain_steps=retain)
        try:
            pending = None  # (step, counters, histograms, blocked s, D2H s, moves so far, train s)
            train_s = None
            for step in range(1, CONTINUOUS_STEPS + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fine_tune_step(model, opt, batch())
                meta["step"] = step
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0  # beside the previous step's replication
                # the previous step's replication, left running beside this
                # training step, is waited for here: step()'s own window
                # then holds no join
                t0 = time.perf_counter()
                cc.drain()
                wait_s = time.perf_counter() - t0
                if pending is not None:
                    rows.append(pending + (train_s, counter_delta(pending[1], names),
                                           {h: hist_window(h, pending[2][h]) for h in hists}, wait_s))
                before = _counter_snapshot()
                hbefore = {h: hist_window(h, (0, 0.0)) for h in hists}
                encode0, moves0 = timing["encode_s"], len(timing["moves"])
                promoting = get_promoter()._queue.unfinished_tasks  # promotion jobs beside the window
                t0 = time.perf_counter()
                check(cc.step(app, step), f"step {step} was not recorded")
                blocked = time.perf_counter() - t0
                clones[step] = clone_state(model, opt, meta)
                for old in [s for s in clones if s not in (CONTINUOUS_DURABLE_STEP, step)]:
                    del clones[old]
                pending = (step, before, hbefore, blocked, timing["encode_s"] - encode0, moves0, promoting)
                if step == CONTINUOUS_NOTICE_STEP:
                    # the notice with this step's replication in flight
                    t0 = time.perf_counter()
                    drained = preemption.notify_preemption()
                    notice_s = time.perf_counter() - t0
                    head = ContinuousStore(os.path.join(standby, "r0")).read_head()
                    check(drained == 1 and head is not None and head["step"] == step,
                          f"the preemption drain left the standby at {head and head['step']} ({drained} drains)")
                    print(f"continuous: preemption notice after step {step}: {drained} drain completed in "
                          f"{notice_s:.3f} s (grace {tts.knobs.get_continuous_grace_s()} s); standby HEAD names "
                          f"step {head['step']}")
            t0 = time.perf_counter()
            cc.drain()
            rows.append(pending + (None, counter_delta(pending[1], names),
                                   {h: hist_window(h, pending[2][h]) for h in hists}, time.perf_counter() - t0))
            # the local store is final: the CLI's stats of the host root, in
            # a process beside the promotion's end and the recovery
            stats_cli = start_clis((("stats", ["stats", local_host, "--json"]),),
                                   os.path.join(work, "continuous_cli"))
            drain_promotions(timeout_s=600)
            durable_step = cc.last_durable_step()
            summary = cc.summary()
        finally:
            cc.close()
            preemption.uninstall()
            loop_mod.encode_leaf, CollectiveTransport.device_move = real_encode, real_move
    moves = timing["moves"]
    for i, (step, _, _, blocked, encode_s, moves0, promoting, next_train_s, d, h, wait_s) in enumerate(rows):
        over_n, over_s = h[tts.obs.CONTINUOUS_STEP_OVERHEAD_S]
        lag_n, lag_s = h[tts.obs.CONTINUOUS_REPLICATION_LAG_S]
        mine = moves[moves0:rows[i + 1][5] if i + 1 < len(rows) else len(moves)]
        moved = sum(n for _, _, n in mine)
        busy = sum(b - a for a, b, _ in mine)
        span = (max(b for _, b, _ in mine) - min(a for a, _, _ in mine)) if mine else 0.0
        beside = f"the next training step {next_train_s:.3f} s beside it, " if next_train_s is not None else ""
        print(f"continuous step {step}: blocked {blocked:.3f} s (step_overhead_s {over_s:.3f} s over {over_n}; "
              f"encode_leaf's copies to the host {encode_s:.3f} s of it; {promoting} promotion jobs queued or "
              f"running as it began); replication lag {lag_s:.3f} s "
              f"({lag_n} job), {beside}{wait_s:.3f} s of it still running after that; replicated "
              f"{d[tts.obs.CONTINUOUS_CHUNKS_REPLICATED]} chunks, {d[tts.obs.CONTINUOUS_BYTES_REPLICATED]} bytes "
              f"over both targets; skipped {d[tts.obs.CONTINUOUS_CHUNKS_SKIPPED]} chunks, "
              f"{d[tts.obs.CONTINUOUS_BYTES_SKIPPED]} bytes; {d[tts.obs.TRANSPORT_DEVICE_MOVES]} device moves, "
              f"{moved} bytes in {span:.3f} s ({moved / max(span, 1e-9) / 1e9:.2f} GB/s), "
              f"{moved / max(busy, 1e-9) / 1e9:.2f} GB/s a call ({busy:.3f} s in calls)")
        if step >= 2:
            check(d[tts.obs.CONTINUOUS_BYTES_SKIPPED] >= frozen_bytes,
                  f"step {step} skipped {d[tts.obs.CONTINUOUS_BYTES_SKIPPED]} < the frozen {frozen_bytes} bytes")
    whole = counter_delta(path_before, names)
    check(whole[tts.obs.CONTINUOUS_REPLICATION_ERRORS] == 0,
          f"{whole[tts.obs.CONTINUOUS_REPLICATION_ERRORS]} replication errors")
    check(whole[tts.obs.TRANSPORT_DEVICE_MOVES] == whole[tts.obs.CONTINUOUS_CHUNKS_REPLICATED] > 0
          and whole[tts.obs.TRANSPORT_FALLBACKS] == 0,
          f"device moves {whole[tts.obs.TRANSPORT_DEVICE_MOVES]} against "
          f"{whole[tts.obs.CONTINUOUS_CHUNKS_REPLICATED]} chunks replicated, "
          f"{whole[tts.obs.TRANSPORT_FALLBACKS]} fallbacks")
    check(durable_step == CONTINUOUS_DURABLE_STEP,
          f"the last promoted step is {durable_step}, not {CONTINUOUS_DURABLE_STEP}")
    print(f"continuous: summary {json.dumps(summary)}; path counters {json.dumps(whole)}")

    # recover from the local store into a fresh model and optimizer
    model2, opt2 = fine_tune_state(cfg, seed=CONTINUOUS_SEED + 2)
    fine_tune_step(model2, opt2, batch())
    meta2 = tts.StateDict(step=-1)
    app2 = {"model": model2, "optim": opt2, "meta": meta2}
    cc2 = tts.ContinuousCheckpointer(local_host, durable_root=durable, replica_roots=[standby],
                                     preemption_hook=False)
    try:
        res = cc2.restore_latest(app2)
        differs = state_differs(clones[CONTINUOUS_STEPS], model2, opt2, meta2)
        check(res is not None and res["source"] == "local" and res["step"] == CONTINUOUS_STEPS and differs is None,
              f"local recovery {res}: {differs}")
        check(all(v.is_cuda for v in model2.state_dict().values()), "the recovered model is not on the card")
        tokens = batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = fine_tune_step(model, opt, tokens)
        torch.cuda.synchronize()
        alone_s = time.perf_counter() - t0
        loss2 = fine_tune_step(model2, opt2, tokens)
        check(torch.equal(loss, loss2), f"the recovered next loss {loss2.item()} != {loss.item()}")
        print(f"continuous: recovered step {res['step']} from {res['source']} in {res['seconds']:.3f} s, bitwise; "
              f"next loss {loss.item():.6f} bitwise; that training step alone {alone_s:.3f} s")
        rc, out, err, secs = finish_clis(stats_cli)["stats"]
        check(rc == 0, f"stats exited {rc}: {err[-500:]}")
        roll = json.loads(out)["stores"]["r0"]
        check(roll["head_step"] == CONTINUOUS_STEPS and CONTINUOUS_STEPS in roll["steps_resident"],
              f"stats reported {roll}")
        print(f"continuous: `stats {local_host} --json` exit 0 in {secs} s beside the recovery: head step "
              f"{roll['head_step']}, steps resident {roll['steps_resident']}, {roll['pool_chunks']} chunks, "
              f"{roll['pool_bytes']} bytes")
        # the host and its standby both gone: the durable mirror
        shutil.rmtree(local_host)
        shutil.rmtree(standby)
        res = cc2.restore_latest(app2)
        differs = state_differs(clones[durable_step], model2, opt2, meta2)
        check(res is not None and res["source"] == "durable" and res["step"] == durable_step and differs is None,
              f"durable recovery {res}: {differs}")
        print(f"continuous: with the local and standby roots deleted, recovered step {res['step']} from "
              f"{res['source']} in {res['seconds']:.3f} s, bitwise")
    finally:
        cc2.close()
        shutil.rmtree(durable, ignore_errors=True)
        shutil.rmtree(standby, ignore_errors=True)
        # local_root's own directory (under /dev/shm) or the local root
        shutil.rmtree(os.path.dirname(local_host) if retain == 2 else local_host, ignore_errors=True)
    del model2, opt2, clones


PUBLISH_SEED = 81
PUBLISH_SUB_ID = "chip-smoke-serving"
PUBLISH_CHUNK = 16 << 20  # the chunk store's default chunk
PUBLISH_KEY_TIMEOUT_S = 300.0
PUBLISH_CHILD_POLL_S = 10.0
# the swallowed-exception sites whose count the path holds at 0 (the
# follow loop and the hooks swallow by contract; on the card a failure
# there must still fail the path)
PUBLISH_SITES = ("publish.", "manager.publish", "continuous.publish")


class SwallowedSites:
    """Counts ``obs.swallowed_exception`` calls by site, from its debug
    log line (the counter ``exceptions.swallowed`` is one for every
    site)."""

    def __init__(self):
        import logging

        self.sites = []
        handler = logging.Handler(logging.DEBUG)
        handler.emit = lambda record: (record.msg == "swallowed exception at %s: %r"
                                       and self.sites.append(str(record.args[0])))
        logger = logging.getLogger("torchsnapshot_tpu_torch.obs")
        logger.addHandler(handler)
        logger.setLevel(logging.DEBUG)

    def publish(self):
        return [s for s in self.sites if s.startswith(PUBLISH_SITES)]


def tensor_crc(t):
    """crc32 of a tensor's bytes (a host copy)."""
    from torchsnapshot_tpu_torch.utils.checksums import crc32_fast

    return crc32_fast(t.detach().contiguous().view(torch.uint8).cpu().numpy())


def state_crcs(model):
    """crc32 of every state-dict tensor's bytes, by name (host copies)."""
    return {n: tensor_crc(t) for n, t in model.state_dict().items()}


def wait_key(coord, key, child, timeout_s=PUBLISH_KEY_TIMEOUT_S):
    """The KV value of ``key``; fails the path when ``child`` exits or
    the deadline passes first."""
    deadline = time.monotonic() + timeout_s
    while True:
        value = coord.kv_try_get(key)
        if value is not None:
            return value
        check(child is None or child.poll() is None, f"the publish child exited {child and child.poll()} "
                                                     f"before {key} was set")
        check(time.monotonic() < deadline, f"{key} not set within {timeout_s} s")
        time.sleep(0.01)


def publish_request(cfg, model, tokens):
    """One serving request: the logits on a fixed batch and ring attention
    (ring size 1: K3) on layer-0 q/k/v; returns the crc32 of both outputs'
    bytes."""
    from torchsnapshot_tpu_torch.utils.checksums import crc32_fast

    with torch.no_grad():
        logits = model(tokens)
        q, k, v = restored_layer0_qkv(cfg, model)
        out = ring_attention(q, k, v, causal=True)
    check(bool(torch.isfinite(out).all()) and out.shape == q.shape, "ring attention output malformed")
    crc = crc32_fast(logits.contiguous().view(torch.uint8).cpu().numpy())
    return crc32_fast(out.contiguous().view(torch.uint8).cpu().numpy(), crc)


def publish_child(root, kv_dir):
    """The serving side of the publish path: a differently seeded
    ``TransformerLM`` on the card under ``Subscriber(...).follow()``, a
    request thread answering requests under ``live.pinned()``; after each
    swap the follow thread checks every tensor against the trainer's
    posted crcs and records that generation's request digest.  Prints a
    ``publish result`` JSON line when the trainer says it is done."""
    import threading

    from torchsnapshot_tpu_torch.coordination import FileCoordinator
    from torchsnapshot_tpu_torch.publish import Subscriber

    if not torch.cuda.is_available():
        print("publish child: no CUDA device", file=sys.stderr)
        return 2
    swallowed = SwallowedSites()
    cfg = TransformerConfig(n_layers=N_LAYERS)
    torch.manual_seed(PUBLISH_SEED + 1)
    model = TransformerLM(cfg, device="cuda").requires_grad_(False)
    g = torch.Generator(device="cuda").manual_seed(PUBLISH_SEED + 2)
    tokens = torch.randint(0, cfg.vocab, (1, 128), device="cuda", generator=g)
    coord = FileCoordinator(kv_dir, 1, 2)
    for table in (device_pack.LAUNCHES, flash_attention.LAUNCHES):
        for k in table:
            table[k] = 0
    before = _counter_snapshot()
    # a watch longer than the trainer's gap between publications: every
    # swap arrives through the announce (with the 2 s default a watch can
    # time out between the HEAD's write and its announce, and the durable
    # poll then delivers the step: a fallback poll)
    sub = Subscriber(root, {"model": model}, coordinator=coord, sub_id=PUBLISH_SUB_ID, strict=False,
                     poll_s=PUBLISH_CHILD_POLL_S)
    swaps, verdicts, ref_digest, served = {}, {}, {}, []
    applying = threading.Event()
    stop = threading.Event()
    real_fetch, real_apply, real_account = sub._fetch, sub.live.apply, sub._account

    def timed_fetch(record, plan):
        t0 = time.perf_counter()
        out = real_fetch(record, plan)
        swaps[int(record["step"])] = {"fetch_s": time.perf_counter() - t0}
        return out

    def timed_apply(record, plan, fetched, strict=True):
        live = sub.live
        basis0 = (live.basis_copies, live.basis_bytes, live.basis_s)
        applying.set()
        try:
            return real_apply(record, plan, fetched, strict=strict)
        finally:
            applying.clear()
            swaps[int(record["step"])]["basis"] = [live.basis_copies - basis0[0], live.basis_bytes - basis0[1],
                                                   live.basis_s - basis0[2]]

    def account(record, plan, apply_s):
        row = swaps[int(record["step"])]
        row.update(source=record["source"], apply_s=apply_s, lag_s=time.time() - float(record["t"]),
                   stats=dict(plan.stats), fetched_leaves=sorted({f.leaf for f in plan.fetches}))
        real_account(record, plan, apply_s)

    sub._fetch, sub.live.apply, sub._account = timed_fetch, timed_apply, account

    def on_swap(step, gen):
        want = json.loads(wait_key(coord, f"publish/crc/{step}", None))
        got = state_crcs(model)
        with sub.live.pinned():
            ref_digest[gen] = publish_request(cfg, model, tokens)
        bad = sorted(n for n in want if got.get(n) != want[n])
        verdicts[step] = {"gen": gen, "bad": bad[:3], "n": len(want)}
        coord.kv_set(f"publish/ack/{step}", json.dumps(verdicts[step]))

    def serve():
        while not stop.is_set():
            t0 = time.perf_counter()
            during = applying.is_set()
            with sub.live.pinned() as (step, gen):
                waited = time.perf_counter() - t0
                digest = publish_request(cfg, model, tokens) if step is not None else None
            if digest is None:
                stop.wait(0.05)  # nothing published yet: no model to serve
                continue
            served.append((gen, digest, waited, during or applying.is_set()))
            time.sleep(0.002)  # the swap's turn at the lock

    handle = sub.follow(on_swap=on_swap)
    server = threading.Thread(target=serve, name="publish-requests", daemon=True)
    server.start()
    try:
        wait_key(coord, "publish/done", None, timeout_s=1200)
    finally:
        stop.set()
        server.join(timeout=60)
        handle.stop(timeout_s=30)
        sub.close()
    check(not server.is_alive() and not handle.alive, "the request or follow thread outlived its deadline")
    torn = [(gen, d) for gen, d, _, _ in served if ref_digest.get(gen) != d]
    d = counter_delta(before, (tts.obs.PUBLISH_WATCH_ERRORS, tts.obs.PUBLISH_FALLBACK_POLLS,
                               tts.obs.PUBLISH_LEAVES_SKIPPED, tts.obs.PUBLISH_SUB_CHUNKS_REUSED,
                               tts.obs.PUBLISH_SUB_SWAPS))
    out = {
        "rank": 1, "swaps": swaps, "verdicts": verdicts, "requests": len(served),
        "torn": len(torn), "torn_examples": torn[:3],
        "served_during_swaps": sum(1 for *_, during in served if during),
        "max_pinned_wait_s": max((w for _, _, w, _ in served), default=0.0),
        "counters": d, "swallowed_publish": swallowed.publish(),
        "launches": {**dict(device_pack.LAUNCHES), **dict(flash_attention.LAUNCHES)},
    }
    print("publish result " + json.dumps(out), flush=True)
    return 0


def start_publish_child(work):
    """Start the publish path's serving child (``--publish-child``); it
    waits for the first publication.  Started before the continuous path,
    so its 8-10 s to reach the card and build its model run beside it."""
    job = {"root": os.path.join(work, "publish"), "kv": os.path.join(work, "publish_kv"),
           "log": open(os.path.join(work, "publish_child.log"), "w+")}
    os.makedirs(job["kv"], exist_ok=True)
    job["child"] = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--publish-child", job["root"], job["kv"]],
        stdout=job["log"], stderr=subprocess.STDOUT, text=True,
    )
    return job


def stop_publish_child(job):
    child = job["child"]
    if child.poll() is None:
        child.kill()
        child.wait()


def phase_publish(cfg, work, job):
    """Live-weight publication at full width (path m): the lifecycle
    fine-tune publishes to the serving child of ``start_publish_child``,
    which hot-swaps under requests (see the module docstring)."""
    from torchsnapshot_tpu_torch.coordination import FileCoordinator
    from torchsnapshot_tpu_torch.publish import Publisher, root_rollup
    from torchsnapshot_tpu_torch.tier.promoter import drain_promotions

    root, kv_dir, log, child = job["root"], job["kv"], job["log"], job["child"]
    swallowed = SwallowedSites()
    try:
        model, opt = fine_tune_state(cfg, seed=PUBLISH_SEED)
        g = torch.Generator(device="cuda").manual_seed(PUBLISH_SEED + 3)
        frozen = {"model/embed.weight", "model/lm_head.weight"}
        frozen_bytes = nbytes(model.embed.weight) + nbytes(model.lm_head.weight)
        frozen_chunks = sum(-(-nbytes(t) // PUBLISH_CHUNK) for t in (model.embed.weight, model.lm_head.weight))
        total = sum(nbytes(t) for t in model.state_dict().values())
        changed = total - frozen_bytes
        coord = FileCoordinator(kv_dir, 0, 2)
        pub = Publisher(root, coordinator=coord, chunk_size_bytes=PUBLISH_CHUNK)
        timing = {}
        real_snapshot, real_continuous = pub.publish_snapshot, pub.publish_continuous

        def timed(fn, step):
            def run(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                timing[step] = time.perf_counter() - t0
                return out
            return run

        before = _counter_snapshot()
        rows = []

        t_prev = [time.perf_counter()]

        def published(step, source, seconds):
            t0 = time.perf_counter()
            coord.kv_set(f"publish/crc/{step}", json.dumps(state_crcs(model)))
            crc_s = time.perf_counter() - t0
            ack = json.loads(wait_key(coord, f"publish/ack/{step}", child))
            check(not ack["bad"], f"publish step {step}: subscriber tensors {ack['bad']} differ from the trainer's")
            stats = root_rollup(root)["stats"]
            now = time.perf_counter()
            rows.append((step, source, seconds, stats, crc_s, dict(pub.last_state_s) if source == "state" else {},
                         now - t_prev[0]))
            t_prev[0] = now

        def batch():
            return torch.randint(0, cfg.vocab, (1, 129), device="cuda", generator=g)

        for step in (1, 2, 3):
            if step > 1:
                fine_tune_step(model, opt, batch())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pub.publish_state({"model": model}, step)
            published(step, "state", time.perf_counter() - t0)
        fine_tune_step(model, opt, batch())
        pub.publish_snapshot = timed(real_snapshot, 4)
        mgr = tts.SnapshotManager(os.path.join(work, "publish_ckpt"), publisher=pub)
        t0 = time.perf_counter()
        mgr.save({"model": model, "optim": opt}, step=4)
        save_s = time.perf_counter() - t0
        check(4 in timing, "the manager's save published nothing")
        published(4, "snapshot", timing[4])
        pub.publish_continuous = timed(real_continuous, "c")
        # the host and standby stores under /dev/shm when it has room, as
        # the continuous path's local store
        local_host, _, _ = local_root(work, 6 * total, "publish_local")
        cc = tts.ContinuousCheckpointer(
            local_host, durable_root=os.path.join(work, "publish_durable"),
            replica_roots=[os.path.join(os.path.dirname(local_host), "publish_standby")], promote_every_n=1,
            chunk_size_bytes=PUBLISH_CHUNK, preemption_hook=False, publisher=pub,
        )
        try:
            for step in (5, 6):
                fine_tune_step(model, opt, batch())
                timing.pop("c", None)
                check(cc.step({"model": model}, step), f"continuous step {step} was not recorded")
                cc.drain()
                drain_promotions(timeout_s=600)
                check(cc.last_durable_step() == step and "c" in timing,
                      f"continuous step {step}: durable step {cc.last_durable_step()}, published {'c' in timing}")
                published(step, "continuous", timing["c"])
        finally:
            cc.close()
            if local_host.startswith("/dev/shm"):
                shutil.rmtree(os.path.dirname(local_host), ignore_errors=True)
        stats_cli = start_clis((("stats", ["stats", root]),), os.path.join(work, "publish_cli"))
        coord.kv_set("publish/done", "1")
        try:
            child.wait(timeout=120)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
        pub.close()
        d = counter_delta(before, (tts.obs.PUBLISH_RECORDS, tts.obs.PUBLISH_ANNOUNCE_FAILURES,
                                   tts.obs.PUBLISH_BYTES_DELTA))
    finally:
        stop_publish_child(job)
        log.seek(0)
        text = log.read()
        log.close()
    results = [json.loads(line[len("publish result "):]) for line in text.splitlines()
               if line.startswith("publish result ")]
    if child.returncode != 0 or not results:
        print(text[-4000:])
    check(child.returncode == 0 and results, f"the publish child exited {child.returncode} with no result")
    res = results[0]
    rc, out, err, secs = finish_clis(stats_cli)["stats"]
    check(rc == 0 and f"{PUBLISH_SUB_ID}: step 6 (lag 0 steps" in out, f"stats exited {rc}: {out[-500:]} {err[-500:]}")
    print(f"publish: state {total} bytes ({frozen_bytes} frozen, {changed} changed a step); `stats {root}` exit 0 "
          f"in {secs} s beside the child's end: {out.strip().splitlines()[-1].strip()}")
    for step, source, seconds, stats, crc_s, phases, wall_s in rows:
        sw = res["swaps"][str(step)]
        st = sw["stats"]
        basis = sw["basis"]
        print(f"publish step {step} ({source}): publish {seconds:.3f} s"
              + (f" (encode_leaf's copies {phases['encode']:.3f} s, digests {phases['digest']:.3f} s, pool writes "
                 f"{phases['write']:.3f} s)" if phases else "")
              + (f" in a {save_s:.3f} s manager save" if source == "snapshot" else "")
              + f"; bytes_delta {stats['bytes_delta']} of {stats['bytes_total']} ({stats['chunks_delta']}/"
              f"{stats['chunks_total']} chunks); subscriber fetched {st['bytes_fetch']} bytes "
              f"({st['chunks_fetch']} chunks, {st['chunks_reused']} reused) in {sw['fetch_s']:.3f} s, apply "
              f"{sw['apply_s']:.3f} s (staging basis: {basis[0]} device-to-host copies, {basis[1]} bytes, "
              f"{basis[2]:.3f} s), lag {sw['lag_s']:.3f} s from the record's t to the swap; the trainer's crcs "
              f"{crc_s:.3f} s; {wall_s:.3f} s on the path since the last acknowledgement (the training step, "
              f"the publication, both sides' crcs)")
        if source == "state" and step > 1 or source == "continuous" and step > 5:
            check(st["chunks_reused"] >= frozen_chunks and not frozen & set(sw["fetched_leaves"]),
                  f"publish step {step}: the frozen leaves' {frozen_chunks} chunks were fetched "
                  f"({st['chunks_reused']} reused)")
            if source == "state":
                n_changed = len(sw["fetched_leaves"])
                check(st["bytes_fetch"] <= changed + n_changed * PUBLISH_CHUNK,
                      f"publish step {step}: fetched {st['bytes_fetch']} > {changed} changed bytes + one chunk "
                      f"for each of {n_changed} leaves")
    c = res["counters"]
    print(f"publish: {res['requests']} requests served, each checked against its generation's digest "
          f"({res['torn']} torn), {res['served_during_swaps']} while a swap was in flight, longest wait for "
          f"pinned() {res['max_pinned_wait_s']:.3f} s; subscriber counters {json.dumps(c)}; trainer counters "
          f"{json.dumps(d)}")
    check(res["torn"] == 0 and res["requests"] > 0, f"{res['torn']} torn requests: {res['torn_examples']}")
    check(sorted(res["verdicts"]) == [str(s) for s in range(1, 7)], f"verdicts for steps {sorted(res['verdicts'])}")
    check(c[tts.obs.PUBLISH_FALLBACK_POLLS] == 0, f"{c[tts.obs.PUBLISH_FALLBACK_POLLS]} fallback polls")
    check(c[tts.obs.PUBLISH_WATCH_ERRORS] == 0 and d[tts.obs.PUBLISH_ANNOUNCE_FAILURES] == 0,
          f"watch errors {c[tts.obs.PUBLISH_WATCH_ERRORS]}, announce failures "
          f"{d[tts.obs.PUBLISH_ANNOUNCE_FAILURES]}")
    check(not res["swallowed_publish"] and not swallowed.publish(),
          f"swallowed at publish sites: {res['swallowed_publish']} {swallowed.publish()}")
    check(c[tts.obs.PUBLISH_LEAVES_SKIPPED] > 0 and d[tts.obs.PUBLISH_RECORDS] == 6,
          f"{c[tts.obs.PUBLISH_LEAVES_SKIPPED]} leaves skipped, {d[tts.obs.PUBLISH_RECORDS]} records")
    for name in ("publish", "publish_kv", "publish_ckpt", "publish_local", "publish_durable", "publish_standby"):
        shutil.rmtree(os.path.join(work, name), ignore_errors=True)
    return {k: v for k, v in res["launches"].items()}


WORKLOADS_SEED = 91
WORKLOADS_BATCH = 4096  # DLRM's and the pipeline's batch
WORKLOADS_GROUP_TIMEOUT_S = 300  # the children's process group: every exchange's deadline
PIPELINE_D = 4096  # the transformer's d_model
PIPELINE_MICRO = 4
RING_HEADS, RING_HEAD_DIM = 32, 128


def dlrm_batch(cfg, seed):
    """A batch of ``WORKLOADS_BATCH`` on the card, ids uniform over each
    table's rows (as ``tests/test_dlrm.py`` draws them), from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b = WORKLOADS_BATCH
    dense = torch.from_numpy(rng.standard_normal((b, cfg.dense_in)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, cfg.table_rows, size=(b, len(cfg.table_rows))).astype(np.int64))
    labels = torch.from_numpy(rng.integers(0, 2, size=(b,)).astype(np.float32))
    return dense.cuda(), ids.cuda(), labels.cuda()


def pipeline_inputs():
    g = torch.Generator().manual_seed(WORKLOADS_SEED + 21)
    x = torch.randn((WORKLOADS_BATCH, PIPELINE_D), generator=g).cuda()
    return x, torch.zeros_like(x)


def ring_inputs(world):
    """Global q, k, v [1, world * SEQ, heads, head dim] (bf16) and the
    cotangent (f32), drawn on the card from a fixed seed."""
    g = torch.Generator(device="cuda").manual_seed(WORKLOADS_SEED + 30)
    shape = (1, world * SEQ, RING_HEADS, RING_HEAD_DIM)
    q, k, v = (torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16) for _ in range(3))
    return q, k, v, torch.randn(shape, device="cuda", generator=g)


def workloads_child(rank, world, port, root):
    """One rank of the workloads path (see ``phase_workloads``); prints
    one ``workloads result`` JSON line, exits non-zero on a failure."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from torchsnapshot_tpu_torch.models import dlrm
    from torchsnapshot_tpu_torch.parallel import collectives
    from torchsnapshot_tpu_torch.parallel import pipeline as pp
    from torchsnapshot_tpu_torch.preparers.sharded import box_at

    if not torch.cuda.is_available():
        print("workloads child: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=WORKLOADS_GROUP_TIMEOUT_S))
    coord = tts.get_default_coordinator()
    for table in (device_pack.LAUNCHES, flash_attention.LAUNCHES):
        for k in table:
            table[k] = 0
    written = lambda: tts.obs.counters().get(tts.obs.BYTES_WRITTEN, 0)  # noqa: E731
    out = {"rank": rank, "group_timeout_s": collectives.group_timeout().total_seconds()}
    check(out["group_timeout_s"] == WORKLOADS_GROUP_TIMEOUT_S,
          f"rank {rank}: exchanges bounded by {out['group_timeout_s']} s, not the group's {WORKLOADS_GROUP_TIMEOUT_S}")

    # 1. DLRM at full width, tables row-sharded over "ep"
    t_part = time.perf_counter()
    cfg = dlrm.DLRMConfig()
    mesh = DeviceMesh("cuda", list(range(world)), mesh_dim_names=("ep",))
    model, opt = dlrm.make_train_state(cfg, seed=WORKLOADS_SEED, mesh=mesh, device="cuda")
    local = {n: p.to_local() for n, p in model.named_parameters()}
    rank_bytes = sum(nbytes(t) for t in local.values()) + sum(
        nbytes(opt.state[p]["sum"].to_local()) for p in model.parameters())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [float(dlrm.train_step(model, opt, *dlrm_batch(cfg, WORKLOADS_SEED + 1 + i))) for i in range(3)]
    torch.cuda.synchronize()
    steps_s = time.perf_counter() - t0
    check(all(math.isfinite(x) for x in losses), f"rank {rank}: DLRM losses {losses}")
    w0 = written()
    k1 = device_pack.LAUNCHES["slab_pack"]
    t0 = time.perf_counter()
    tts.Snapshot.take(os.path.join(root, "dlrm"), {"model": model, "optim": opt}, coordinator=coord)
    take_s = time.perf_counter() - t0
    shards = {}
    for n, p in model.named_parameters():
        offsets, sizes = box_at(tuple(p.shape), mesh.shape, mesh.get_coordinate(), p.placements)
        shards[n] = [offsets[0] if offsets else 0, sizes[0] if sizes else 0, tensor_crc(p.to_local()),
                     tensor_crc(opt.state[p]["sum"].to_local())]
    with torch.no_grad():
        next_loss = float(dlrm.loss_fn(model, *dlrm_batch(cfg, WORKLOADS_SEED + 9)))
    out["dlrm"] = {"losses": losses, "steps_s": steps_s, "take_s": take_s, "take_bytes": written() - w0,
                   "rank_state_bytes": rank_bytes, "k1": device_pack.LAUNCHES["slab_pack"] - k1,
                   "shards": shards, "next_loss": next_loss, "s": time.perf_counter() - t_part}
    del model, opt, local
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the pipeline at the transformer's width, one stage a rank
    t_part = time.perf_counter()
    mesh = DeviceMesh("cuda", list(range(world)), mesh_dim_names=("pp",))
    group = mesh.get_group("pp")
    full = pp.init_pipeline_params(world, PIPELINE_D, seed=WORKLOADS_SEED + 20, device="cuda")
    params = pp.shard_pipeline_params(full, mesh)
    x, y = pipeline_inputs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pp.pipeline_forward(params, x, mesh, n_microbatches=PIPELINE_MICRO)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    want = pp.sequential_forward(full, x)
    fwd_err = float((got - want).abs().max()) / float(want.abs().max())
    check(fwd_err <= 1e-4, f"rank {rank}: pipeline_forward vs sequential {fwd_err} beyond 1e-4 of the largest output")
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = torch.mean((pp.pipeline_forward(p, x, mesh, n_microbatches=PIPELINE_MICRO) - y) ** 2)
    grads = torch.autograd.grad(loss, [p["w"], p["b"]])
    f = {k: v.detach().requires_grad_() for k, v in full.items()}
    ref = torch.autograd.grad(torch.mean((pp.sequential_forward(f, x) - y) ** 2), [f["w"], f["b"]])
    grad_errs = []
    for name, g, r in zip("wb", grads, ref):
        e = float((g.to_local()[0] - r[rank]).abs().max()) / float(r.abs().max())
        check(e <= 1e-4, f"rank {rank}: pipeline d{name} vs sequential autograd {e} beyond 1e-4")
        grad_errs.append(e)
    del p, f, grads, ref, loss
    q, pipe_losses = params, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        q, step_loss = pp.pipeline_train_step(q, x, y, mesh, n_microbatches=PIPELINE_MICRO)
        pipe_losses.append(float(step_loss))
    steps_pp_s = time.perf_counter() - t0
    check(pipe_losses[-1] < pipe_losses[0], f"rank {rank}: pipeline losses {pipe_losses}")
    # every rank's copy of the trained stack: the other stage comes round the ring
    stages = {k: [None] * world for k in ("w", "b")}
    for k in ("w", "b"):
        mine = q[k].to_local()
        stages[k][rank] = mine
        for shift in range(1, world):
            stages[k][(rank - shift) % world] = collectives.exchange(mine, group, shift)
    trained = {k: torch.cat(v) for k, v in stages.items()}
    w0 = written()
    t0 = time.perf_counter()
    tts.Snapshot.take(os.path.join(root, "pipeline"), {"pp": tts.StateDict(w=q["w"], b=q["b"])},
                      coordinator=coord)
    pipe_take_s = time.perf_counter() - t0
    out["pipeline"] = {
        "forward_s": forward_s, "forward_err": fwd_err, "grad_errs": grad_errs, "losses": pipe_losses,
        "steps_s": steps_pp_s, "take_s": pipe_take_s, "take_bytes": written() - w0,
        "stage_bytes": nbytes(q["w"].to_local()) + nbytes(q["b"].to_local()),
        "stage_crcs": [tensor_crc(q["w"].to_local()), tensor_crc(q["b"].to_local())],
        "sequential_crc": tensor_crc(pp.sequential_forward(trained, x)), "s": time.perf_counter() - t_part,
    }
    del full, params, q, trained, stages, got, want, x, y
    gc.collect()
    torch.cuda.empty_cache()

    # 3. ring attention at ring size 2
    t_part = time.perf_counter()
    qg, kg, vg, ct = ring_inputs(world)
    cut = slice(rank * SEQ, (rank + 1) * SEQ)
    ql, kl, vl = (t[:, cut].contiguous().requires_grad_() for t in (qg, kg, vg))
    del qg, kg, vg
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o = ring_attention(ql, kl, vl, causal=True)
    torch.cuda.synchronize()
    ring_fwd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grads = torch.autograd.grad((o.float() * ct[:, cut]).sum(), (ql, kl, vl))
    torch.cuda.synchronize()
    ring_bwd_s = time.perf_counter() - t0
    check(all(g is not None and bool(torch.isfinite(g).all()) for g in grads), f"rank {rank}: ring gradient")
    torch.save({"out": o.detach().cpu(), **{f"d{n}": g.cpu() for n, g in zip("qkv", grads)}},
               os.path.join(root, f"ring{rank}.pt"))
    out["ring"] = {"forward_s": ring_fwd_s, "backward_s": ring_bwd_s, "s": time.perf_counter() - t_part}
    out["launches"] = {**dict(device_pack.LAUNCHES), **dict(flash_attention.LAUNCHES)}
    print("workloads result " + json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


def start_workloads_children(work):
    """The workloads path's two ranks, started gated before the path."""
    return start_ranks("--workloads-child", os.path.join(work, "workloads"), gated=True)


def phase_workloads(work, job):
    """The workloads path (DLRM, the pipeline and ring attention over two
    ranks; see the module docstring, path n).  Returns the children's
    launches."""
    from torchsnapshot_tpu_torch.models import dlrm
    from torchsnapshot_tpu_torch.parallel import pipeline as pp

    root = os.path.join(work, "workloads")
    card = card_line()
    t0 = time.perf_counter()
    results = finish_ranks(job, timeout_s=600)
    children_s = time.perf_counter() - t0
    print(f"workloads ({card}): two ranks on the card over gloo, {children_s:.1f} s from their release to both "
          f"exits; "
          f"group timeout {results[0]['group_timeout_s']} s")
    read = lambda: tts.obs.counters().get(tts.obs.BYTES_READ, 0)  # noqa: E731

    # 1. DLRM restored at world 1 into a differently seeded model
    cfg = dlrm.DLRMConfig()
    d = [r["dlrm"] for r in results]
    model, opt = dlrm.make_train_state(cfg, seed=WORKLOADS_SEED + 5, device="cuda")
    before = dict(device_pack.LAUNCHES)
    r0 = read()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tts.Snapshot(os.path.join(root, "dlrm")).restore({"model": model, "optim": opt})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restored_bytes = read() - r0
    # every box is sharded (Replicate DTensors too, as every multi-device
    # array is in the JAX package) and lands f32 into f32 by a plain
    # host-to-device copy: K2 takes dense slab members only, K6 casts
    restore_launches = {k: device_pack.LAUNCHES[k] - before[k] for k in before}
    for n, p in model.named_parameters():
        for r in d:
            row0, rows, crc_p, crc_s = r["shards"][n]
            check(tensor_crc(p.detach()[row0:row0 + rows]) == crc_p, f"DLRM {n} rows {row0}+{rows} differ")
            check(tensor_crc(opt.state[p]["sum"][row0:row0 + rows]) == crc_s, f"DLRM {n}'s sum differs")
    with torch.no_grad():
        loss = float(dlrm.loss_fn(model, *dlrm_batch(cfg, WORKLOADS_SEED + 9)))
    check(abs(loss - d[0]["next_loss"]) <= 1e-5 * abs(d[0]["next_loss"]),
          f"DLRM next loss {loss} at world 1 against {d[0]['next_loss']} at world 2")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"workloads dlrm ({card}): DLRMConfig() f32, {n_params} parameters, Adagrad; tables Shard(0) over 'ep' "
          f"of 2; {[r['rank_state_bytes'] for r in d]} bytes of state a rank; 3 steps of batch {WORKLOADS_BATCH} "
          f"{[round(r['steps_s'], 3) for r in d]} s, losses {d[0]['losses']}; take at world 2 "
          f"{[round(r['take_s'], 3) for r in d]} s, {[r['take_bytes'] for r in d]} bytes, K1 launches "
          f"{[r['k1'] for r in d]}; restore at world 1 {restore_s:.3f} s, {restored_bytes} bytes, launches "
          f"{json.dumps(restore_launches)}; every table and accumulator bitwise the shards; next loss "
          f"{loss!r} against {d[0]['next_loss']!r} at world 2; part {[round(r['s'], 1) for r in d]} s a rank")
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the pipeline's stage weights restored replicated
    pl = [r["pipeline"] for r in results]
    dest = tts.StateDict(w=torch.zeros((2, PIPELINE_D, PIPELINE_D), device="cuda"),
                         b=torch.zeros((2, PIPELINE_D), device="cuda"))
    r0 = read()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tts.Snapshot(os.path.join(root, "pipeline")).restore({"pp": dest})
    torch.cuda.synchronize()
    pipe_restore_s = time.perf_counter() - t0
    pipe_bytes = read() - r0
    for rank, r in enumerate(pl):
        check([tensor_crc(dest["w"][rank]), tensor_crc(dest["b"][rank])] == r["stage_crcs"],
              f"pipeline stage {rank} restored other bits")
    x, _ = pipeline_inputs()
    seq_crc = tensor_crc(pp.sequential_forward(dest, x))
    check(all(seq_crc == r["sequential_crc"] for r in pl), "sequential_forward on the restored weights differs")
    print(f"workloads pipeline ({card}): d_model {PIPELINE_D}, 2 stages one a rank ({pl[0]['stage_bytes']} bytes "
          f"a stage), batch {WORKLOADS_BATCH} in {PIPELINE_MICRO} microbatches, f32; forward "
          f"{[round(r['forward_s'], 4) for r in pl]} s, max error / max |sequential| "
          f"{max(r['forward_err'] for r in pl):.3e}; gradients vs sequential autograd (w, b) "
          f"{[[float(f'{e:.3e}') for e in r['grad_errs']] for r in pl]}; 3 train steps "
          f"{[round(r['steps_s'], 3) for r in pl]} s, losses {pl[0]['losses']}; take {[round(r['take_s'], 3) for r in pl]} "
          f"s, {[r['take_bytes'] for r in pl]} bytes; restored replicated {pipe_restore_s:.3f} s, {pipe_bytes} bytes, "
          f"stages bitwise, sequential_forward bitwise the ranks'; part {[round(r['s'], 1) for r in pl]} s a rank")
    del dest, x
    gc.collect()
    torch.cuda.empty_cache()

    # 3. ring attention at ring size 2 against f32 dense attention, computed once
    rg = [r["ring"] for r in results]
    q, k, v, ct = ring_inputs(2)
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    del q, k, v
    dense = dense_attention(qf, kf, vf, causal=True)
    want = torch.autograd.grad((dense * ct).sum(), (qf, kf, vf))
    dense = dense.detach()
    del qf, kf, vf, ct
    errs = []
    for rank in range(2):
        shard = torch.load(os.path.join(root, f"ring{rank}.pt"))
        cut = slice(rank * SEQ, (rank + 1) * SEQ)
        got = shard["out"].cuda()
        check(got.shape == (1, SEQ, RING_HEADS, RING_HEAD_DIM) and bool(torch.isfinite(got).all()),
              f"ring rank {rank}: output malformed")
        err = float((got.float() - dense[:, cut]).abs().max())
        check(err <= 2e-2, f"ring rank {rank}: output vs f32 dense {err} beyond 2e-2")
        rels = []
        for n, w in zip("qkv", want):
            g = shard[f"d{n}"].cuda()
            rel = float((g.float() - w[:, cut]).abs().max()) / float(w.abs().max())
            check(rel <= 3e-2, f"ring rank {rank}: d{n} error {rel} beyond 3e-2 of the largest gradient")
            rels.append(rel)
        errs.append((err, rels))
    del dense, want
    gc.collect()
    torch.cuda.empty_cache()
    print(f"workloads ring ({card}): ring size 2, b 1, {SEQ} positions a rank, {RING_HEADS} heads, d "
          f"{RING_HEAD_DIM}, bf16, causal; forward {[round(r['forward_s'], 4) for r in rg]} s, backward "
          f"{[round(r['backward_s'], 4) for r in rg]} s a rank; output max abs err vs f32 dense "
          f"{[float(f'{e:.3e}') for e, _ in errs]}, gradient error / max |gradient| (q, k, v) "
          f"{[[float(f'{x:.3e}') for x in rels] for _, rels in errs]}; launches {[r['launches'] for r in results]}")
    others = {}
    for r in results:
        for key, val in r["launches"].items():
            others[key] = others.get(key, 0) + val
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(all(r["launches"][key] > 0 for r in results), f"a workloads rank launched no {key}")
    shutil.rmtree(root, ignore_errors=True)
    return others


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    kernels.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    # the fast-I/O engine with the knobs at their defaults: a library that
    # does not build raises here
    from torchsnapshot_tpu_torch import _csrc

    t0 = time.perf_counter()
    check(_csrc.enabled_lib() is not None and tts.knobs.fastio_enabled(),
          "the native fast-I/O library is off at the knobs' defaults")
    print(f"native fast-I/O library: {_csrc.LOADED['path']} (g++ flags '{_csrc.LOADED['flags']}'), "
          f"built or loaded in {time.perf_counter() - t0:.1f} s")
    for name, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "warning", "C75")):
                print(f"ptxas {name}: {line.strip()}")
        # the Hopper kernels' design rests on neither: a spill or a
        # serialised wgmma (C75xx) is a build that must be looked at
        check("(C75" not in log, f"ptxas serialised wgmma in {name}")
        check(all(" 0 bytes spill stores" in line for line in log.splitlines() if "spill stores" in line),
              f"ptxas spilled registers in {name}")

    cfg = TransformerConfig(n_layers=N_LAYERS)
    torch.manual_seed(0)
    model = TransformerLM(cfg, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params} parameters, {cfg}")

    members = first_device_slab(model)
    slab, mis_members, mis_slab, k1 = phase_k1(members)
    k2 = phase_k2(slab, members, mis_slab, mis_members)
    k6 = phase_k6(cfg)
    k3 = phase_k3()
    k4, k5 = phase_k4_k5()
    del slab, members, mis_members, mis_slab
    torch.cuda.empty_cache()
    records = {r["name"]: r for r in (k1, k2, k3, k4, k5, k6)}
    counters = {
        "slab_pack": (device_pack.LAUNCHES, "slab_pack"),
        "slab_unpack": (device_pack.LAUNCHES, "slab_unpack"),
        "flash_attention_fwd": (flash_attention.LAUNCHES, "flash_fwd"),
        "flash_attention_bwd_dq": (flash_attention.LAUNCHES, "flash_bwd_dq"),
        "flash_attention_bwd_dkv": (flash_attention.LAUNCHES, "flash_bwd_dkv"),
        "tile_update": (device_pack.LAUNCHES, "tile_update"),
    }

    def run_path(name, kernels_expected, fn):
        """``fn`` may return launches made in processes it started, by
        kernel name as their ``LAUNCHES`` tables count them."""
        for table, key in counters.values():
            table[key] = 0
        t_path = time.perf_counter()
        others = fn() or {}
        torch.cuda.synchronize()
        counts = {n: table[key] + others.get(key, 0) for n, (table, key) in counters.items()}
        print(f"path {name}: launches {json.dumps(counts)}; {time.perf_counter() - t_path:.1f} s")
        for n in kernels_expected:
            check(counts[n] > 0, f"{n} was not launched on the {name} path")
        for n, c in counts.items():
            records[n]["launches"] += c

    tokens = torch.randint(0, cfg.vocab, (1, 129), device="cuda")
    opt = adamw_step(model, tokens)
    restored = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        snap_dir = os.path.join(work, "snap")

        def serving():
            restored["model"] = phase_main_path(cfg, model, opt, snap_dir)
            phase_attention(cfg, restored["model"])

        run_path("serving", ("slab_pack", "slab_unpack", "flash_attention_fwd"), serving)
        run_path("fastio", ("slab_pack", "slab_unpack"), lambda: phase_fastio(cfg, model, opt, work))
        run_path("trace", ("slab_pack", "slab_unpack", "tile_update"), lambda: phase_trace(cfg, model, opt, work))
        run_path("stripe_codec", ("slab_pack", "slab_unpack", "tile_update"),
                 lambda: phase_stripe_codec(cfg, model, opt, work))
        gc.collect()
        torch.cuda.empty_cache()
        run_path("ring_gradient", ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
                 lambda: phase_ring_gradient(cfg, restored["model"]))
        run_path("budgeted_reads", ("tile_update",), lambda: phase_budgeted_reads(model, work, snap_dir))
        shutil.rmtree(snap_dir)
        del model, opt, restored
        gc.collect()
        torch.cuda.empty_cache()

        peak_before_training = torch.cuda.max_memory_allocated()
        run_path("resumable_training", ("slab_pack", "slab_unpack"),
                 lambda: phase_resumable_training(cfg, os.path.join(work, "train")))
        host_digest_rate()
        print(f"peak device memory allocated: {peak_before_training} bytes before the training phase, "
              f"{torch.cuda.max_memory_allocated()} bytes in its last step")
        gc.collect()
        torch.cuda.empty_cache()
        run_path("many_ranks", ("slab_pack", "slab_unpack"),
                 lambda: phase_many_ranks(TransformerConfig(n_layers=MANY_RANKS_LAYERS), work))
        gc.collect()
        torch.cuda.empty_cache()
        run_path("sharded", ("slab_pack", "tile_update"), lambda: phase_sharded(cfg, work))
        gc.collect()
        torch.cuda.empty_cache()
        run_path("lifecycle", ("slab_pack", "slab_unpack", "tile_update"), lambda: phase_lifecycle(cfg, work))
        gc.collect()
        torch.cuda.empty_cache()
        run_path("cas_mmap", ("slab_pack", "slab_unpack", "tile_update"), lambda: phase_cas_mmap(cfg, work))
        gc.collect()
        torch.cuda.empty_cache()
        run_path("tier_cache", ("slab_pack", "slab_unpack", "tile_update"), lambda: phase_tier_cache(cfg, work))
        gc.collect()
        torch.cuda.empty_cache()
        run_path("cloud_interop", ("slab_pack", "slab_unpack", "tile_update"),
                 lambda: phase_cloud_interop(cfg, work))
        gc.collect()
        torch.cuda.empty_cache()
        run_path("fleet", ("slab_pack", "slab_unpack", "tile_update"), lambda: phase_fleet(cfg, work))
        gc.collect()
        torch.cuda.empty_cache()
        # neither the publish child nor the workloads ranks (gated: they
        # reach the card, 8-10 s each, and wait for their path) launch
        # anything before their paths
        publish_job = start_publish_child(work)
        workloads_job = start_workloads_children(work)
        try:
            try:
                run_path("continuous", (), lambda: phase_continuous(cfg, work))
                gc.collect()
                torch.cuda.empty_cache()
                run_path("publish", ("slab_pack", "flash_attention_fwd"),
                         lambda: phase_publish(cfg, work, publish_job))
            finally:
                stop_publish_child(publish_job)
            gc.collect()
            torch.cuda.empty_cache()
            run_path("workloads", ("slab_pack", "flash_attention_fwd", "flash_attention_bwd_dq",
                                   "flash_attention_bwd_dkv"), lambda: phase_workloads(work, workloads_job))
        finally:
            stop_ranks(workloads_job)

    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 6 and sys.argv[1] == "--many-ranks-child":
        sys.exit(many_ranks_child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    if len(sys.argv) == 6 and sys.argv[1] == "--tier-cache-child":
        sys.exit(tier_cache_child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    if len(sys.argv) == 6 and sys.argv[1] == "--fleet-child":
        sys.exit(fleet_child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    if len(sys.argv) == 4 and sys.argv[1] == "--publish-child":
        sys.exit(publish_child(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 6 and sys.argv[1] == "--workloads-child":
        wait_child_gate()
        sys.exit(workloads_child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    if len(sys.argv) == 6 and sys.argv[1] == "--sharded-child":
        sys.exit(sharded_child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
