#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MaxMem on one GPU and check it end to end.

    python3 chip_smoke.py

Phases, one line of numbers each:
  1. the card's name and power limit (nvidia-smi), then the kernels' build
     and ptxas's registers and spills for page_move's, hot_bins' and the
     attention kernels;
  2. each CUDA kernel against its plain PyTorch version on the card, at the
     slice's shapes, bit for bit, with its time (20 launches back to back
     between two CUDA events), its device time (profiler), for the
     attention kernels the wrapper's host time per call, the plain
     version's time, one library call's time and device time, and the bound
     (bytes over HBM bandwidth); ``page_move`` and ``hot_bins`` with their
     wrappers' host time per call too; ``page_move`` also at phase 5's two row
     widths, each plan with its entries per class of the kernel's schedule
     (A/B/S, counted on the card and by ``ref.page_move_classes``; the data
     plane's and the KV cache's plans must stage none);
  3. the slice end to end: ``CentralManager`` at 1,048,576 pages with 4 KiB
     of float32 content per page on the card, six colocated tenants, a
     seeded GUPS-style access stream, 32 ``run_epoch`` calls and one
     ``run_epochs(8, ...)``; then every page's bytes read back, the frame
     table, queue conservation, the sentinel words and the hot-set fast
     share are checked, and each kernel's launches on this path counted;
  4. the same manager schedule with exact sampling at 65,536 pages on the
     card and on the CPU, compared leaf by leaf;
  5. the serving slice, ``serve-yi6b``: yi-6b at full width and depth (32
     layers, bf16 weights from a seed) over a bf16 tiered paged KV pool of
     512 fast + 4,096 slow 16-token pages, ``ServingEngine`` at batch 32
     under an ``OpenLoopDriver`` with two tenants, 24 warm-up and 128 timed
     steps; every prefill goes through ``flash_attention``, every decode
     step through ``paged_attention``, every migrating epoch through
     ``page_move``, and the slice's invariants are checked;
  6. the same slice at full width cut to 2 layers in float32, on the card
     and on the CPU with the same weights: logits, greedy tokens, per-step
     access counts, manager state and the slot map compared; for yi-6b and
     for qwen2-moe-a2.7b, whose routings are compared too (gate ids that
     differ per layer, the smallest top-k margin where they do);
  7. ``serve-qwen2moe``: phase 5's serving geometry and tenants with
     qwen2-moe-a2.7b at full width and depth (24 layers, 60 routed experts
     top-4 padded to 64, 4 shared; 28.2 GiB of weights), 16 warm-up and 128
     timed steps, the dropped MoE assignments of each decode step counted
     (of all 32 lanes, and of the lanes holding a request: the idle lanes
     are routed too and take capacity), then one MoE block at the decode
     batch split into routing, expert products, shared experts and the rest
     (dispatch and combine);
  8. ``coloc-legs``: the three placements of
     ``benchmarks/serving_colocation.py`` (maxmem, static, fixed) through
     ``make_serving_manager`` at that benchmark's constants on phase 7's
     weights: migrations only under maxmem, quotas held under fixed, freed
     slots clean; its claim row printed as found;
  9. ``expert-tiering``: ``ExpertTierManager`` over the 1,440 expert pages
     (5.5 MiB rows, a quarter fast) of phase 7's weights, a fixed batch
     through every layer's ``moe_layer_from_pools`` for 64 steps (8
     epochs): every ``page_move`` call all staged (class S), every expert's
     rows bit-equal to its weights wherever it moved, layer 0's output
     unchanged;
 10. ``scenario-1M``: the scenario engine's ``scale_colocation(1,048,576,
     16, 40)`` (12 tenants of 49,152 pages, 4 more from epoch 10 to 30)
     through ``ColocationSim`` with ``policy_chunk`` 4 on phase 3's manager;
     each arriving tenant's pages written through ``page_copy``, the
     conservation invariants after every event and at the end, every live
     page's bytes, queue conservation and the sentinel checked; the epoch's
     wall time split into the manager's calls (tick / sync / execute), its
     control plane, the page writes and checks, and the rest (the
     simulator's host cost model); one more chunk profiled;
 11. ``scenario-gpu-vs-cpu``: the Fig. 4 timeline of
     ``examples/colocation_demo.py`` (3,584 pages, queue 64, bandwidth 8,
     300 epochs) with exact sampling and a 4 KiB page pool, ``policy_chunk``
     1, on the card and on the CPU: epoch records (floats exact), phases,
     every leaf of the final state and the frame table equal; then the same
     timeline under HeMem, AutoNUMA and 2LM with the invariants on, each
     policy's steady-phase LS p99 and throughput printed as found;
 12. ``sweep-64k``: the fleet sweep behind ``BENCH_fleet.json``
     (``benchmarks/dynamic_workload.py:355-410``: 16 machines of 65,536
     pages, a quarter-boundary churn timeline, 4 seeds x 4 budgets, 96
     epochs, ``policy_chunk`` 24, sampled, pipelined) through ``run_sweep``
     on one ``FleetManager`` on the card: wall time, machine-epochs/s, a
     fleet epoch split into the batched tick's host time, the deviates'
     draw, stacking and uploads, the telemetry copy and the 16 simulators'
     host cost model (the parts overlap across the dispatch thread), the
     upload counters, peak memory, one profiled chunk; then the same 16
     points one machine at a time (``ColocationSim(policy_chunk=24)``),
     every record and every final state leaf equal to the fleet's;
 13. ``fleet-gpu-vs-cpu``: the golden fleet trace's three machines on the
     card against ``tests/golden/fleet_trace.json``; a four-point sweep
     with exact counts (4 KiB pages, 40 us epochs) on the card and on the
     CPU, histories and phases equal; the machines axis of
     ``benchmarks/scale_bench.py`` (K = 1, 4, 16, 64 at 65,536 pages): ms
     per machine-epoch and live bytes per machine;
 14. ``autotune-64k``: the autotuner CLI's default search
     (``PolicyAutotuner("thrash")`` at 65,536 pages x 96 epochs, fast
     8,192, queue 4,096, ``policy_chunk`` 8, population 8, generations 4,
     elites 2, seed 0, pipelined) on the card: wall time a generation,
     machine-epochs/s, the fleet epoch split, one profiled chunk, peak
     memory, the winner's knobs against the default (it must weakly
     dominate); then the three profiles ``BENCH_autotune.json`` claims
     (``colocation_64k``, ``thrash_64k``, ``skewshift_64k``) replayed
     default against tuned at their geometry, as found; then the skewshift
     probe (16,384 pages x 64 epochs) with default params and with an
     ``OnlineTuner``: recovery epochs, retunes, ms a burst, the records
     before the first retune equal and the live manager's state and
     generator bit-equal across every burst;
 15. ``tuner-gpu-vs-cpu``: the exact search of
     ``tests/test_torch_autotune.py`` (skewshift, 1,024 pages x 12 epochs,
     population 4, generations 2, ``sample_period`` pinned to 1, 4 KiB
     pages, 40 us epochs) on the card and the CPU, trajectory and winner
     equal; sampled on the card, the same seed twice and a search stopped
     at ``stop_after`` and resumed, equal to the first.
 16. ``train-qwen25-3b``: qwen2.5-3b at full width and depth (36 layers, d
     2,048, 16 heads over 2 KV heads, 3,085,938,688 bf16 parameters from a
     seed, float32 AdamW moments), ``make_train_step(remat="block",
     microbatch=4)`` on batches of 8 x 4,096 tokens from ``SyntheticTokens``
     through ``PrefetchIterator``: one warm-up and 4 timed steps on batch 0,
     each split into host (the batch's copy), forward + backward and the
     optimizer; tokens/s, the model-FLOPs share (``analysis.roofline``'s
     ``model_flops_per_step`` of the step's rows over its time and 989
     TFLOP/s; so for phases 19-21), one step
     profiled, peak memory; loss and grad norm finite, the loss falls, peak
     under 80 GiB;
 17. ``lm-decode``: the same model's prefill of 8 prompts of 1,024 tokens
     (``flash_attention``, counted) into a 1,152-position ``KVCache``, 128
     greedy ``decode_step`` calls under the deferred commit and the eager
     branch fed the same tokens: ms a step, tokens/s, one step's device busy
     time against its bytes bound; the branches' logits within bf16's
     tolerance and their greedy tokens equal for 16 steps; the prompt and
     the first 8 generated tokens, prefilled, predict the 9th; then
     ``flash_attention`` at each shape the two prefills launched it with
     (counted by shape), every lane against its plain version;
 18. ``train-gpu-vs-cpu``: 6 smoke train steps (float32) from one state on
     the card and on the CPU (losses within 1e-4 relative, parameters within
     2e-4); under ``torch.use_deterministic_algorithms(True)``, full width
     cut to 2 layers: 3 steps, ``Checkpointer`` save and restore, 3 steps,
     bit-equal with 6 straight; ``launch.train.main`` on the card, 12 steps
     straight and resumed from step 6, bit-equal.
 19. ``lm-mamba2``: mamba2-130m at full width and depth (24 Mamba2 layers,
     d 768, 24 SSD heads of 64, state 128, chunk 128; 128,983,488 bf16
     parameters from a seed, float32 AdamW moments): phase 16's train step
     on 8 of the ``train_4k`` cell's rows (1 warm-up, 4 timed steps, split
     into host, forward + backward and the optimizer), tokens/s, peak; the
     loss finite and falling. Then 8 prompts of 1,024 tokens prefilled and
     128 greedy ``decode_step`` calls: ms a step p50/p99, tokens/s, one step's
     device busy time against its bytes bound (weights, the states read and
     written); teacher forcing (the prompt and the 8 tokens the decode
     consumed, prefilled, rank the token the decode chose next within bf16's
     tolerance of their top). Then the reference's ``long_500k`` cell: one
     lane prefilled with 1,024 tokens and stepped 32 times alone, one with
     524,288; 32 steps of each in turns, 32 more after ``free_device``, one
     of each profiled, 32 of the short lane after the profiler (neither the
     step's wall time nor its device busy time may grow 1.5x with the
     position; the short lane's steps at each stage tell what else moves
     the host-bound step);
 20. ``lm-zamba2``: zamba2-1.2b at full width and depth (38 Mamba2 layers of
     d 2,048, 64 SSD heads, state 64, chunk 256; 6 invocations of one shared
     attention + MLP block, 32 heads of 64, window 4,096; 1,088,160,640
     parameters): the train step as 19's in 4 microbatches; 8 prompts of
     4,608 tokens prefilled (longer than the window: the KV rings wrap; 6
     ``flash_attention`` launches a prefill), 128 decode steps, teacher
     forcing; then ``flash_attention`` at each shape the prefills launched
     it with (the prompt's and the teacher-forced context's, counted by
     shape), every lane against its plain version, and SDPA with the window
     as a boolean mask;
 21. ``lm-whisper``: whisper-tiny at full width (4 + 4 layers, d 384, 6
     heads of 64, vocabulary 51,865) over 1,500 stub frames from a seed: the
     train step on 32 rows of 448 decoder tokens; ``prefill_cross`` for 32
     lanes (the encoder's 4 non-causal ``flash_attention`` launches), 128
     decode steps from a start token, teacher forcing through
     ``encdec.prefill`` (its decoder's causal self-attention and non-causal
     cross-attention over the 1,500 frames); ``flash_attention`` at each
     shape the prefills launched it with (the encoder's 1,500 x 1,500, the
     decoder's causal 9 x 9 and its cross 9 x 1,500, counted by shape),
     every lane against its plain version, and SDPA;
 22. ``families-gpu-vs-cpu``: each family at full width cut in depth
     (mamba2 2 layers, zamba2 one group of 2 and a tail of 1, whisper 2 + 2)
     in float32, the same weights on the card and the CPU, rows of 256
     tokens (the published chunks): the first batch's gradients, every leaf
     within 1e-4 of its largest entry; 3 train steps, losses and gradient
     norms within 1e-4 relative and finite, parameters within 2e-4 but for
     at most 4 elements of the tied embedding (Adam's steps on gradients
     within float32's noise of zero); then a prefill and 8 decode steps,
     logits within 1e-4 of the largest, and on the card the prefill of the
     tokens the decode consumed equal to its last step within 1e-4;
 23. ``sharded-sweep``: phase 12's sweep (16 machines of 65,536 pages, 96
     epochs) with exact counts (``sample_period`` 1, 4 KiB pages, 40 us
     epochs) through ``run_sweep(devices=["cuda:0", "cpu"])``, 8 machines a
     slice, and through ``devices=["cuda:0"]``: every record and phase
     equal, machine-epochs/s of each, each slice's seconds on the dispatch
     thread and their share of the wall;
 24. ``cost-count``: phase 16's step (qwen2.5-3b at full width and depth,
     its batch 0 of 8 x 4,096 tokens in 4 microbatches) counted on the card
     with ``analysis.hlo_cost.module_cost`` and
     ``analysis.attribution.attribute`` (the contributions adding up),
     priced with ``roofline.compute_terms`` against phase 16's step time,
     the 15 largest contributions by bytes; the same model cut to 2 layers,
     one train step of 1 x 256 tokens and the lm-decode prefill's 8 x 1,024
     prompts, counted on the card and on the CPU (FLOPs and the kernels'
     bytes equal); then the prefill at full depth on the card, the
     counter's ``flash_attention`` calls equal to the launches
     ``flash_tally`` splits by shape. The counted pass also follows the
     live bytes (``analysis.memory``), held against the card's caching
     allocator over the same call: the full-depth step and prefill within
     3% or 256 MiB, the 2-layer step's and prefill's peaks equal on the
     card, the CPU and fake tensors of each, and each launched kernel alone
     (``page_move`` cold and warm) equal to the allocator;
 25. ``mesh-one-card``: an NCCL process group of one rank and the (1, 1)
     ``DeviceMesh`` ("data", "model"). 25a: layer 0's MoE block of phase 7's
     weights (qwen2-moe-a2.7b, full width) through ``moe_mlp_shardmap`` on
     ``DTensor``s against the mesh-less ``moe_mlp``, at the decode batch (32
     tokens) and at one 1,024-token row: gate ids equal, outputs within
     2e-3 relative, aux equal, each timed. 25b: phase 17's prefill
     (qwen2.5-3b, full width and depth, 8 x 1,024) with the parameters
     distributed by ``params_sharding``, under ``use_partitioning``: logits
     and KV cache bit-equal to the mesh-less prefill and the logits to
     phase 17's, ``flash_attention`` launched once a layer on the local
     shards. 25c: a float32 train step at full width cut to 2 layers, the
     state distributed by ``train_state_sharding``, against the mesh-less
     step: loss and every parameter bit-equal. 25d: ``shardmap_int8_psum``
     over the one-rank group bit-equal to the reference's formula;
 26. ``dryrun-cells``: ``python -m repro_torch.launch.dryrun`` on fake cuda
     tensors, one process a cell, started before phase 25 and run beside
     it: the four cells of ``tests/test_dryrun_small.py`` (qwen2.5-3b
     train_4k, qwen2-moe-a2.7b decode_32k and mamba2-130m long_500k on the
     4 x 4 test mesh; yi-6b train_4k on the 2 x 2 x 4 one) and qwen2.5-3b
     train_4k on the 16 x 16 production mesh; each cell's counting wall,
     FLOPs, bytes and collective bytes a device and its roofline terms on
     H100 constants, its argument, output, temporary and peak bytes a device
     beside the card's memory (JSON under ``chiprun_out/dryrun_torch/``);
     FLOPs > 0, a dominant term and integer peak bytes for each, and the
     test-mesh qwen2.5-3b cell's FLOPs
     a device x 16 within 1.0-1.5x of phase 24's unsharded step scaled to
     the cell's 256 rows.
Phases 12-16, 18 and the train steps of 19-22 launch none of the page
and attention kernels (fleet machines have no page pool; the train step's
attention is ``blocked_attention``, which autograd differentiates), and the
fleet's vmapped tick no ``tally``: phase 14's online legs, whose live
manager ticks alone, launch ``tally`` only, three an epoch; phase 17 launches
``flash_attention`` only, 36 times a prefill; the families' prefills launch
only ``flash_attention`` (zamba2's 6 a prefill, whisper's encoder 4 and its
teacher-forced decoder 8 more; mamba2's none); phase 23 launches none, phase
24 ``flash_attention`` only on its paths (one a layer of each counted
prefill; its kernel checks then launch each kernel alone, outside the
counts), phase 25
``flash_attention`` only (36 in 25b's meshed prefill), phase 26 none (fake
tensors launch nothing). Phases
12-15 and 23 run with ``vmap``'s batching-rule fallback warning as an error.
Phase 2b holds ``tally`` against its plain version at the MaxMem benchmark
cell's three shapes (``perfbench/configs/kvs-gups-8m.json``'s manager over
8,388,608 pages, without a page pool, its tick's calls captured in the last
of four epochs of the cell's traffic): bit for bit, three launches an
epoch, its time, host and device time beside its bound (bytes), the plain
version's, ``scatter_add`` as the library yardstick (on indices normalised
beforehand; the port never calls it) and the share of entries that went
beyond the on-chip window (``tally.SPILLED``).
Phase 2 also holds ``paged_attention`` and ``flash_attention`` against their
plain versions, in float32 and bfloat16, at phase 5's shapes (flash at both
tenants' prompt lengths, 1,024 and 512) and in bfloat16 at phase 7's (16
query heads over 16 KV heads), and ``page_move`` at phase 7's K/V (64 KiB)
and summary (8 KiB) rows and at the expert rows with an all-swap plan.
The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failed check raises, and
the script then exits non-zero without printing a result. It needs a CUDA
device and the ``src/repro_torch`` package beside it.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
import warnings

# phase 18 runs with torch.use_deterministic_algorithms(True), which needs
# cuBLAS's fixed workspace; the variable is read when CUDA starts, so it is
# set before anything touches the card
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# the port's shape table and parameter counts; without the package beside
# the script this import fails and the script prints no result
from repro_torch.configs import LONG_CONTEXT_ARCHS, get_config, get_shape  # noqa: E402
# H100 SXM published HBM3 bandwidth and dense bf16 tensor-core peak
from repro_torch.analysis.roofline import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.analysis.roofline import PEAK_FLOPS as BF16_FLOPS  # noqa: E402

F32_FLOPS = 67e12  # H100 SXM float32 peak outside the tensor cores
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:21
SEED = 20231201

# The slice's deployment: the scale bench's 1M-page headline geometry
# (fast = P/4, migration budget = P/32) with one 4 KiB page of content each.
PAGES = 1_048_576
FAST = PAGES // 4
BUDGET = PAGES // 32
TENANTS = 16
QUEUE = 65_536
BANDWIDTH = 8_192
ELEMS = 1024  # float32 elements per page: 4 KiB
# examples/colocation_demo.py: p1 best-effort, p2-p6 latency-sensitive with
# a hot half taking 90% of their accesses
T_MISS = (1.0, 0.1, 0.1, 0.1, 0.1, 0.1)
HOT_SHARE = 0.9
# Accesses per tenant per 1 s epoch from the simulator's closed-loop model
# (src/repro/core/simulator.py:393, ops = threads / latency * epoch): the
# demo's 2 threads per tenant on the OPTANE machine (80 ns fast, 300 ns slow,
# plus a 64-byte value at 100 and 30 GB/s), the tenant missing in the same
# proportion as the machine's slow share (3/4). The model's range is 6.6M
# (all slow) to 24.8M (all fast).
THREADS = 2
FAST_OP_NS, SLOW_OP_NS = 80 + 64 / 100, 300 + 64 / 30
MISS = 1 - FAST / PAGES
ACCESSES_PER_TENANT = round(THREADS / ((1 - MISS) * FAST_OP_NS + MISS * SLOW_OP_NS) * 1e9)
EPOCHS, BURST = 32, 8  # run_epoch calls, then one run_epochs(BURST)
CHECK_PAGES = 65_536  # the GPU-vs-CPU run of phase 4


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def free_device(torch) -> None:
    """Release what an earlier phase left: the timing wrappers close over
    the engine's parts, so an engine, its KV pools and its weights die in
    reference cycles that only the collector breaks."""
    gc.collect()
    torch.cuda.empty_cache()


def emit(phase: str, **nums) -> None:
    print(f"{phase}: " + " ".join(f"{k}={v}" for k, v in nums.items()), flush=True)


# page_move's three kernels, hot_bins' cooperative kernel, tally and the attention
# kernels at the slice's head dim: (source, kernel, template arguments), as
# phase 1 reports them from ptxas
PTXAS_KERNELS = (
    ("page_copy", "move_mark"),
    ("page_copy", "move_pass_a"),
    ("page_copy", "move_pass_b"),
    ("hot_bins", "hot_bins_kernel"),
    ("tally", "tally_kernel"),
    ("flash_attention", "flash_attention_hopper", 128),
    ("flash_attention", "flash_attention_kernel", "float", 128),
    ("paged_attention", "paged_split_kernel", "__nv_bfloat16", 128, 4),
    ("paged_attention", "paged_split_kernel", "float", 128, 8),
    ("paged_attention", "paged_combine_kernel", "__nv_bfloat16"),
)


def template_id(name: str, *args) -> str:
    """How the kernel ``name<args...>`` is spelled inside its mangled symbol
    (a kernel in a namespace, the anonymous one included): an int argument
    as Li<n>E, float as f, a class by its length and name; a kernel that is
    no template as its name closing the namespace."""
    if not args:
        return f"{len(name)}{name}E"
    enc = "".join(f"Li{a}E" if isinstance(a, int) else ("f" if a == "float" else f"{len(a)}{a}")
                  for a in args)
    return f"{len(name)}{name}I{enc}E"


def ptxas_report(text: str) -> dict:
    """nvcc -Xptxas -v output -> {mangled kernel: "R registers, S bytes spill
    stores" plus any "Potential Performance Loss" note (ptxas serialised
    the kernel's wgmma products)}."""
    import re

    regs, spills, notes, fn = {}, {}, {}, None
    for line in text.splitlines():
        m = re.search(r"Potential Performance Loss: (.*?) in the function '(\S+)'", line)
        if m:
            notes[m.group(2)] = notes.get(m.group(2), "") + f"; {m.group(1)}"
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            spills[fn] = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            regs[fn] = m.group(1)
    return {f: f"{regs[f]} registers, {spills.get(f, '?')} bytes spill stores{notes.get(f, '')}"
            for f in regs}


# ------------------------------------------------------------------ helpers
def page_pattern(torch, ids, elems: int):
    """Seeded content that names its page: column 0 is the page id, the
    rest a hash of (page, column); every value is an exact float32 integer."""
    ids = ids.to(torch.int64)
    col = torch.arange(elems, dtype=torch.int64, device=ids.device)
    v = (ids[:, None] * 2654435761 + col[None, :] * 40503 + SEED) & 0xFFFFFF
    v[:, 0] = ids
    return v.to(torch.float32)


def tenant_sizes(n_pages: int, n_tenants: int):
    base, extra = divmod(n_pages, n_tenants)
    return [base + (1 if i < extra else 0) for i in range(n_tenants)]


def access_rates(torch, pages_of, n_pages: int, per_tenant: float, device):
    """f32[P] expected accesses per epoch: LS tenants put HOT_SHARE of their
    accesses on the first half of their pages, the best-effort one spreads
    them evenly (a GUPS-style uniform stream within each set)."""
    rates = torch.zeros(n_pages, dtype=torch.float32, device=device)
    for t, ids in enumerate(pages_of):
        ids_t = torch.as_tensor(ids, device=device)
        n = len(ids)
        if T_MISS[t] >= 1.0:
            rates[ids_t] = per_tenant / n
        else:
            half = n // 2
            rates[ids_t[:half]] = HOT_SHARE * per_tenant / half
            rates[ids_t[half:]] = (1 - HOT_SHARE) * per_tenant / (n - half)
    return rates


def epoch_counts(torch, rates, gen):
    return torch.poisson(rates, generator=gen).to(torch.int64)


def time_cuda(torch, fn, reps: int = 5, launches: int = 20) -> float:
    """Milliseconds per call of ``fn``: ``launches`` calls back to back
    between one pair of CUDA events, divided by their number; the median of
    ``reps`` such runs, after a warm-up. A kernel of tens of microseconds
    timed alone between two events would mostly measure the wrapper's host
    work."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    times.sort()
    return times[len(times) // 2]


def host_ms(torch, fn, reps: int = 5, launches: int = 20) -> float:
    """Milliseconds of host time per call of ``fn`` (the wrapper's checks,
    allocations and launch): ``launches`` calls issued back to back on the
    host clock, not waiting for the card; the median of ``reps`` runs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        times.append((time.perf_counter() - t0) / launches * 1e3)
        torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def device_ms(torch, fn, reps: int = 5):
    """Milliseconds of device time per call of ``fn`` (the sum of its
    kernels, memsets and copies as the profiler traces them), or None when
    the profiler records no device activity in three tries."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then records nothing: try again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages())
        if total_us > 0:
            return total_us / reps / 1e3
    return None


def max_abs_err(torch, a, b) -> float:
    """Largest |a - b| over two pools of rows, in float64, a few hundred MiB
    of rows at a time."""
    err = 0.0
    chunk = max(1, (1 << 26) // max(a[0].numel(), 1))
    for lo in range(0, a.shape[0], chunk):
        d = (a[lo : lo + chunk].to(torch.float64) - b[lo : lo + chunk].to(torch.float64))
        err = max(err, float(d.abs().max()))
    return err


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def fill_pattern(torch, pool, chunk: int = 65536) -> None:
    for lo in range(0, pool.shape[0], chunk):
        hi = min(lo + chunk, pool.shape[0])
        ids = torch.arange(lo, hi, device=pool.device)
        pool[lo:hi] = page_pattern(torch, ids, pool.shape[1])


# ------------------------------------------------------------------ phase 2
def kernel_checks(torch, np, device):
    """Each kernel against its plain version at the slice's shapes."""
    from repro_torch.core.sampler import sample_accesses
    from repro_torch.kernels import ops, page_copy, ref

    rows = FAST + PAGES + 1
    trash = rows - 1
    M = max(2 * BUDGET, 8)  # the pool's plan_slots
    row_bytes = ELEMS * 4
    rng = np.random.default_rng(SEED)
    out = {}

    pool_a = torch.empty((rows, ELEMS), dtype=torch.float32, device=device)
    fill_pattern(torch, pool_a)
    pool_b = pool_a.clone()

    # page_move: a drained batch as the data plane plans it — demotes move
    # fast frames to free slow frames, promotes move slow frames into the
    # fast frames those demotes vacate (write-after-read), trash padding
    n_pairs = BANDWIDTH // 2
    fast_src = rng.choice(FAST, n_pairs, replace=False)
    slow = FAST + rng.choice(PAGES, 2 * n_pairs, replace=False)
    src = np.full(M, trash, np.int32)
    dst = np.full(M, trash, np.int32)
    src[:n_pairs], dst[:n_pairs] = fast_src, slow[:n_pairs]
    src[n_pairs : 2 * n_pairs], dst[n_pairs : 2 * n_pairs] = slow[n_pairs:], fast_src
    s = s_mv = torch.as_tensor(src, device=device)
    d = d_mv = torch.as_tensor(dst, device=device)
    ops.page_move(pool_a, s, d)
    ref.page_move_ref(pool_b, s, d)
    torch.cuda.synchronize()
    check(torch.equal(pool_a.view(torch.int32), pool_b.view(torch.int32)),
          "page_move kernel bit-equal to its plain version")
    classes = move_class_counts(ref, s, d, rows)
    check(classes[2] == 0, f"the data plane's plan stages no entry (A, B, S = {classes})")
    check(page_copy.page_move_classes(pool_a).tolist() == classes,
          f"page_move's classes counted on the card are {classes}")
    err = max_abs_err(torch, pool_a, pool_b)
    s64, d64 = s.to(torch.int64), d.to(torch.int64)
    n_real = 2 * n_pairs

    def library():
        return pool_b.index_copy_(0, d64, pool_b.index_select(0, s64))

    out["page_move"] = dict(
        max_abs_err=err,
        ms=time_cuda(torch, lambda: ops.page_move(pool_a, s, d)),
        host_ms=host_ms(torch, lambda: ops.page_move(pool_a, s, d)),
        plain_ms=time_cuda(torch, lambda: ref.page_move_ref(pool_b, s, d)),
        library_ms=time_cuda(torch, library),
        library_device_ms=device_ms(torch, library),
        bytes=2 * n_real * row_bytes + 2 * 4 * M,
        shape=f"pool[{rows},{ELEMS}]f32 plan={M} real={n_real}",
        classes_a_b_s="/".join(map(str, classes)),
    )

    # page_copy: a full staging pool of plan_slots rows into the pool, the
    # tail of the plan padded onto the trash row
    pool_b.copy_(pool_a)
    staging = page_pattern(torch, torch.arange(M, device=device) + 7 * PAGES, ELEMS)
    n_pad = 1000
    dst = (rng.choice(rows - 1, M, replace=False)).astype(np.int32)
    dst[-n_pad:] = trash
    s = s_cp = torch.arange(M, dtype=torch.int32, device=device)
    d = d_cp = torch.as_tensor(dst, device=device)
    ops.page_copy(staging, pool_a, s, d)
    ref.page_copy_ref(staging, pool_b, s, d)
    torch.cuda.synchronize()
    check(torch.equal(pool_a[:-1].view(torch.int32), pool_b[:-1].view(torch.int32)),
          "page_copy kernel bit-equal to its plain version off the trash row")
    err = max_abs_err(torch, pool_a[:-1], pool_b[:-1])
    s64, d64 = s.to(torch.int64), d.to(torch.int64)

    def library():
        return pool_b.index_copy_(0, d64, staging.index_select(0, s64))

    out["page_copy"] = dict(
        max_abs_err=err,
        ms=time_cuda(torch, lambda: ops.page_copy(staging, pool_a, s, d)),
        plain_ms=time_cuda(torch, lambda: ref.page_copy_ref(staging, pool_b, s, d)),
        library_ms=time_cuda(torch, library),
        library_device_ms=device_ms(torch, library),
        # the padded entries leave one row in the trash: M - n_pad + 1 rows
        # must be read and written
        bytes=2 * (M - n_pad + 1) * row_bytes + 2 * 4 * M,
        shape=f"staging[{M},{ELEMS}] -> pool[{rows},{ELEMS}]f32",
    )

    # hot_bins: the sampled page ids of one epoch of the slice's stream
    pages_of, lo = [], 0
    for n in tenant_sizes(PAGES, len(T_MISS)):
        pages_of.append(np.arange(lo, lo + n))
        lo += n
    rates = access_rates(torch, pages_of, PAGES, ACCESSES_PER_TENANT, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    sampled = sample_accesses(gen, epoch_counts(torch, rates, gen), 100)
    ids = torch.repeat_interleave(
        torch.arange(PAGES, dtype=torch.int32, device=device), sampled
    ).contiguous()
    cin = torch.as_tensor(rng.integers(0, 40, PAGES).astype(np.int32), device=device)
    kc, kb = ops.hot_bins(ids, cin, num_bins=6)
    pc, pb = ref.hot_bins_ref(ids, cin, 6)
    torch.cuda.synchronize()
    check(torch.equal(kc, pc) and torch.equal(kb, pb),
          "hot_bins kernel bit-equal to its plain version")
    N = int(ids.shape[0])
    err = float(max((kc - pc).abs().max().item(), (kb - pb).abs().max().item()))
    out["hot_bins"] = dict(
        max_abs_err=err,
        ms=time_cuda(torch, lambda: ops.hot_bins(ids, cin, num_bins=6)),
        host_ms=host_ms(torch, lambda: ops.hot_bins(ids, cin, num_bins=6)),
        plain_ms=time_cuda(torch, lambda: ref.hot_bins_ref(ids, cin, 6)),
        library_ms=time_cuda(torch, lambda: torch.bincount(ids, minlength=PAGES)),
        library_device_ms=device_ms(torch, lambda: torch.bincount(ids, minlength=PAGES)),
        bytes=4 * N + 12 * PAGES,
        shape=f"ids[{N}] counts[{PAGES}]",
    )
    out["page_move"]["device_ms"] = device_ms(torch, lambda: ops.page_move(pool_a, s_mv, d_mv))
    out["page_copy"]["device_ms"] = device_ms(
        torch, lambda: ops.page_copy(staging, pool_a, s_cp, d_cp))
    out["hot_bins"]["device_ms"] = device_ms(torch, lambda: ops.hot_bins(ids, cin, num_bins=6))
    del pool_a, pool_b, staging
    torch.cuda.empty_cache()
    for name, r in out.items():
        r["bound_ms"] = bound_ms(r["bytes"])
        emit(f"phase2 {name}", **r)
    return out


# ----------------------------------------------------------------- phase 2b
TA_CONFIG = os.path.join(ROOT, "perfbench", "configs", "kvs-gups-8m.json")
TA_EPOCHS = 4  # the cell's warm-up epochs


def tally_checks(torch, np, device) -> dict:
    """Phase 2b: ``tally`` at the benchmark cell's three shapes, the tick's
    calls captured from the cell's manager (no page pool) in the last of
    ``TA_EPOCHS`` epochs of the cell's traffic; then the three summed, an
    epoch's worth. Returns the per-shape rows, keyed ``tally <site>``."""
    from perfbench import traffic
    from repro_torch.core import bins
    from repro_torch.core.manager import CentralManager
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tally as ktally

    with open(TA_CONFIG) as f:
        c = json.load(f)
    T = c["max_tenants"]
    m = CentralManager(
        num_pages=c["pages"], fast_capacity=c["fast_capacity"],
        migration_budget=c["migration_budget"], max_tenants=T, num_bins=c["num_bins"],
        sample_period=c["sample_period"], ewma_lambda=c["ewma_lambda"],
        hysteresis=c["hysteresis"], seed=SEED, queue_size=c["queue_size"],
        migration_bandwidth=c["migration_bandwidth"], device=device)
    pages_of = [torch.as_tensor(m.allocate(m.register(t["t_miss"]), t["pages"]))
                for t in c["tenants"]]
    cycle = traffic.epoch_cycle(traffic.page_rates(c, pages_of, SEED, device), TA_EPOCHS, SEED)
    calls, plain = [], bins.tally

    def spy(idx, size, values=None, *, width=None):
        calls.append((idx, size, values, width))
        return plain(idx, size, values, width=width)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    bins.tally = spy
    try:
        for e in range(TA_EPOCHS):
            calls.clear()
            m.record_access(cycle[e])
            m.run_epoch()
    finally:
        bins.tally = plain
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check(launches["tally"] == 3 * TA_EPOCHS and len(calls) == 3,
          f"the cell's tick launches tally three times an epoch: {launches['tally']} in "
          f"{TA_EPOCHS} epochs")
    sites = {2 * T: "sums", T: "bins"}
    out, epoch = {}, dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
                          library_device_ms=0.0, bound_ms=0.0, entries=0, spilled=0)
    for idx, size, values, width in calls:
        site = sites.get(size, "hist")
        want = ref.tally_ref(idx, size, values)
        before = ktally.SPILLED[idx.device].clone()
        got = ops.tally(idx, size, values, width=width)
        seen, spilled = (ktally.SPILLED[idx.device] - before).tolist()
        check(torch.equal(got, want), f"tally {site} bit-equal to its plain version")
        check(seen == idx.shape[0], f"tally {site} read every entry: {seen}")
        ones = torch.ones_like(idx) if values is None else values
        s = torch.where(idx < 0, idx + size, idx)
        s = torch.where((s < 0) | (s >= size), size, s)

        def run():
            return ops.tally(idx, size, values, width=width)

        def library():
            out = torch.zeros(size + 1, dtype=torch.int64, device=device)
            return out.scatter_add_(0, s, ones)

        r = dict(
            shape=f"idx[{idx.shape[0]}]i64 table {size}"
                  f"{'' if width is None else f' rows of {width}'}"
                  f" {'ones' if values is None else 'values'}",
            max_abs_err=0, ms=time_cuda(torch, run), host_ms=host_ms(torch, run),
            device_ms=device_ms(torch, run),
            plain_ms=time_cuda(torch, lambda: ref.tally_ref(idx, size, values)),
            library_ms=time_cuda(torch, library), library_device_ms=device_ms(torch, library),
            bytes=int(ops.tally_cost(idx, size, values)[1]), window=ktally.window(size, width),
            entries=seen, spilled=spilled, spilled_pct=100 * spilled / max(seen, 1),
        )
        r["bound_ms"] = bound_ms(r["bytes"])
        emit(f"phase2b tally {site}", **r)
        out[f"tally {site}"] = r
        for k in epoch:
            epoch[k] += r[k] or 0
    epoch["spilled_pct"] = 100 * epoch["spilled"] / max(epoch["entries"], 1)
    emit("phase2b tally epoch", **epoch)
    return out


def move_class_counts(ref, s, d, rows: int) -> list:
    """[A, B, S]: the plan's entries in each class of page_move's schedule."""
    cls = ref.page_move_classes(s, d, rows)
    return [int((cls == c).sum()) for c in (ref.MOVE_A, ref.MOVE_B, ref.MOVE_S)]


# the serving phases' page_move calls: one migrating epoch's plan as
# TieredPagedKV.migrate builds it (64 demotes to free slow slots, then 64
# promotes into the fast slots those demotes vacate, last vacated first)
# expanded over the model's layers, on the KV pool's rows (16 tokens x the KV
# heads x 128 bf16) and the Quest summaries' rows (the KV heads x 128 f32):
# yi-6b's (phase 5: 32 layers, 16 KiB and 2 KiB) and qwen2-moe-a2.7b's
# (phase 7: 24 layers, 64 KiB and 8 KiB)
KV_MOVES = 128
MOVE_WIDTHS = {
    "yi-6b": (32, (("kv16k", "bfloat16", 16 * 4 * 128), ("summary2k", "float32", 4 * 128))),
    "qwen2-moe-a2.7b": (24, (("kv64k", "bfloat16", 16 * 16 * 128),
                             ("summary8k", "float32", 16 * 128))),
}


def kv_plan(np, rng, layers: int):
    n_fast, n_slots = SV_FAST, SV_FAST + SV_SLOW
    half = KV_MOVES // 2
    fast = rng.choice(n_fast, half, replace=False)
    slow = n_fast + rng.choice(n_slots - n_fast, KV_MOVES, replace=False)  # free, then owned
    src = np.concatenate([fast, slow[half:]])
    dst = np.concatenate([slow[:half], fast[::-1]])
    base = np.arange(layers)[:, None] * n_slots
    return [(base + x[None]).reshape(-1).astype(np.int32) for x in (src, dst)]


def check_page_move(torch, np, pool_a, src, dst, name: str, staged: bool):
    """``page_move`` on ``pool_a`` against its plain version on a copy,
    with its times, its library call's (``index_select`` + ``index_copy_``),
    the bound and the plan's classes: none staged (the KV cache's plans) or
    all staged (an expert migration's swaps)."""
    from repro_torch.kernels import ops, page_copy, ref

    device = pool_a.device
    s, d = (torch.as_tensor(x, device=device) for x in (src, dst))
    s64, d64 = s.to(torch.int64), d.to(torch.int64)
    rows, elems, m = pool_a.shape[0], pool_a.shape[1], len(src)
    pool_b = pool_a.clone()
    ops.page_move(pool_a, s, d)
    ref.page_move_ref(pool_b, s, d)
    torch.cuda.synchronize()
    check(torch.equal(bits(torch, pool_a), bits(torch, pool_b)),
          f"page_move {name} bit-equal to its plain version")
    classes = move_class_counts(ref, s, d, rows)
    want = [0, 0, m] if staged else [classes[0], classes[1], 0]
    check(classes == want, f"page_move {name}: the plan's classes A, B, S are {classes}")
    check(page_copy.page_move_classes(pool_a).tolist() == classes,
          f"page_move's classes counted on the card are {classes}")
    row_bytes = elems * pool_a.element_size()

    def library():
        return pool_b.index_copy_(0, d64, pool_b.index_select(0, s64))

    out = dict(
        max_abs_err=max_abs_err(torch, pool_a, pool_b),
        ms=time_cuda(torch, lambda: ops.page_move(pool_a, s, d)),
        device_ms=device_ms(torch, lambda: ops.page_move(pool_a, s, d)),
        plain_ms=time_cuda(torch, lambda: ref.page_move_ref(pool_b, s, d)),
        library_ms=time_cuda(torch, library),
        library_device_ms=device_ms(torch, library),
        bound_ms=bound_ms(2 * m * row_bytes + 2 * 4 * m),
        classes_a_b_s="/".join(map(str, classes)),
        shape=f"pool[{rows},{elems}]{str(pool_a.dtype).split('.')[-1]} plan={m}",
    )
    del pool_b
    torch.cuda.empty_cache()
    emit(f"phase2 page_move {name}", **out)
    return out


def page_move_widths(torch, np, device, arch: str):
    """``page_move`` at a serving phase's two row widths (``MOVE_WIDTHS``)."""
    layers, widths = MOVE_WIDTHS[arch]
    src, dst = kv_plan(np, np.random.default_rng(SEED + 5), layers)
    rows = layers * (SV_FAST + SV_SLOW)
    out = {}
    for name, dname, elems in widths:
        g = torch.Generator(device=device)
        g.manual_seed(SEED + 6)
        pool = torch.randn((rows, elems), generator=g, device=device,
                           dtype=getattr(torch, dname))
        out[name] = check_page_move(torch, np, pool, src, dst, name, staged=False)
        del pool
        torch.cuda.empty_cache()
    return out


# phase 9's page_move calls: expert rows (one (layer, expert) matrix of
# qwen2-moe-a2.7b, 2,048 x 1,408 bf16: 5.5 MiB) in pools of 24 x 60 rows, a
# quarter of them fast, and an expert migration's plan: 8 paired swaps of a
# slow and a fast slot (the migration budget), every entry staged
ET_FAST, ET_PAIRS = 360, 8


def expert_swap_plan(np, rng, rows: int):
    fast = rng.choice(ET_FAST, ET_PAIRS, replace=False)
    slow = ET_FAST + rng.choice(rows - ET_FAST, ET_PAIRS, replace=False)
    src = np.stack([slow, fast], 1).reshape(-1).astype(np.int32)
    dst = np.stack([fast, slow], 1).reshape(-1).astype(np.int32)
    return src, dst


def page_move_experts(torch, np, device, cfg):
    """``page_move`` at the expert rows with an all-swap plan."""
    rows, elems = cfg.num_layers * cfg.num_experts, cfg.d_model * cfg.moe_d_ff
    src, dst = expert_swap_plan(np, np.random.default_rng(SEED + 7), rows)
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 8)
    pool = torch.randn((rows, elems), generator=g, device=device, dtype=torch.bfloat16)
    out = check_page_move(torch, np, pool, src, dst, "expert5.5m", staged=True)
    del pool
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ phase 3
def new_manager(device, n_pages, *, exact, elems, queue, bandwidth, budget):
    from repro_torch.core.manager import CentralManager

    return CentralManager(
        num_pages=n_pages, fast_capacity=n_pages // 4, migration_budget=budget,
        max_tenants=TENANTS, sample_period=100, queue_size=queue,
        migration_bandwidth=bandwidth, data_plane_elems=elems, sentinel=True,
        exact_sampling=exact, seed=SEED, device=device,
    )


def build_manager(torch, np, device, n_pages, *, exact, elems, queue, bandwidth, budget):
    m = new_manager(device, n_pages, exact=exact, elems=elems, queue=queue,
                    bandwidth=bandwidth, budget=budget)
    pages_of = []
    for n, t in zip(tenant_sizes(n_pages, len(T_MISS)), T_MISS):
        h = m.register(t)
        pages_of.append(m.allocate(h, n))
    for ids in pages_of:
        for lo in range(0, len(ids), 1 << 17):
            chunk = ids[lo : lo + (1 << 17)]
            rows = page_pattern(torch, torch.as_tensor(chunk, device=device), elems)
            m.pool.write_pages(chunk, rows)
    return m, pages_of


def hot_fast_share(np, m, pages_of) -> float:
    tiers = m.tiers()
    hot = np.concatenate(
        [ids[: len(ids) // 2] for t, ids in enumerate(pages_of) if T_MISS[t] < 1.0])
    return float((tiers[hot] == 1).mean())


def readback_ok(torch, m, pages_of, chunk: int = 1 << 16) -> bool:
    for ids in pages_of:
        for lo in range(0, len(ids), chunk):
            c = ids[lo : lo + chunk]
            got = m.pool.read_pages(c)
            want = page_pattern(torch, torch.as_tensor(c, device=got.device), got.shape[1])
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                return False
    return True


def run_slice(torch, np, device):
    """The slice end to end; returns its numbers (raises on a failed check).
    The epochs' access counts are drawn before the timed window, and the
    hot-set share after the first epoch is read outside it."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    m, pages_of = build_manager(torch, np, device, PAGES, exact=False, elems=ELEMS,
                                queue=QUEUE, bandwidth=BANDWIDTH, budget=BUDGET)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rates = access_rates(torch, pages_of, PAGES, ACCESSES_PER_TENANT, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    counts = [epoch_counts(torch, rates, gen) for _ in range(EPOCHS)]
    burst_counts = torch.stack([epoch_counts(torch, rates, gen) for _ in range(BURST)])
    sentinels = []
    share_first = None
    epochs_s = 0.0
    for e, c in enumerate(counts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.record_access(c)
        res = m.run_epoch()
        sentinels.append(int(res.stats.sentinel))
        torch.cuda.synchronize()
        epochs_s += time.perf_counter() - t0
        if e == 0:
            share_first = hot_fast_share(np, m, pages_of)
    t0 = time.perf_counter()
    multi = m.run_epochs(BURST, burst_counts)
    sentinels += [int(x) for x in multi.stats.sentinel.tolist()]
    torch.cuda.synchronize()
    epochs_s += time.perf_counter() - t0
    launches = ops.launch_counts()

    share_last = hot_fast_share(np, m, pages_of)
    intact = readback_ok(torch, m, pages_of)
    check(intact, "every page reads back the bytes written to it")
    m.pool.check(m.tiers())
    qc = m.queue_counters()
    check(qc["enqueued"] == qc["drained"] + qc["cancelled"] + qc["dropped"] + qc["depth"],
          f"queue conservation {qc}")
    check(all(s == 0 for s in sentinels), f"sentinel words all 0: {sentinels}")
    check(share_last > share_first, f"LS hot fast share rose ({share_first} -> {share_last})")
    fmmr = m.tenants.a_miss.cpu().numpy()
    check(np.isfinite(fmmr).all() and fmmr.shape == (TENANTS,), "FMMR finite, [T]")
    check(launches["page_move"] > 0 and launches["page_copy"] > 0, f"launches {launches}")
    n_ep = EPOCHS + BURST
    ph = m.phase_seconds
    busy = profile_epochs(torch, m, rates, gen)
    return dict(
        setup_s=setup_s, epochs=n_ep, epochs_s=epochs_s, ms_per_epoch=epochs_s / n_ep * 1e3,
        tick_ms=ph["tick"] / n_ep * 1e3, sync_ms=ph["sync"] / n_ep * 1e3,
        execute_ms=ph["execute"] / n_ep * 1e3,
        page_move_host_ms=m.pool.move_seconds / n_ep * 1e3,
        moved_pages=m.pool.moved_pages, hot_fast_share_first=share_first,
        hot_fast_share_last=share_last, fmmr_ls_mean=float(fmmr[1:6].mean()),
        fmmr_be=float(fmmr[0]), queue=qc, launches=launches, **busy,
    )


def profile_epochs(torch, m, rates, gen, n: int = 2):
    """Device busy time per epoch over ``n`` more epochs under the profiler
    (after the slice's checks and launch counts), against their wall time."""
    counts = [epoch_counts(torch, rates, gen) for _ in range(n)]

    def epochs():
        for c in counts:
            m.record_access(c)
            m.run_epoch()

    return device_busy(torch, epochs, n)


def device_busy(torch, fn, n: int):
    """Device busy time per epoch of ``fn`` (which runs ``n`` epochs) under
    the profiler, against its wall time, and the top kernels. Read from the
    profiler's raw events (each device kernel, copy and fill with its
    duration): a train step's ~10^5 kernels would take ``key_averages``
    tens of seconds to build into its event tree."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
    rows = sorted(by_name.items(), key=lambda kv: -kv[1])
    busy_ms = sum(by_name.values()) / n / 1e6
    top = ";".join(f"{k[:40].replace(' ', '_')}:{v / n / 1e6:.3f}" for k, v in rows[:6])
    return dict(profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
                device_kernels=len(rows), top_device_ms=top)


# ------------------------------------------------------------------ phase 4
def gpu_vs_cpu(torch, np):
    """The same exact-sampling schedule on the card and on the CPU; returns
    (integer leaves equal, max float ulp difference, queue counters)."""
    n_pages = CHECK_PAGES
    budget, queue, bandwidth = n_pages // 32, n_pages // 16, n_pages // 128
    rng = np.random.default_rng(SEED + 1)
    runs = {}
    sizes = tenant_sizes(n_pages, len(T_MISS))
    counts = []
    lo = 0
    base = np.zeros(n_pages, np.float64)
    for t, n in enumerate(sizes):
        half = n // 2
        if T_MISS[t] >= 1.0:
            base[lo : lo + n] = 40.0
        else:
            base[lo : lo + half] = 150.0
            base[lo + half : lo + n] = 12.0
        lo += n
    for _ in range(12):
        counts.append(rng.poisson(base).astype(np.int64))
    for dev in ("cuda", "cpu"):
        m, _ = build_manager(torch, np, dev, n_pages, exact=True, elems=64, queue=queue,
                             bandwidth=bandwidth, budget=budget)
        for e in range(8):
            m.record_access(counts[e])
            m.run_epoch()
        m.run_epochs(4, np.stack(counts[8:12]))
        st = m._state
        runs[dev] = dict(
            tier=m.tiers(), owner=m.owners(), count=st.pages.count.cpu().numpy(),
            last_cool=st.pages.last_cool.cpu().numpy(),
            cool_epoch=st.tenants.cool_epoch.cpu().numpy(),
            queue_page=st.queue.page.cpu().numpy(), frame=m.pool.frame.copy(),
            pool=m.pool.pool.cpu().numpy(), counters=m.queue_counters(),
            a_miss=st.tenants.a_miss.cpu().numpy(),
        )
    g, c = runs["cuda"], runs["cpu"]
    ints_equal = all(
        np.array_equal(g[k], c[k])
        for k in ("tier", "owner", "count", "last_cool", "cool_epoch", "queue_page", "frame")
    ) and g["counters"] == c["counters"]
    ints_equal = ints_equal and np.array_equal(g["pool"].view(np.int32), c["pool"].view(np.int32))
    ulp = int(np.abs(g["a_miss"].view(np.int32).astype(np.int64)
                     - c["a_miss"].view(np.int32).astype(np.int64)).max())
    return ints_equal, ulp, g["counters"]


# ------------------------------------------------- phase 2, attention kernels
# the serving slice's shapes: yi-6b's heads, 16-token pages, a 32-entry
# Quest table over the 4,608-slot pool, a 1,024-token prefill
PA_B, PA_NH, PA_NKV, PA_DH, PA_PAGE, PA_NP, PA_SLOTS = 32, 32, 4, 128, 16, 32, 4608
FA_S = (1024, 512)  # the two tenants' prompt lengths


def paged_inputs(torch, np, dtype, device, nh=PA_NH, nkv=PA_NKV):
    """A decode batch as the main path builds it: 31 selected full pages
    (a few -1 holes) and the current page holding 1..16 tokens."""
    rng = np.random.default_rng(SEED + 2)
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 2)
    q = torch.randn((PA_B, nh, PA_DH), generator=g, device=device).to(dtype)
    shape = (PA_SLOTS, PA_PAGE, nkv, PA_DH)
    kp = torch.randn(shape, generator=g, device=device).to(dtype)
    vp = torch.randn(shape, generator=g, device=device).to(dtype)
    tables = np.stack([rng.choice(PA_SLOTS, PA_NP, replace=False) for _ in range(PA_B)])
    tables[rng.random(tables.shape) < 0.05] = -1
    tables[:, -1] = rng.choice(PA_SLOTS, PA_B)
    lens = (PA_NP - 1) * PA_PAGE + rng.integers(1, PA_PAGE + 1, PA_B)
    return (q, kp, vp, torch.as_tensor(tables.astype(np.int32), device=device),
            torch.as_tensor(lens.astype(np.int32), device=device))


def paged_bytes(np, tables, lens, itemsize: int, nh: int, nkv: int) -> int:
    """Bytes the call must move: the valid K and V rows of each lane's
    pages, q, the output, the tables and lengths."""
    t, n = tables.cpu().numpy(), lens.cpu().numpy()
    p = np.arange(t.shape[1])[None, :]
    valid = np.clip(n[:, None] - p * PA_PAGE, 0, PA_PAGE) * (t >= 0)
    kv = 2 * int(valid.sum()) * nkv * PA_DH * itemsize
    return kv + 2 * PA_B * nh * PA_DH * itemsize + 4 * t.size + 4 * n.size


def flash_shape(torch, device, B: int, nh: int, nkv: int, Sq: int, Skv: int, dh: int, *,
                causal: bool, window: int = 0, dtype=None) -> dict:
    """``flash_attention`` at a path's prefill shape (bf16 unless ``dtype``)
    against its plain version lane by lane (each lane's output reads only
    its own inputs, and a lane's plain call fits the card where the whole
    call's would not), every lane held; with its time, device time, host
    time, the plain version's time (the same lane-by-lane calls), SDPA's (a
    window as a boolean mask) and the bound (the pairs the masks keep)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    dtype = dtype or torch.bfloat16
    dname = str(dtype).split(".")[-1]
    tol = ATTN_TOL[dname]
    g = torch.Generator(device=device)
    g.manual_seed(SEED + Sq + Skv)
    q = torch.randn((B, nh, Sq, dh), generator=g, device=device).to(dtype)
    k = torch.randn((B, nkv, Skv, dh), generator=g, device=device).to(dtype)
    v = torch.randn((B, nkv, Skv, dh), generator=g, device=device).to(dtype)
    kw = dict(causal=causal, sliding_window=window)

    def plain():
        return [ref.flash_attention_ref(q[b : b + 1], k[b : b + 1], v[b : b + 1], **kw)
                for b in range(B)]

    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain()
    torch.cuda.synchronize()
    plain_once_ms = (time.perf_counter() - t0) * 1e3
    err, bad = 0.0, []
    for b, w in enumerate(want):
        err = max(err, float((got[b : b + 1].float() - w.float()).abs().max()))
        if not torch.allclose(got[b : b + 1].float(), w.float(), atol=tol, rtol=tol):
            bad.append(b)
    check(not bad, f"flash_attention {dname} q {tuple(q.shape)} k/v {tuple(k.shape)} {kw} "
                   f"within {tol} of its plain version on every lane (lanes past it: {bad}; "
                   f"max err {err})")
    del got, want
    qpos = torch.arange(Sq, device=device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    pairs = int(mask.sum())
    flops = 4 * B * nh * dh * pairs
    by_ops = flops / (BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS) * 1e3
    by_bytes = bound_ms(q.element_size() * B * (2 * nh * Sq + 2 * nkv * Skv) * dh)

    def library():
        if window:
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)

    def kernel():
        return ops.flash_attention(q, k, v, **kw)

    # a plain pass of tens of milliseconds is timed over fewer runs
    plain_reps = dict(reps=3, launches=2) if plain_once_ms > 50 else {}
    out = dict(max_abs_err=err, tol=tol, ms=time_cuda(torch, kernel),
               device_ms=device_ms(torch, kernel), host_ms=host_ms(torch, kernel),
               plain_ms=time_cuda(torch, plain, **plain_reps),
               library_ms=time_cuda(torch, library), library_device_ms=device_ms(torch, library),
               bound_ms=max(by_ops, by_bytes),
               bound_by="operations" if by_ops >= by_bytes else "bytes",
               library="sdpa(attn_mask=window)" if window else
               f"sdpa(is_causal={causal})",
               shape=f"q[{B},{nh},{Sq},{dh}]{dname}_kv[{B},{nkv},{Skv},{dh}]"
                     f"_causal{int(causal)}_window{window}")
    del q, k, v, mask
    torch.cuda.empty_cache()
    return out


def flash_tally():
    """Split ``flash_attention``'s launches by call while a path runs: the
    wrapper's own count, read around each call, goes to the call's shape
    (q's, k/v's, causal, window, dtype). Returns the tally and the function
    that takes the spy out again."""
    from repro_torch.kernels import flash_attention as fa

    orig, tally = fa.flash_attention, {}

    def spy(q, k, v, *, causal=True, sliding_window=0):
        before = fa.LAUNCHES["flash_attention"]
        out = orig(q, k, v, causal=causal, sliding_window=sliding_window)
        key = (tuple(q.shape), tuple(k.shape), bool(causal), int(sliding_window), q.dtype)
        tally[key] = tally.get(key, 0) + fa.LAUNCHES["flash_attention"] - before
        return out

    def undo():
        fa.flash_attention = orig

    fa.flash_attention = spy
    return tally, undo


def tally_rows(torch, device, tally) -> list:
    """``flash_shape`` at every shape in a path's tally: [(row, launches)]."""
    rows = []
    for (qs, ks, causal, window, dtype), n in tally.items():
        B, nh, Sq, dh = qs
        rows.append((flash_shape(torch, device, B, nh, ks[1], Sq, ks[2], dh, causal=causal,
                                 window=window, dtype=dtype), n))
    return rows


def attention_checks(torch, np, device, nh=PA_NH, nkv=PA_NKV,
                     dtypes=("float32", "bfloat16"), tag=""):
    """``paged_attention`` and ``flash_attention`` against their plain
    versions at a serving phase's heads (yi-6b's by default, in float32 and
    bfloat16), with times; ``tag`` ends each row's name."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    out = {}
    for dname in dtypes:
        dtype = getattr(torch, dname)
        tol = ATTN_TOL[dname]
        q, kp, vp, tables, lens = paged_inputs(torch, np, dtype, device, nh, nkv)
        got = ops.paged_attention(q, kp, vp, tables, lens)
        want = ref.paged_attention_ref(q, kp, vp, tables, lens)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        check(bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)),
              f"paged_attention {dname} within {tol} of its plain version (max err {err})")

        def library():
            # two calls: gather the tables' pages, then masked SDPA
            t = tables.clamp(min=0).long()
            k = kp[t].reshape(PA_B, -1, nkv, PA_DH).transpose(1, 2)
            v = vp[t].reshape(PA_B, -1, nkv, PA_DH).transpose(1, 2)
            pos = torch.arange(PA_NP * PA_PAGE, device=device)
            mask = (pos[None, :] < lens[:, None]) & (tables >= 0).repeat_interleave(PA_PAGE, 1)
            return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                                  attn_mask=mask[:, None, None, :],
                                                  enable_gqa=True)

        out[f"paged_attention {dname}{tag}"] = dict(
            max_abs_err=err, tol=tol,
            ms=time_cuda(torch, lambda: ops.paged_attention(q, kp, vp, tables, lens)),
            device_ms=device_ms(torch, lambda: ops.paged_attention(q, kp, vp, tables, lens)),
            host_ms=host_ms(torch, lambda: ops.paged_attention(q, kp, vp, tables, lens)),
            plain_ms=time_cuda(torch, lambda: ref.paged_attention_ref(q, kp, vp, tables, lens)),
            library_ms=time_cuda(torch, library),
            library_device_ms=device_ms(torch, library),
            bound_ms=bound_ms(paged_bytes(np, tables, lens, q.element_size(), nh, nkv)),
            bound_by="bytes", library="gather+sdpa (two calls)",
            shape=f"q[{PA_B},{nh},{PA_DH}]{dname}_pool[{PA_SLOTS},{PA_PAGE},{nkv},{PA_DH}]",
        )
        del kp, vp

        # the be tenant's 1,024-token prompt (the row of the kernels line),
        # then the ls tenant's 512
        for S in FA_S:
            name = f"flash_attention {dname}{tag}" + ("" if S == FA_S[0] else f" S{S}")
            out[name] = flash_shape(torch, device, 1, nh, nkv, S, S, PA_DH, causal=True,
                                    dtype=dtype)
        torch.cuda.empty_cache()
    for name, r in out.items():
        emit(f"phase2 {name}", **{k: (v.replace(" ", "_") if isinstance(v, str) else v)
                                  for k, v in r.items()})
    return out


# ------------------------------------------------------------------ phase 5
# serve-yi6b: launch/serve.py's manager settings in queue mode, as in
# benchmarks/serving_colocation.py, at yi-6b's full width and depth
SV_PAGE, SV_FAST, SV_SLOW = 16, 512, 4096
SV_BATCH, SV_PER_SEQ, SV_QUEST, SV_EPOCH = 32, 96, 32, 8
SV_WARMUP, SV_STEPS = 24, 128
SV_TENANTS = (("ls", 0.1, 0.10, 512, 128), ("be", 1.0, 0.15, 1024, 256))
# phase 7, serve-qwen2moe: the same geometry and tenants, fewer steps
SV7_WARMUP, SV7_STEPS = 16, 128


def serving_stack(torch, cfg, params, device, *, kv_dtype, n_fast, n_slow, batch, per_seq,
                  quest, epoch, queue, bandwidth, budget):
    from repro_torch.core.manager import CentralManager
    from repro_torch.kvcache.paged import TieredPagedKV
    from repro_torch.serving.engine import ServingEngine

    manager = CentralManager(
        num_pages=n_fast + n_slow, fast_capacity=n_fast, migration_budget=budget,
        queue_size=queue, migration_bandwidth=bandwidth, max_tenants=4, sample_period=1,
        exact_sampling=True, seed=SEED, device=device,
    )
    kv = TieredPagedKV(cfg, n_fast, n_slow, page_tokens=SV_PAGE, dtype=kv_dtype, device=device)
    return ServingEngine(cfg, params, manager, kv, max_batch=batch, pages_per_seq=per_seq,
                         quest_pages=quest, epoch_steps=epoch)


def bits(torch, t):
    """A tensor's bits as integers of its width, for bit-equality."""
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def live_pages(eng):
    return [p for r in eng.lanes if r is not None for p in r.pages]


def guard_migrations(torch, eng, stats, layer_ms):
    """Wrap the KV cache's ``migrate`` so that every live request's pages
    read back bit-equal (``read_page``) before and after each epoch that
    moves pages. The time the check takes is kept apart in ``stats``; the
    migration's own goes to ``layer_ms["migrate_ms"]``."""
    kv = eng.kv
    inner = timed(torch, kv.migrate, layer_ms, "migrate_ms")

    def migrate(plan, manager):
        t0 = time.perf_counter()
        before = {p: kv.read_page(p) for p in live_pages(eng)}
        stats["check_s"] += time.perf_counter() - t0
        moved = inner(plan, manager)
        t0 = time.perf_counter()
        if moved:
            for p, (k0, v0) in before.items():
                k1, v1 = kv.read_page(p)
                check(torch.equal(bits(torch, k0), bits(torch, k1))
                      and torch.equal(bits(torch, v0), bits(torch, v1)),
                      f"live page {p} reads back bit-equal across a migrating epoch")
            stats["checked_epochs"] += 1
            stats["checked_pages"] += len(before)
        stats["check_s"] += time.perf_counter() - t0
        return moved

    kv.migrate = migrate


def timed(torch, fn, stats, key):
    """``fn`` with its synchronised wall time appended to ``stats[key]``."""
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        stats[key].append((time.perf_counter() - t0) * 1e3)
        return out

    return run


def time_layers(torch, eng, stats):
    """Time the engine's layers per call: prefill (the model forward), the
    prompt's page writes, the decode step and the MaxMem epoch (the KV
    migration is timed in ``guard_migrations``). Returns a function that
    puts the engine module's decode step back."""
    import dataclasses

    from repro_torch.serving import engine as engine_mod

    eng.api = dataclasses.replace(eng.api, prefill=timed(torch, eng.api.prefill, stats,
                                                         "prefill_ms"))
    eng.kv.write_tokens = timed(torch, eng.kv.write_tokens, stats, "write_ms")
    eng.manager.run_epoch = timed(torch, eng.manager.run_epoch, stats, "epoch_ms")
    inner = engine_mod.paged_decode_step
    engine_mod.paged_decode_step = timed(torch, inner, stats, "decode_ms")

    def restore():
        engine_mod.paged_decode_step = inner

    return restore


def count_routes(torch, tokens, record):
    """Wrap ``moe.route`` so that every routing of exactly ``tokens`` tokens
    (a decode step's lanes; ``None``: any) hands its ``Routing`` to
    ``record``. Returns a function that puts it back."""
    from repro_torch.models import moe

    inner = moe.route

    def route(router, xf, cfg, cap):
        r = inner(router, xf, cfg, cap)
        if tokens is None or xf.shape[0] == tokens:
            record(r)
        return r

    moe.route = route

    def restore():
        moe.route = inner

    return restore


def freed_slots_clean(torch, np, eng, chunk: int = 256) -> bool:
    """Every slot held by an unallocated logical page is zero with ±inf
    summaries."""
    kv = eng.kv
    free = kv.slot_of[np.flatnonzero(eng.manager.owners() < 0)]
    for lo in range(0, len(free), chunk):
        s = torch.as_tensor(free[lo : lo + chunk].astype(np.int64), device=kv.device)
        if (kv.k_pool[:, s].any() or kv.v_pool[:, s].any()
                or not bool((kv.k_max[:, s] == -torch.inf).all())
                or not bool((kv.k_min[:, s] == torch.inf).all())):
            return False
    return True


def run_serving(torch, np, device, cfg, params, *, warmup: int, steps: int):
    """A serving phase end to end (serve-yi6b, serve-qwen2moe) on ``params``;
    returns its numbers (raises on a failed check). An MoE model's decode
    steps also count their dropped assignments."""
    t0 = time.perf_counter()
    eng = serving_stack(torch, cfg, params, device, kv_dtype=torch.bfloat16, n_fast=SV_FAST,
                        n_slow=SV_SLOW, batch=SV_BATCH, per_seq=SV_PER_SEQ, quest=SV_QUEST,
                        epoch=SV_EPOCH, queue=1024, bandwidth=128, budget=128)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    stats = {"check_s": 0.0, "checked_epochs": 0, "checked_pages": 0}
    layer_ms = {k: [] for k in ("prefill_ms", "write_ms", "decode_ms", "epoch_ms", "migrate_ms")}
    guard_migrations(torch, eng, stats, layer_ms)
    restore = [time_layers(torch, eng, layer_ms)]
    # per decode-step routing of each MoE layer: each lane's dropped
    # assignments (on the card) and which lanes hold a request (the rest are
    # routed too, and take capacity)
    drops = []
    if cfg.is_moe:
        restore.append(count_routes(torch, SV_BATCH, lambda r: drops.append(
            ((~r.valid).view(SV_BATCH, -1).sum(1), [x is not None for x in eng.lanes]))))
    try:
        out = _drive_serving(torch, np, device, cfg, eng, stats, layer_ms, drops, setup_s,
                             warmup=warmup, steps=steps)
    finally:
        for r in restore:
            r()
    return out


def _drive_serving(torch, np, device, cfg, eng, stats, layer_ms, drops, setup_s, *, warmup,
                   steps):
    from collections import deque

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.serving.driver import OpenLoopDriver, TenantSpec

    driver = OpenLoopDriver(eng, [TenantSpec(*t) for t in SV_TENANTS], seed=SEED)
    finite = torch.ones((), dtype=torch.bool, device=device)

    def drive(n):
        nonlocal finite
        ms = []
        for _ in range(n):
            c0 = stats["check_s"]
            t0 = time.perf_counter()
            driver.run(1)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0 - (stats["check_s"] - c0)) * 1e3)
            if eng.last_logits is not None:
                finite &= torch.isfinite(eng.last_logits).all()
        return ms

    ops.reset_launch_counts()
    epochs0 = len(eng._epoch_log)
    drive(warmup)
    tok0, drops0 = eng.decode_tokens, len(drops)
    n0 = {k: len(v) for k, v in layer_ms.items()}
    step_ms = drive(steps)
    tokens = eng.decode_tokens - tok0  # the timed steps' (the profiled ones come later)
    timed_calls = {k: v[n0[k]:] for k, v in layer_ms.items()}
    launches = ops.launch_counts()
    timed_drops = drops[drops0:]
    timed_s = sum(step_ms) / 1e3
    moved_epochs = sum(1 for e in eng._epoch_log[epochs0:] if e["moved"] > 0)

    check(bool(finite), "every logit finite")
    check(launches["paged_attention"] == eng.decode_steps * cfg.num_layers,
          f"paged_attention launches {launches['paged_attention']} = "
          f"{eng.decode_steps} decode steps x {cfg.num_layers}")
    check(launches["flash_attention"] == eng.prefills * cfg.num_layers,
          f"flash_attention launches {launches['flash_attention']} = "
          f"{eng.prefills} prefills x {cfg.num_layers}")
    check(launches["page_move"] == 4 * moved_epochs,
          f"page_move launches {launches['page_move']} = 4 x {moved_epochs} migrating epochs")
    check(moved_epochs > 0 and stats["checked_epochs"] == moved_epochs,
          "pages migrated and every migrating epoch checked")
    check(sorted(eng.kv.slot_of.tolist()) == list(range(eng.kv.n_slots)),
          "slot_of is a permutation")
    check(freed_slots_clean(torch, np, eng), "freed slots hold zeros and ±inf summaries")
    qc = eng.manager.queue_counters()
    check(qc["enqueued"] == qc["drained"] + qc["cancelled"] + qc["dropped"] + qc["depth"],
          f"queue conservation {qc}")
    rep = driver.report(driver.steps_run)
    step_sorted = sorted(step_ms)

    # device idle share over two more steps under the profiler
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        driver.run(2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 2 * 1e3
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / 2 / 1e3
    top = ";".join(f"{e.key[:40].replace(' ', '_')}:{e.self_device_time_total / 2 / 1e3:.3f}"
                   for e in rows[:8])
    # and over two decode-only steps: the waiting requests are held back,
    # so no prompt is admitted
    waiting, eng.queue = eng.queue, deque()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        eng.step()
        torch.cuda.synchronize()
        dec_wall_ms = (time.perf_counter() - t0) / 2 * 1e3
    eng.queue = waiting
    dec_rows = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    dec_busy_ms = sum(e.self_device_time_total for e in dec_rows) / 2 / 1e3
    dec_top = ";".join(f"{e.key[:40].replace(' ', '_')}:{e.self_device_time_total / 2 / 1e3:.3f}"
                       for e in dec_rows[:8])
    calls = {k: len(v) for k, v in timed_calls.items()}
    per_step = {k.replace("_ms", "_ms_per_step"): sum(v) / steps
                for k, v in timed_calls.items()}
    if cfg.is_moe:
        check(len(timed_drops) == calls["decode_ms"] * cfg.num_layers,
              f"every MoE layer of {calls['decode_ms']} decode steps routed the batch once")
        lane_drops = torch.stack([d for d, _ in timed_drops]).cpu()  # [calls, B]
        live = torch.tensor([a for _, a in timed_drops])
        per = lane_drops.sum(1).view(-1, cfg.num_layers).sum(1)
        per_live = (lane_drops * live).sum(1).view(-1, cfg.num_layers).sum(1)
        live_assign = (live.sum(1) * cfg.moe_top_k).view(-1, cfg.num_layers).sum(1)
        per_step.update(
            moe_dropped_per_decode_step_mean=float(per.float().mean()),
            moe_dropped_per_decode_step_max=int(per.max()),
            moe_decode_steps_with_drops=int((per > 0).sum()),
            moe_assignments_per_decode_step=SV_BATCH * cfg.moe_top_k * cfg.num_layers,
            moe_dropped_of_active_lanes_per_decode_step_mean=float(per_live.float().mean()),
            moe_dropped_of_active_lanes_per_decode_step_max=int(per_live.max()),
            moe_active_lane_assignments_per_decode_step_mean=float(live_assign.float().mean()),
        )
    res = dict(
        setup_s=setup_s, steps=steps, decode_tokens_per_s=tokens / timed_s,
        lanes_per_decode_step=tokens / max(calls["decode_ms"], 1),
        step_ms_p50=step_sorted[len(step_sorted) // 2],
        step_ms_p99=step_sorted[min(len(step_sorted) - 1, int(0.99 * len(step_sorted)))],
        step_ms_mean=sum(step_ms) / len(step_ms),
        prefills_timed=calls["prefill_ms"],
        prefill_ms_per_request=sum(timed_calls["prefill_ms"]) / max(calls["prefill_ms"], 1),
        decode_ms_p50=sorted(timed_calls["decode_ms"])[calls["decode_ms"] // 2],
        epochs_timed=calls["epoch_ms"], **per_step,
        migrated_pages=eng._migrated_pages, migrating_epochs=moved_epochs,
        admission_blocked=eng.admission_blocked, queue_len_end=len(eng.queue),
        finished=len(eng.finished), checked_pages=stats["checked_pages"],
        check_s=stats["check_s"], profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, top_device_ms=top,
        decode_only_wall_ms=dec_wall_ms, decode_only_busy_ms=dec_busy_ms,
        decode_only_idle_share=(1 - dec_busy_ms / dec_wall_ms) if dec_busy_ms else None,
        decode_only_top_device_ms=dec_top,
    )
    tenants = {}
    for name, h in eng.tenant_handles.items():
        lat = rep[name]["latency"]
        tenants[name] = dict(modeled_p99_us=lat.get("p99", 0.0) * 1e6,
                             fmmr=eng.manager.fmmr_of(h), completed=rep[name]["completed"],
                             generated_tokens=rep[name]["generated_tokens"])
    return res, tenants, launches, qc


# ------------------------------------------------------------------ phase 6
def serving_gpu_vs_cpu(torch, np, arch: str):
    """The serving slice at ``arch``'s full width, 2 layers, float32, with
    the same weights on the card and on the CPU: 3 requests through prefill
    and 8 decode steps. Returns (max relative logit difference,
    comparisons); for an MoE model the comparisons also hold, per layer,
    the gate ids that differ and the smallest top-k margin (the gap between
    the k-th and the next probability on the CPU) among their tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.types import state_to_numpy
    from repro_torch.models.model import get_model

    # float32 products in full float32 on the card (no TF32), as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), num_layers=2, param_dtype="float32",
                              compute_dtype="float32")
    cpu_params = get_model(cfg).init(seed=SEED, device="cpu")
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in (300, 161, 47)]
    runs = {}
    for dev in ("cuda", "cpu"):
        params = to_device(cpu_params, dev)
        eng = serving_stack(torch, cfg, params, dev, kv_dtype=torch.float32, n_fast=8,
                            n_slow=56, batch=4, per_seq=24, quest=4, epoch=2, queue=16,
                            bandwidth=4, budget=8)
        eng.add_tenant("ls", 0.1)
        eng.add_tenant("be", 1.0)
        for i, p in enumerate(prompts):
            eng.submit("ls" if i == 0 else "be", p, 9)
        counts, logits, inner = [], [], eng.manager.record_access
        eng.manager.record_access = lambda c: (counts.append(np.array(c)), inner(c))[1]
        routes = []
        restore = count_routes(torch, None, lambda r: routes.append(
            (r.gate_ids.cpu(), r.probs.cpu()))) if cfg.is_moe else (lambda: None)
        try:
            for _ in range(8):
                eng.step()
                logits.append(eng.last_logits.cpu())
        finally:
            restore()
        st = state_to_numpy(eng.manager._state)
        runs[dev] = dict(counts=counts, logits=torch.stack(logits), slot_of=eng.kv.slot_of.copy(),
                         tokens=[r.generated for r in eng.finished + [r for r in eng.lanes if r]],
                         state=st, moved=eng._migrated_pages,
                         queue=eng.manager.queue_counters(), routes=routes)
        del params, eng
    g, c = runs["cuda"], runs["cpu"]
    rel = float((g["logits"] - c["logits"]).abs().max() / c["logits"].abs().max())
    state_equal = all(
        np.array_equal(getattr(getattr(g["state"], part), f), getattr(getattr(c["state"], part), f))
        for part in ("pages", "tenants", "queue") for f in getattr(g["state"], part)._fields)
    cmp = dict(
        tokens_equal=g["tokens"] == c["tokens"],
        counts_equal=len(g["counts"]) == len(c["counts"]) and all(
            np.array_equal(a, b) for a, b in zip(g["counts"], c["counts"])),
        state_equal=state_equal, slot_of_equal=bool(np.array_equal(g["slot_of"], c["slot_of"])),
        queue_equal=g["queue"] == c["queue"], moved=g["moved"],
    )
    if cfg.is_moe:
        cmp.update(route_compare(torch, g["routes"], c["routes"], cfg))
    return rel, cmp


def route_compare(torch, gpu, cpu, cfg) -> dict:
    """Gate ids that differ between the card's and the CPU's routings, per
    layer (the calls come layer by layer, prompt by prompt, step by step),
    and the smallest top-k margin among the tokens where they do."""
    L, k = cfg.num_layers, cfg.moe_top_k
    check(len(gpu) == len(cpu), f"as many routings on the card as on the CPU ({len(gpu)}, "
          f"{len(cpu)})")
    differ, margin = [0] * L, float("inf")
    for i, ((ig, _), (ic, pc)) in enumerate(zip(gpu, cpu)):
        check(ig.shape == ic.shape, f"routing {i} has the same tokens on both")
        bad = (ig != ic).any(1)
        differ[i % L] += int((ig != ic).sum())
        if bool(bad.any()):
            top = torch.sort(pc[bad], dim=-1, descending=True).values[:, : k + 1]
            margin = min(margin, float((top[:, :-1] - top[:, 1:]).min()))
    return dict(routings=len(gpu), gate_ids_differ_per_layer="/".join(map(str, differ)),
                min_top_k_margin_where_differ=None if margin == float("inf") else margin)


# ------------------------------------------------------------------ phase 7
def moe_split(torch, cfg, params, device, tokens: int):
    """One MoE layer's block at ``tokens`` tokens (a decode step's lanes),
    in pieces: the device time of the routing (gates, ranks, capacity), of
    the experts' batched products and of the shared experts, and of the
    whole block, whose rest is the dispatch and the combine (scatter into
    [Ep, C, d], gather back); and the whole block's host time per call."""
    import torch.nn.functional as F

    from repro_torch.models import moe
    from repro_torch.models.transformer import layer_params

    lp = layer_params(params, 0)["moe"]
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 10)
    x = torch.randn((tokens, 1, cfg.d_model), generator=g, device=device).to(cfg.cdtype)
    xf = x.reshape(tokens, -1)
    cap = moe.capacity(tokens, cfg)
    xe = torch.randn((moe.padded_experts(cfg), cap, cfg.d_model), generator=g,
                     device=device).to(cfg.cdtype)
    sp = lp["shared"]

    def experts():
        h = F.silu(torch.bmm(xe, lp["w_gate"])) * torch.bmm(xe, lp["w_up"])
        return torch.bmm(h, lp["w_down"])

    def shared():
        return (F.silu(xf @ sp["w_gate"]) * (xf @ sp["w_up"])) @ sp["w_down"]

    out = dict(
        tokens=tokens, capacity=cap,
        block_device_ms=device_ms(torch, lambda: moe.moe_mlp(lp, x, cfg)),
        block_host_ms=host_ms(torch, lambda: moe.moe_mlp(lp, x, cfg)),
        block_ms=time_cuda(torch, lambda: moe.moe_mlp(lp, x, cfg)),
        route_device_ms=device_ms(torch, lambda: moe.route(lp["router"], xf, cfg, cap)),
        experts_device_ms=device_ms(torch, experts),
        experts_ms=time_cuda(torch, experts),
        experts_bound_ms=bound_ms(sum(lp[w].numel() * lp[w].element_size()
                                      for w in ("w_gate", "w_up", "w_down"))),
        shared_device_ms=device_ms(torch, shared),
    )
    out["dispatch_combine_device_ms"] = (out["block_device_ms"] - out["route_device_ms"]
                                         - out["experts_device_ms"] - out["shared_device_ms"])
    return out


# ------------------------------------------------------------------ phase 8
# coloc-legs: benchmarks/serving_colocation.py's machine, tenants and seed
# (16 fast + 80 slow 4-token pages, batch 4, 8 pages a sequence, Quest top-2,
# an epoch every 2 steps, queue 32, bandwidth 8, headroom 6, quotas 8/8,
# 24 warm-up + 60 steps), its three placements on phase 7's weights
CL_FAST, CL_SLOW, CL_PAGE, CL_BATCH, CL_PER_SEQ, CL_QUEST, CL_EPOCH = 16, 80, 4, 4, 8, 2, 2
CL_QUEUE, CL_BW, CL_HEADROOM, CL_SEED, CL_WARMUP, CL_STEPS = 32, 8, 6, 7, 24, 60
CL_QUOTA = {"ls": CL_FAST // 2, "be": CL_FAST // 2}
CL_TENANTS = (("ls", 0.1, 0.10, 12, 16), ("be", 1.0, 0.15, 16, 24))
CL_MODES = ("maxmem", "static", "fixed")


def coloc_leg(torch, np, device, cfg, params, mode: str) -> dict:
    """One placement's leg; raises when a mechanism check fails."""
    from repro_torch.kvcache.paged import TieredPagedKV
    from repro_torch.serving.baselines import make_serving_manager
    from repro_torch.serving.driver import OpenLoopDriver, TenantSpec
    from repro_torch.serving.engine import ServingEngine

    manager = make_serving_manager(
        mode, num_pages=CL_FAST + CL_SLOW, fast_capacity=CL_FAST, migration_budget=CL_BW,
        queue_size=CL_QUEUE, migration_bandwidth=CL_BW, fast_quota=CL_QUOTA,
        alloc_headroom=CL_HEADROOM, max_tenants=4, device=device)
    kv = TieredPagedKV(cfg, CL_FAST, CL_SLOW, page_tokens=CL_PAGE, dtype=torch.bfloat16,
                       device=device)
    eng = ServingEngine(cfg, params, manager, kv, max_batch=CL_BATCH, pages_per_seq=CL_PER_SEQ,
                        quest_pages=CL_QUEST, epoch_steps=CL_EPOCH)
    driver = OpenLoopDriver(eng, [TenantSpec(*t) for t in CL_TENANTS], seed=CL_SEED)
    most_fast = {name: 0 for name in CL_QUOTA}

    def drive(n):
        for _ in range(n):
            driver.run(1)
            for name, h in eng.tenant_handles.items():
                most_fast[name] = max(most_fast[name], manager.fast_pages_of(h))

    drive(CL_WARMUP)
    torch.cuda.synchronize()
    tok0, t0 = eng.decode_tokens, time.perf_counter()
    drive(CL_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rep = driver.report(driver.steps_run)
    moved = rep["_engine"]["migrated_pages"]
    if mode == "maxmem":
        check(moved > 0, "the maxmem leg migrated pages")
    else:
        check(moved == 0, f"the {mode} leg migrated no page ({moved})")
    if mode == "fixed":
        check(all(most_fast[n] <= q for n, q in CL_QUOTA.items()),
              f"no tenant held more fast pages than its quota: {most_fast} of {CL_QUOTA}")
    check(sorted(kv.slot_of.tolist()) == list(range(kv.n_slots)), "slot_of is a permutation")
    check(freed_slots_clean(torch, np, eng), f"the {mode} leg's freed slots are clean")
    out = dict(migrated_pages=moved, tokens_per_s=(eng.decode_tokens - tok0) / wall,
               step_ms_mean=wall / CL_STEPS * 1e3, admission_blocked=eng.admission_blocked)
    for name, h in eng.tenant_handles.items():
        lat = rep[name]["latency"]
        out[f"{name}_p50_us"] = lat.get("p50", 0.0) * 1e6
        out[f"{name}_p99_us"] = lat.get("p99", 0.0) * 1e6
        out[f"{name}_fmmr"] = eng.manager.fmmr_of(h)
        out[f"{name}_most_fast_pages"] = most_fast[name]
        out[f"{name}_completed"] = rep[name]["completed"]
    return out


def coloc_legs(torch, np, device, cfg, params):
    """The three legs; returns ({mode: numbers}, the claim row as found,
    kernel launches over the three)."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    legs = {mode: coloc_leg(torch, np, device, cfg, params, mode) for mode in CL_MODES}
    launches = ops.launch_counts()
    p99 = {m: legs[m]["ls_p99_us"] for m in CL_MODES}
    claim = dict(maxmem_leq_static=p99["maxmem"] <= p99["static"],
                 maxmem_leq_fixed=p99["maxmem"] <= p99["fixed"],
                 ls_p99_us="/".join(f"{m}:{p99[m]}" for m in CL_MODES))
    return legs, claim, launches


# ------------------------------------------------------------------ phase 9
# expert-tiering: ExpertTierManager at qwen2-moe-a2.7b's full width, 1,440
# expert pages, a quarter fast, the reference's budget and epoch period; a
# fixed seeded bf16 batch through every layer each step, as the reference's
# test_real_router_skew_from_moe_model drives it
ET_TOKENS, ET_BUDGET, ET_EPOCH, ET_STEPS = 32, 8, 8, 64


def expert_tiering(torch, np, device, cfg, params):
    """The expert-tiering phase; returns its numbers (raises on a failed
    check: swaps, every page_move call all staged, every expert's rows
    bit-equal to its weights wherever it moved, layer 0's output unchanged)."""
    from repro_torch.kernels import ops, page_copy
    from repro_torch.serving.expert_tiering import ExpertTierManager, moe_layer_from_pools

    L, E = cfg.num_layers, cfg.num_experts
    t0 = time.perf_counter()
    tm = ExpertTierManager(cfg, n_fast_slots=ET_FAST, t_miss=0.1, migration_budget=ET_BUDGET,
                           epoch_steps=ET_EPOCH, device=device)
    tm.build_pools(params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 9)
    x = torch.randn((ET_TOKENS, cfg.d_model), generator=g, device=device).to(torch.bfloat16)
    routers = params["layers"]["moe"]["router"]
    calls = []  # (entries, [A, B, S] read on the card, event ms) per page_move call
    inner = ops.page_move

    def page_move(pool, s, d):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(pool, s, d)
        b.record()
        b.synchronize()
        calls.append((int(s.numel()), page_copy.page_move_classes(pool).tolist(),
                      a.elapsed_time(b)))
        return out

    ops.page_move = page_move
    layer0, step_ms, moved, shares = [], [], [], []
    try:
        ops.reset_launch_counts()
        for _ in range(ET_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            counts = []
            for l in range(L):
                out, c = moe_layer_from_pools(tm.pools, tm.slot_table()[l], routers[l], x, cfg=cfg)
                counts.append(c)
                if l == 0:
                    layer0.append(out)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            counts = torch.stack(counts)
            shares.append(tm.fast_share_of_traffic(counts))
            tm.record_routing(counts)
            moved.append(tm.maybe_epoch())
        launches = ops.launch_counts()
    finally:
        ops.page_move = inner

    migrating = sum(1 for m in moved if m)
    check(sum(moved) > 0, "expert swaps happened")
    check(launches["page_move"] == 3 * migrating == len(calls),
          f"page_move launches {launches['page_move']} = 3 pools x {migrating} migrating epochs")
    for m, cls, _ in calls:
        check(cls == [0, 0, m], f"an expert plan of {m} entries is all staged: A/B/S = {cls}")
    check(all(torch.equal(o, layer0[0]) for o in layer0),
          "layer 0's output bit-equal at every step, across the migrations")
    check(sorted(tm.slot_of.tolist()) == list(range(tm.n_slots)), "slot_of is a permutation")
    w = params["layers"]["moe"]
    intact = all(
        torch.equal(getattr(tm.pools, name)[int(tm.slot_of[l * E + e])], w[name][l, e])
        for l in range(L) for e in range(E) for name in ("w_gate", "w_up", "w_down"))
    check(intact, "every expert's rows bit-equal to its weights, wherever it moved")
    row_bytes = cfg.d_model * cfg.moe_d_ff * tm.pools.w_gate.element_size()
    move_ms = sorted(ms for _, _, ms in calls)
    entries = sorted(m for m, _, _ in calls)
    step_sorted = sorted(step_ms)
    return dict(
        setup_s=setup_s, steps=ET_STEPS, epochs=ET_STEPS // ET_EPOCH, migrating_epochs=migrating,
        moved_rows=sum(moved), page_move_calls=len(calls),
        entries_per_call_median=entries[len(entries) // 2],
        page_move_ms_per_call_median=move_ms[len(move_ms) // 2],
        page_move_ms_per_call_max=move_ms[-1],
        page_move_bound_ms_per_call_median=bound_ms(2 * entries[len(entries) // 2] * row_bytes),
        row_bytes=row_bytes, unpaired_promotes=tm.unpaired_promotes,
        unpaired_demotes=tm.unpaired_demotes, fast_share_first=shares[0],
        fast_share_last=shares[-1], fmmr=tm.fmmr(),
        layer_ms_median=step_sorted[len(step_sorted) // 2] / L,
        step_ms_median=step_sorted[len(step_sorted) // 2],
        pools_gib=3 * tm.n_slots * row_bytes / 2**30, launches_page_move=launches["page_move"],
    )


# ----------------------------------------------------------- phases 10 and 11
SC_TENANTS, SC_EPOCHS, SC_CHUNK = 16, 40, 4  # scale_colocation(PAGES, 16, 40)
# examples/colocation_demo.py (paper Fig. 4) with its --bandwidth 8 queue
F4_PAGES, F4_FAST, F4_BUDGET, F4_QUEUE, F4_BANDWIDTH, F4_EPOCHS = 3584, 512, 32, 64, 8, 300


def check_invariants(np, sim, event=None) -> None:
    """The conservation invariants of tests/test_scenarios.py:87-110: tiers
    exactly partition the owned pages, no page of an unregistered tenant,
    fast occupancy within capacity, queue conservation."""
    from repro_torch.core.types import TIER_FAST, TIER_NONE, TIER_SLOW

    backend = sim.backend
    tier = np.asarray(backend.tiers())
    owner = np.asarray(backend.owners())
    ctx = f"after {event}" if event is not None else "after epoch"
    check(set(np.unique(tier).tolist()) <= {TIER_NONE, TIER_SLOW, TIER_FAST}, f"tier domain {ctx}")
    owned = owner >= 0
    check(bool((tier[owned] != TIER_NONE).all()), f"owned page unplaced {ctx}")
    check(bool((tier[~owned] == TIER_NONE).all()), f"unowned page placed {ctx}")
    registered = {int(h) for h in sim.handles.values()}
    holders = set(np.unique(owner[owned]).tolist())
    check(holders <= registered, f"orphan owners {holders - registered} {ctx}")
    cap = int(backend.params.fast_capacity) if hasattr(backend, "params") \
        else backend.fast_capacity
    check(int((tier == TIER_FAST).sum()) <= cap, f"fast occupancy {ctx}")
    if hasattr(backend, "queue_counters"):
        c = backend.queue_counters()
        check(c["enqueued"] == c["drained"] + c["cancelled"] + c["dropped"] + c["depth"],
              f"queue conservation {ctx}: {c}")


def scenario_hook(torch, np, acc):
    """``on_event`` for ``run_scenario``: an arriving tenant's pages get
    their content through ``pool.write_pages`` (``page_copy``), then the
    invariants are checked; its host time goes to ``acc["hook"]``."""
    from repro_torch.core.scenario import Arrive

    def hook(sim, ev):
        t0 = time.perf_counter()
        acc["_busy"] = True
        pool = getattr(sim.backend, "pool", None)
        if isinstance(ev, Arrive) and pool is not None:
            ids = sim.tenants[ev.spec.name].page_ids
            for lo in range(0, len(ids), 1 << 17):
                chunk = ids[lo : lo + (1 << 17)]
                pool.write_pages(chunk, page_pattern(
                    torch, torch.as_tensor(chunk, device=pool.pool.device), pool.pool.shape[1]))
        check_invariants(np, sim, ev)
        acc["hook"] = acc.get("hook", 0.0) + time.perf_counter() - t0
        acc["_busy"] = False

    return hook


def time_methods(obj, names, acc, key: str) -> None:
    """Wrap ``obj``'s methods ``names`` so their host time adds up in
    ``acc[key]``; a call made inside another timed call (or the hook) is
    counted once, by the outer one."""
    for name in names:
        fn = getattr(obj, name)

        def timed_fn(*a, _fn=fn, **kw):
            if acc.get("_busy"):
                return _fn(*a, **kw)
            acc["_busy"] = True
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
                acc["_busy"] = False

        setattr(obj, name, timed_fn)


def record_sentinels(m, out: list) -> None:
    """Keep the sentinel word of every epoch the simulator runs (tensors,
    read once at the end)."""
    run_epoch, run_epochs = m.run_epoch, m.run_epochs

    def one():
        res = run_epoch()
        out.append(res.stats.sentinel.reshape(1))
        return res

    def many(k, counts=None, collect_plans=False):
        res = run_epochs(k, counts, collect_plans)
        out.append(res.stats.sentinel.reshape(-1))
        return res

    m.run_epoch, m.run_epochs = one, many


def live_ids(sim):
    return [t.page_ids for t in sim.tenants.values()]


def scenario_1m(torch, np, device):
    """Phase 10: ``scale_colocation(1,048,576, 16, 40)`` through the port's
    ``ColocationSim`` (``policy_chunk`` 4, so the chunked ``run_epochs`` path)
    on phase 3's manager; returns the numbers, raises on a failed check."""
    from repro_torch.core.scenario import scale_colocation
    from repro_torch.core.simulator import OPTANE, ColocationSim
    from repro_torch.kernels import ops

    m = new_manager(device, PAGES, exact=False, elems=ELEMS, queue=QUEUE, bandwidth=BANDWIDTH,
                    budget=BUDGET)
    check(m.device.type == "cuda" and m.pool.pool.is_cuda, f"phase 10 runs on the card: {m.device}")
    sc = scale_colocation(PAGES, SC_TENANTS, SC_EPOCHS)
    sim = ColocationSim(m, OPTANE, seed=1, policy_chunk=SC_CHUNK)
    acc, sentinels = {}, []
    record_sentinels(m, sentinels)
    # the manager's epochs and telemetry reads, its control plane, the rest
    time_methods(m, ("run_epoch", "run_epochs", "tiers", "owners"), acc, "manager")
    time_methods(m, ("register", "allocate", "unregister", "record_access"), acc, "control")
    hook = scenario_hook(torch, np, acc)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = sim.run_scenario(sc, on_event=hook)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    parts = {k: acc.get(k, 0.0) for k in ("manager", "control", "hook")}
    check(len(res.history) == SC_EPOCHS, f"{len(res.history)} records of {SC_EPOCHS}")
    check(launches["page_move"] > 0 and launches["page_copy"] > 0, f"launches {launches}")
    ph = dict(m.phase_seconds)
    busy = device_busy(torch, lambda: sim.run_chunk(SC_CHUNK), SC_CHUNK)  # one more chunk

    check_invariants(np, sim)
    check(readback_ok(torch, m, live_ids(sim)), "every live page reads back its bytes")
    m.pool.check(m.tiers())
    words = torch.cat(sentinels).tolist()
    check(all(w == 0 for w in words), f"sentinel words all 0: {words}")
    fmmr = [v for r in res.history for v in (*r.fmmr_true.values(), *r.fmmr_measured.values())]
    check(bool(np.isfinite(fmmr).all()), "FMMR finite in every record")
    last = res.history[-1]
    ls = [nm for nm in last.fmmr_true if int(nm[1:]) % 2 == 1]  # t_miss 0.3 (scenario.py:522)
    n = SC_EPOCHS
    return dict(
        epochs=n, tenants_peak=SC_TENANTS, wall_s=wall_s, ms_per_epoch=wall_s / n * 1e3,
        manager_ms=parts["manager"] / n * 1e3, tick_ms=ph["tick"] / n * 1e3,
        sync_ms=ph["sync"] / n * 1e3, execute_ms=ph["execute"] / n * 1e3,
        control_ms=parts["control"] / n * 1e3, writes_and_checks_ms=parts["hook"] / n * 1e3,
        simulator_ms=(wall_s - sum(parts.values())) / n * 1e3,
        migrated_pages=sum(r.migrated_pages for r in res.history),
        moved_pages=m.pool.moved_pages,
        ls_fmmr_true_mean=float(np.mean([last.fmmr_true[nm] for nm in ls])),
        ls_fmmr_true_max=float(np.max([last.fmmr_true[nm] for nm in ls])),
        ls_fmmr_measured_mean=float(np.mean([last.fmmr_measured[nm] for nm in ls])),
        ls_target=0.3, agg_throughput=res.steady_state.agg_throughput,
        phases=len(res.phases), **busy,
    ), m.queue_counters(), launches


def fig4_scenario():
    """The timeline of examples/colocation_demo.py:37-49 (paper Fig. 4)."""
    from repro_torch.core.scenario import Arrive, ResizeWorkingSet, Retarget, Scenario
    from repro_torch.core.simulator import WorkloadSpec

    events = [Arrive(0, WorkloadSpec("p1", 128, t_miss=1.0, threads=2))]
    for j, i in enumerate([2, 3, 4, 5]):
        events.append(Arrive(10 * (j + 1), WorkloadSpec(
            f"p{i}", 128, t_miss=0.1, threads=2, sets=((0.5, 0.9),))))
    events += [
        Arrive(110, WorkloadSpec("p6", 128, t_miss=0.1, threads=2, sets=((0.5, 0.9),))),
        ResizeWorkingSet(170, "p5", 0, 0.75),  # hot set +50%
        Retarget(230, "p1", 0.1),  # dynamic QoS change
    ]
    return Scenario(name="fig4_demo", n_epochs=F4_EPOCHS, events=tuple(events),
                    description="paper Fig. 4 timeline")


def fig4_run(torch, np, backend):
    """One run of the Fig. 4 timeline on ``backend`` (``policy_chunk`` 1,
    so every epoch is a ``run_epoch``), the invariants after every event."""
    from repro_torch.core.simulator import OPTANE, ColocationSim

    sim = ColocationSim(backend, OPTANE, seed=2, policy_chunk=1)
    res = sim.run_scenario(fig4_scenario(), on_event=scenario_hook(torch, np, {}))
    check_invariants(np, sim)
    check(len(res.history) == F4_EPOCHS, f"{len(res.history)} records of {F4_EPOCHS}")
    return sim, res


def text_of(x):
    """``repr`` of dataclasses as dicts: every float exact, NaN and -0.0 told
    apart."""
    return [repr(dataclasses.asdict(r)) for r in x]


def state_leaves(np, st, prefix=""):
    """(name, array) of every leaf of ``state_to_numpy``'s state."""
    for name, v in st._asdict().items():
        if v is None:
            continue
        if hasattr(v, "_asdict"):
            yield from state_leaves(np, v, f"{prefix}{name}.")
        else:
            yield prefix + name, np.asarray(v)


def steady_ls(res) -> dict:
    """The latency-sensitive tenants' (p2-p6) mean p99 and the aggregate
    throughput over the steady phase."""
    ph = res.steady_state
    ls = [nm for nm in ph.p99 if nm != "p1"]
    return dict(ls_p99_us=float(sum(ph.p99[nm] for nm in ls) / len(ls) * 1e6),
                agg_throughput=ph.agg_throughput)


def scenario_gpu_vs_cpu(torch, np):
    """Phase 11: the Fig. 4 timeline with exact sampling and a 1,024-f32
    page pool, on the card and (asked for) on the CPU: histories, phases,
    final state and page bytes must be equal. Then the three baselines on
    the same timeline, their steady-phase numbers as found."""
    from repro_torch.core.baselines import AutoNUMALike, HeMemStatic, TwoLM
    from repro_torch.core.manager import CentralManager
    from repro_torch.core.types import state_to_numpy
    from repro_torch.kernels import ops

    runs = {}
    launches = None
    for dev in ("cuda", "cpu"):
        m = CentralManager(
            num_pages=F4_PAGES, fast_capacity=F4_FAST, migration_budget=F4_BUDGET,
            max_tenants=8, sample_period=100, queue_size=F4_QUEUE,
            migration_bandwidth=F4_BANDWIDTH, exact_sampling=True, data_plane_elems=ELEMS,
            device=dev,
        )
        if dev == "cuda":
            torch.cuda.synchronize()
            ops.reset_launch_counts()
        t0 = time.perf_counter()
        sim, res = fig4_run(torch, np, m)
        wall_s = time.perf_counter() - t0
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = ops.launch_counts()
        check(readback_ok(torch, m, live_ids(sim)), f"{dev}: every live page reads back its bytes")
        m.pool.check(m.tiers())
        runs[dev] = dict(m=m, res=res, wall_s=wall_s, state=state_to_numpy(m._state),
                         frame=np.asarray(m.pool.frame).copy())
    g, c = runs["cuda"], runs["cpu"]
    hist_equal = text_of(g["res"].history) == text_of(c["res"].history)
    phases_equal = text_of(g["res"].phases) == text_of(c["res"].phases)
    gl, cl = dict(state_leaves(np, g["state"])), dict(state_leaves(np, c["state"]))
    state_equal = gl.keys() == cl.keys() and all(
        gl[k].dtype == cl[k].dtype and gl[k].tobytes() == cl[k].tobytes() for k in gl)
    owned = np.flatnonzero(g["m"].owners() >= 0)
    frames_equal = np.array_equal(g["frame"][owned], c["frame"][owned])
    out = dict(
        epochs=F4_EPOCHS, gpu_wall_s=g["wall_s"], cpu_wall_s=c["wall_s"],
        histories_equal=hist_equal, phases_equal=phases_equal, state_equal=state_equal,
        frames_equal=frames_equal, queue=g["m"].queue_counters(),
        migrated_pages=sum(r.migrated_pages for r in g["res"].history),
    )
    check(hist_equal, "GPU and CPU epoch histories equal, floats exact")
    check(phases_equal, "GPU and CPU PhaseStats equal")
    check(state_equal, "GPU and CPU final state equal (state_to_numpy, every leaf)")
    check(frames_equal, "GPU and CPU frame tables equal")
    check(g["m"].queue_counters() == c["m"].queue_counters(), "queue counters equal")
    policies = {"maxmem": steady_ls(g["res"])}
    P, F, B = F4_PAGES, F4_FAST, F4_BUDGET
    baselines = {  # tests/test_scenarios.py:61-72 at this geometry
        "hemem": HeMemStatic(P, F, partitions={i: F // 4 for i in range(8)}, hot_threshold=6,
                             migration_budget=B),
        "autonuma": AutoNUMALike(P, F),
        "twolm": TwoLM(P, F),
    }
    for name, b in baselines.items():
        _, res = fig4_run(torch, np, b)
        policies[name] = steady_ls(res)
    return out, policies, launches


# ----------------------------------------------------------- phases 12 and 13
# benchmarks/dynamic_workload.py:400-410 (_sweep_config, full): the fleet
# sweep behind BENCH_fleet.json
FL_PAGES, FL_EPOCHS, FL_MACHINES, FL_TENANTS = 65_536, 96, 16, 16
FL_FAST = FL_PAGES // 8
FL_BUDGET = max(FL_FAST // 8, 8)
FL_CHUNK = FL_EPOCHS // 4
# tests/golden_regen.py:111-118,170: the golden fleet trace's setup
GF_P, GF_FAST, GF_MAX_T, GF_EPOCHS, GF_COUNTS_SEED = 64, 16, 4, 8, 99
GF_TENANTS = ((24, 1.0), (20, 0.1), (12, 0.5))  # (n_pages, t_miss)
GF_MACHINES = ((5, 16), (6, 8), (7, 12))  # (seed, migration_budget)
# benchmarks/scale_bench.py:60-61,152-181: the machines axis
MA_AXIS, MA_PAGES, MA_TENANTS, MA_EPOCHS, MA_REPS = (1, 4, 16, 64), 65_536, 16, 4, 2
BATCHING_RULE = ".*batching rule.*"


def sweep_64k(torch, np):
    """Phase 12: the fleet sweep at BENCH_fleet.json's size on the card, its
    fleet epoch split, one profiled chunk; then the same 16 points serially
    (one manager and ``ColocationSim(policy_chunk=24)`` each), every record
    and final state bit-equal to the fleet's."""
    from repro_torch.core.manager import CentralManager
    from repro_torch.core.scenario import ScenarioSweep, run_sweep
    from repro_torch.core.simulator import OPTANE, ColocationSim
    from repro_torch.core.types import state_to_numpy
    from repro_torch.kernels import ops
    from repro_torch.launch.families import sweep_points, sweep_scenario

    sc = sweep_scenario(FL_PAGES, FL_EPOCHS)
    points = sweep_points(FL_MACHINES, FL_BUDGET)
    seen = {}

    def on_fleet(f):
        """Keep the fleet and the counts of its last dispatch."""
        seen["fleet"] = f
        dispatch = f.run_epochs_async

        def recorded(k, counts=None, **kw):
            seen["counts"] = counts
            return dispatch(k, counts=counts, **kw)

        f.run_epochs_async = recorded

    acc: dict = {}
    saved = {n: getattr(ColocationSim, n) for n in ("_arrays", "_chunk_prepare", "_chunk_record")}
    time_methods(ColocationSim, tuple(saved), acc, "simulators")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        res = run_sweep(
            ScenarioSweep(scenario=sc, points=points), num_pages=FL_PAGES, fast_capacity=FL_FAST,
            migration_budget=FL_BUDGET, max_tenants=FL_TENANTS, sample_period=100,
            policy_chunk=FL_CHUNK, on_fleet=on_fleet)
        torch.cuda.synchronize()
        fleet_s = time.perf_counter() - t0
    finally:
        for n, fn in saved.items():
            setattr(ColocationSim, n, fn)
    launches = ops.launch_counts()
    fleet = seen["fleet"]
    check(fleet.device.type == "cuda", f"phase 12 runs on the card: {fleet.device}")
    check(all(len(r.history) == FL_EPOCHS for r in res.results.values()), "96 records a machine")
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = FL_EPOCHS
    ph = dict(fleet.phase_seconds)
    sim_s = acc.get("simulators", 0.0)
    out = dict(
        machines=FL_MACHINES, pages=FL_PAGES, epochs=n, wall_s=fleet_s,
        machine_epochs_per_s=FL_MACHINES * n / fleet_s, fleet_epoch_ms=fleet_s / n * 1e3,
        tick_host_ms=ph["tick"] / n * 1e3, draw_ms=ph["draw"] / n * 1e3,
        stack_upload_ms=ph["assemble"] / n * 1e3, transfer_ms=ph["transfer"] / n * 1e3,
        simulators_ms=sim_s / n * 1e3, pipeline=res.pipeline, peak_gib=peak,
        **{f"upload_{k}": v for k, v in fleet.upload_stats.items()},
    )
    fleet_states = [state_to_numpy(m._state) for m in fleet.machines]
    # the last chunk's counts once more, under the profiler
    busy = device_busy(torch, lambda: fleet.run_epochs(FL_CHUNK, counts=seen["counts"],
                                                       trim_stats=True), FL_CHUNK)
    out.update(busy)

    # the same 16 points, one machine at a time on the card
    t0 = time.perf_counter()
    equal_hist = equal_state = 0
    for i, p in enumerate(points):
        mgr = CentralManager(
            num_pages=FL_PAGES, fast_capacity=FL_FAST,
            migration_budget=FL_BUDGET if p.migration_budget is None else p.migration_budget,
            max_tenants=FL_TENANTS, sample_period=100, seed=p.seed)
        sim = ColocationSim(mgr, OPTANE, seed=p.seed, policy_chunk=FL_CHUNK)
        want = sim.run_scenario(sc)
        equal_hist += text_of(want.history) == text_of(res.results[p.name].history)
        fs = dict(state_leaves(np, fleet_states[i]))
        ws = dict(state_leaves(np, state_to_numpy(mgr._state)))
        equal_state += fs.keys() == ws.keys() and all(
            fs[k].tobytes() == ws[k].tobytes() for k in fs)
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    out.update(serial_s=serial_s, serial_over_fleet=serial_s / fleet_s,
               histories_equal=equal_hist, states_equal=equal_state)
    check(equal_hist == FL_MACHINES, f"every machine's records equal serially: {equal_hist}")
    check(equal_state == FL_MACHINES, f"every machine's final state equal serially: {equal_state}")
    check(not any(launches.values()), f"the fleet path launches no kernel: {launches}")
    return out, launches


def golden_record(np, result, tier) -> dict:
    """tests/golden_regen.py:139-152: one epoch of the golden fleet trace."""
    s = result.stats
    return {
        "fmmr_now": np.asarray(s.fmmr_now, np.float32).astype(float).tolist(),
        "fmmr_ewma": np.asarray(s.fmmr_ewma, np.float32).astype(float).tolist(),
        "fast_pages": np.asarray(s.fast_pages, np.int32).tolist(),
        "slow_pages": np.asarray(s.slow_pages, np.int32).tolist(),
        "promoted": np.asarray(s.promoted, np.int32).tolist(),
        "demoted": np.asarray(s.demoted, np.int32).tolist(),
        "cooled": np.asarray(s.cooled, bool).tolist(),
        "promote_ids": np.asarray(result.plan.promote, np.int32).tolist(),
        "demote_ids": np.asarray(result.plan.demote, np.int32).tolist(),
        "tier": np.asarray(tier, np.int8).tolist(),
    }


def golden_fleet(np) -> bool:
    """The golden fleet trace's three machines (exact sampling) as a fleet
    on the card, against ``tests/golden/fleet_trace.json``."""
    from repro_torch.core.fleet import FleetManager
    from repro_torch.core.manager import CentralManager

    machines = []
    for seed, budget in GF_MACHINES:
        m = CentralManager(num_pages=GF_P, fast_capacity=GF_FAST, migration_budget=budget,
                           max_tenants=GF_MAX_T, sample_period=100, exact_sampling=True, seed=seed)
        for n_pages, t_miss in GF_TENANTS:
            m.allocate(m.register(t_miss), n_pages)
        machines.append(m)
    fleet = FleetManager(machines)
    counts = np.random.default_rng(GF_COUNTS_SEED).integers(
        0, 50, size=(GF_EPOCHS, GF_P)).astype(np.int64)
    res = fleet.run_epochs(GF_EPOCHS, counts=np.broadcast_to(counts, (3,) + counts.shape),
                           collect_plans=True)
    fresh = []
    for i, (seed, budget) in enumerate(GF_MACHINES):
        tier = fleet.machines[i].tiers()
        epochs = [golden_record(np, r, tier) for r in res.machine(i).unstack()]
        for e in range(GF_EPOCHS - 1):
            epochs[e].pop("tier")
        fresh.append({"seed": seed, "budget": budget, "epochs": epochs})
    with open(os.path.join(ROOT, "tests", "golden", "fleet_trace.json")) as f:
        committed = json.load(f)["machines"]
    return json.loads(json.dumps(fresh)) == committed


def parity_sweep(dev: str):
    """tests/test_torch_sweep.py's timeline: four points (seed x budget x
    bandwidth) in queue mode, 4 KiB pages, 40 us epochs, ``sample_period``
    1 (exact counts), ``policy_chunk`` 4, on ``dev``."""
    from repro_torch.core.scenario import (Arrive, Depart, ResizeWorkingSet, Scenario,
                                           ScenarioSweep, SweepPoint, run_sweep)
    from repro_torch.core.simulator import OPTANE, WorkloadSpec

    sc = Scenario(name="sweep_parity", n_epochs=16, events=(
        Arrive(0, WorkloadSpec("kvs", n_pages=380, t_miss=0.2, threads=4, sets=((0.2, 0.9),))),
        Arrive(0, WorkloadSpec("gap", n_pages=260, t_miss=0.5, threads=8, sets=((0.2, 0.7),))),
        Arrive(4, WorkloadSpec("gups", n_pages=160, t_miss=1.0, threads=8)),
        ResizeWorkingSet(8, "kvs", 0, 0.3),
        Depart(12, "gups"),
    ))
    points = tuple(SweepPoint(name=f"m{i}", seed=i // 2, migration_budget=(32, 16)[i % 2],
                              migration_bandwidth=8 + 4 * i, migration_latency=i % 2)
                   for i in range(4))
    t0 = time.perf_counter()
    res = run_sweep(ScenarioSweep(scenario=sc, points=points), num_pages=1024, fast_capacity=256,
                    migration_budget=32, max_tenants=8, queue_size=64, policy_chunk=4,
                    sample_period=1, epoch_seconds=4e-5,
                    machine=dataclasses.replace(OPTANE, page_bytes=4096), device=dev)
    return res, time.perf_counter() - t0


def machines_point(torch, np, K: int) -> dict:
    """benchmarks/scale_bench.py:152-181 at K machines: the managers of
    benchmarks/microbench.py:285-297 (fast P/4, budget P/32, 16 tenants of
    P/16 pages at t_miss 0.5, seed = machine), Poisson(200) counts, 4
    epochs with trimmed telemetry and one stacked placement read a rep."""
    from repro_torch.core.fleet import FleetManager
    from repro_torch.core.manager import CentralManager

    P, T = MA_PAGES, MA_TENANTS
    mgrs = []
    for seed in range(K):
        m = CentralManager(num_pages=P, fast_capacity=P // 4, migration_budget=max(P // 32, 8),
                           max_tenants=T, sample_period=100, seed=seed)
        for _ in range(T):
            m.allocate(m.register(t_miss=0.5), P // T)
        mgrs.append(m)
    counts = np.random.default_rng(0).poisson(200, (K, P)).astype(np.int64)
    fleet = FleetManager(mgrs, devices=1)
    live = fleet.live_bytes()
    best = float("inf")
    for rep in range(MA_REPS + 1):
        before = dict(fleet.phase_seconds)
        t0 = time.perf_counter()
        fleet.run_epochs(MA_EPOCHS, counts=counts, trim_stats=True)
        fleet.stacked_placement()
        dt = time.perf_counter() - t0
        if rep and dt < best:  # the first rep warms up
            best = dt
            tick = fleet.phase_seconds["tick"] - before["tick"]
    return {f"K{K}_ms_per_machine_epoch": best / (K * MA_EPOCHS) * 1e3,
            f"K{K}_epoch_ms": best / MA_EPOCHS * 1e3,
            f"K{K}_tick_host_ms": tick / MA_EPOCHS * 1e3,
            f"K{K}_live_bytes_per_machine": live / K}


def fleet_gpu_vs_cpu(torch, np):
    """Phase 13: the golden fleet trace on the card; the parity sweep on
    the card and on the CPU, histories equal; the machines axis."""
    golden = golden_fleet(np)
    check(golden, "the card's fleet replays tests/golden/fleet_trace.json bit for bit")
    gpu, gpu_s = parity_sweep("cuda")
    cpu, cpu_s = parity_sweep("cpu")
    hist = {n: text_of(r.history) for n, r in gpu.results.items()} == \
        {n: text_of(r.history) for n, r in cpu.results.items()}
    phases = {n: text_of(r.phases) for n, r in gpu.results.items()} == \
        {n: text_of(r.phases) for n, r in cpu.results.items()}
    check(hist and phases, "the parity sweep's histories and phases equal on the card and the CPU")
    moved = min(sum(r.migrated_pages for r in res.history) for res in gpu.results.values())
    check(moved > 0, f"pages move on every machine of the parity sweep: {moved}")
    out = dict(golden_trace_equal=golden, sweep_histories_equal=hist, sweep_phases_equal=phases,
               sweep_min_migrated=moved, sweep_gpu_s=gpu_s, sweep_cpu_s=cpu_s)
    for K in MA_AXIS:
        out.update(machines_point(torch, np, K))
        free_device(torch)
    return out


# ----------------------------------------------------------- phases 14 and 15
# the autotuner CLI's default search (src/repro/launch/hillclimb.py:803-845):
# the thrash family at its committed geometry
AT_FAMILY, AT_PAGES, AT_EPOCHS = "thrash", 65_536, 96
AT_POPULATION, AT_GENERATIONS, AT_ELITES, AT_SEED = 8, 4, 2, 0
# benchmarks/autotune_bench.py:50-54 (full): the profiles BENCH_autotune.json claims
AT_PROFILES = (("colocation", "colocation_64k"), ("thrash", "thrash_64k"),
               ("skewshift", "skewshift_64k"))
AT_REL_EPS = 1e-9  # benchmarks/autotune_bench.py:56
# benchmarks/autotune_bench.py:136-188 (full): the online-recovery probe
ON_PAGES, ON_EPOCHS, ON_CHUNK, ON_SEED = 16_384, 64, 2, 0
# tests/test_torch_autotune.py's exact search
TG_PAGES, TG_EPOCHS, TG_FAST, TG_CHUNK, TG_POPULATION, TG_GENERATIONS, TG_SEED = (
    1024, 12, 128, 4, 4, 2, 7)


def fleet_split(fleets, n_epochs: int, sim_s: float) -> dict:
    """The fleet epoch split over ``fleets`` (one a generation or replay),
    ms per fleet epoch, as phase 12 reports it."""
    total = {k: sum(f.phase_seconds[k] for f in fleets) for k in fleets[0].phase_seconds}
    return dict(tick_host_ms=total["tick"] / n_epochs * 1e3,
                draw_ms=total["draw"] / n_epochs * 1e3,
                stack_upload_ms=total["assemble"] / n_epochs * 1e3,
                transfer_ms=total["transfer"] / n_epochs * 1e3,
                simulators_ms=sim_s / n_epochs * 1e3)


def watch_sweeps(module, fleets: list, walls: list, last: dict):
    """Wrap ``module.run_sweep`` so each sweep's fleet, wall time and last
    dispatch's counts are kept; returns the original."""
    import torch

    orig = module.run_sweep

    def watched(sweep, **kw):
        def on_fleet(f):
            fleets.append(f)
            dispatch = f.run_epochs_async

            def recorded(k, counts=None, **dkw):
                last.update(k=k, counts=counts)
                return dispatch(k, counts=counts, **dkw)

            f.run_epochs_async = recorded

        t0 = time.perf_counter()
        res = orig(sweep, on_fleet=on_fleet, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return res

    module.run_sweep = watched
    return orig


def autotune_search(torch, np):
    """Phase 14a: the CLI's default offline search on the card (thrash,
    65,536 pages x 96 epochs, fast 8,192, queue 4,096, policy_chunk 8,
    population 8, generations 4, elites 2, seed 0, pipelined): wall time a
    generation, machine-epochs/s, the fleet epoch split, one profiled
    chunk, peak memory, the winner against the default."""
    from repro_torch.core.simulator import ColocationSim
    from repro_torch.kernels import ops
    from repro_torch.launch import hillclimb

    geom = hillclimb.family_geometry(AT_FAMILY, n_pages=AT_PAGES, n_epochs=AT_EPOCHS)
    check(dataclasses.astuple(geom) == (AT_PAGES, AT_EPOCHS, AT_PAGES // 8, AT_PAGES // 16, 8, 8),
          f"geometry {geom}")
    fleets, walls, last, acc = [], [], {}, {}
    saved = {n: getattr(ColocationSim, n) for n in ("_arrays", "_chunk_prepare", "_chunk_record")}
    time_methods(ColocationSim, tuple(saved), acc, "simulators")
    orig = watch_sweeps(hillclimb, fleets, walls, last)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    try:
        tuner = hillclimb.PolicyAutotuner(AT_FAMILY, geom, population=AT_POPULATION,
                                          generations=AT_GENERATIONS, elites=AT_ELITES,
                                          seed=AT_SEED)
        check(tuner.device.type == "cuda", f"phase 14 runs on the card: {tuner.device}")
        t0 = time.perf_counter()
        result = tuner.search()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        hillclimb.run_sweep = orig
        for n, fn in saved.items():
            setattr(ColocationSim, n, fn)
    launches = ops.launch_counts()
    check(not result.interrupted and len(result.trajectory) == AT_GENERATIONS,
          "the search ran every generation")
    check(all(f.device.type == "cuda" for f in fleets), "every generation's fleet is on the card")
    w, ref = result.winner, result.ref
    check(w["agg"] >= ref["agg"] * (1 - AT_REL_EPS) and w["ls_p99"] <= ref["ls_p99"] * (1 + AT_REL_EPS),
          f"the winner weakly dominates the default: {w['agg']} / {ref['agg']}, "
          f"{w['ls_p99']} / {ref['ls_p99']}")
    fleet_epochs = AT_GENERATIONS * geom.n_epochs
    out = dict(family=AT_FAMILY, pages=geom.n_pages, epochs=geom.n_epochs,
               population=AT_POPULATION, generations=AT_GENERATIONS, wall_s=wall_s,
               generation_wall_s=";".join(f"{s:.3f}" for s in walls),
               machine_epochs_per_s=AT_POPULATION * fleet_epochs / wall_s,
               fleet_epoch_ms=sum(walls) / fleet_epochs * 1e3,
               **fleet_split(fleets, fleet_epochs, acc.get("simulators", 0.0)),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               dispatches=sum(f.upload_stats["dispatches"] for f in fleets))
    # the last generation's last chunk once more, under the profiler
    out.update(device_busy(torch, lambda: fleets[-1].run_epochs(
        last["k"], counts=last["counts"], trim_stats=True), last["k"]))
    winner = dict(generation=w["generation"], index=w["index"], score=w["score"],
                  default_agg=ref["agg"], default_ls_p99_us=ref["ls_p99"] * 1e6,
                  winner_agg=w["agg"], winner_ls_p99_us=w["ls_p99"] * 1e6,
                  agg_pct=100 * (w["agg"] / ref["agg"] - 1),
                  **{f"knob_{k}": v for k, v in w["resolved"].items()})
    return out, winner, launches


def profile_replay(torch, np, family: str, name: str) -> dict:
    """Phase 14b: one committed profile against the paper defaults at its
    own geometry, a two-point sweep on the card (the loop of
    benchmarks/autotune_bench.py:86-133); the claim printed as found."""
    from repro_torch.configs.tuned import load_profile
    from repro_torch.core.scenario import ScenarioSweep, SweepPoint, run_sweep
    from repro_torch.launch import hillclimb

    prof = load_profile(name)
    g, p = prof["geometry"], prof["params"]
    geom = hillclimb.TunerGeometry(
        n_pages=int(g["n_pages"]), n_epochs=int(g["n_epochs"]), fast=int(g["fast_capacity"]),
        queue_size=int(g["queue_size"]), max_tenants=int(g["max_tenants"]),
        policy_chunk=int(g["policy_chunk"]))
    scenario = hillclimb.family_scenario(family, geom)
    seed = int(prof["search"].get("eval_seed", 0))
    default_kw = hillclimb.resolve_knobs(hillclimb.default_candidate(), geom)
    points = (
        SweepPoint("default", seed=seed, **default_kw),
        SweepPoint("tuned", seed=seed, migration_budget=int(p["migration_budget"]),
                   sample_period=int(p["sample_period"]), ewma_lambda=float(p["ewma_lambda"]),
                   hysteresis=float(p["hysteresis"]), num_bins=int(p["num_bins"]),
                   alloc_headroom=int(p["alloc_headroom"])),
    )
    t0 = time.perf_counter()
    res = run_sweep(ScenarioSweep(scenario=scenario, points=points), num_pages=geom.n_pages,
                    fast_capacity=geom.fast, migration_budget=default_kw["migration_budget"],
                    max_tenants=geom.max_tenants, queue_size=geom.queue_size,
                    policy_chunk=geom.policy_chunk)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    a, b = prof["search"]["scored_window"]
    ls = hillclimb.ls_tenants(scenario)
    d_agg, d_p99 = hillclimb.measure_history(res.results["default"].history, (a, b), ls)
    t_agg, t_p99 = hillclimb.measure_history(res.results["tuned"].history, (a, b), ls)
    check(all(len(r.history) == geom.n_epochs for r in res.results.values()),
          f"{name}: every epoch recorded")
    return dict(scenario=scenario.name, pages=geom.n_pages, epochs=geom.n_epochs,
                window=f"{a}-{b}", wall_s=wall_s, default_agg=d_agg,
                default_ls_p99_us=d_p99 * 1e6, tuned_agg=t_agg, tuned_ls_p99_us=t_p99 * 1e6,
                agg_pct=100 * (t_agg / max(d_agg, 1e-12) - 1),
                ls_p99_pct=100 * (t_p99 / max(d_p99, 1e-12) - 1),
                claim_holds=bool(t_agg >= d_agg * (1 - AT_REL_EPS)
                                 and t_p99 <= d_p99 * (1 + AT_REL_EPS)))


def state_bytes(np, st) -> dict:
    return {k: v.tobytes() for k, v in state_leaves(np, st)}


def online_legs(torch, np):
    """Phase 14c: the skewshift probe at 16,384 pages x 64 epochs (fast
    P/8, the plan buffer fast/2, budget fast/8, policy_chunk 2) with default
    params and with an ``OnlineTuner`` on SkewChange; recovery epochs of
    the shifted tenant, the retunes, ms a burst; the records before the
    first retune equal between the legs, and the live manager's state and
    generator bit-equal across every burst."""
    from repro_torch.core.manager import CentralManager
    from repro_torch.core.scenario import SkewChange, recovery_epochs
    from repro_torch.core.simulator import OPTANE, ColocationSim
    from repro_torch.core.types import state_to_numpy
    from repro_torch.launch import hillclimb

    fast = ON_PAGES // 8
    shift = ON_EPOCHS // 2
    scenario = hillclimb.skewshift_scenario(ON_PAGES, ON_EPOCHS)

    def make_sim():
        mgr = CentralManager(num_pages=ON_PAGES, fast_capacity=fast, migration_budget=fast // 2,
                             max_tenants=8)
        mgr.params = mgr.params._replace(migration_budget=max(fast // 8, 8))
        return ColocationSim(mgr, OPTANE, seed=ON_SEED, policy_chunk=ON_CHUNK)

    sim_d = make_sim()
    t0 = time.perf_counter()
    res_d = sim_d.run_scenario(scenario)
    torch.cuda.synchronize()
    default_s = time.perf_counter() - t0
    sim_o = make_sim()
    tuner = hillclimb.OnlineTuner(sim_o, seed=ON_SEED, triggers=(SkewChange,))
    check(tuner.device.type == "cuda" and sim_o.backend.device.type == "cuda",
          "phase 14 online legs run on the card")
    bursts = []
    burst = tuner._burst

    def checked_burst(cands, rng):
        m = sim_o.backend
        m._ensure_segs()
        before = state_bytes(np, state_to_numpy(m._state))
        gen = m._state.rng.get_state().clone()
        queue = m.queue_counters()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = burst(cands, rng)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        same = (state_bytes(np, state_to_numpy(m._state)) == before
                and torch.equal(m._state.rng.get_state(), gen) and m.queue_counters() == queue)
        bursts.append((same, ms))
        return out

    tuner._burst = checked_burst
    t0 = time.perf_counter()
    res_o = sim_o.run_scenario(scenario, on_event=tuner.on_event)
    torch.cuda.synchronize()
    online_s = time.perf_counter() - t0
    rec_d, base_d = recovery_epochs(res_d.history, shift, tenant="kvs")
    rec_o, base_o = recovery_epochs(res_o.history, shift, tenant="kvs")
    first = tuner.retunes[0]["epoch"] if tuner.retunes else ON_EPOCHS
    before_equal = text_of(res_d.history[:first]) == text_of(res_o.history[:first])
    check(tuner.retunes and len(bursts) == len(tuner.retunes), f"retunes {len(tuner.retunes)}")
    check(before_equal, f"the legs' records before the first retune (epoch {first}) are equal")
    check(all(same for same, _ in bursts), "the live manager's state, queue and generator "
          "are bit-equal across every burst")
    out = dict(pages=ON_PAGES, epochs=ON_EPOCHS, shift_epoch=shift, default_s=default_s,
               online_s=online_s, pre_shift_throughput=base_d,
               recovery_epochs_default=rec_d, recovery_epochs_online=rec_o,
               claim_fewer_epochs=rec_o < rec_d, records_before_retune_equal=before_equal,
               bursts=len(bursts), burst_ms=";".join(f"{ms:.1f}" for _, ms in bursts),
               live_state_unchanged=all(same for same, _ in bursts),
               steady_agg_default=res_d.steady_state.agg_throughput,
               steady_agg_online=res_o.steady_state.agg_throughput)
    retunes = [{k: r[k] for k in ("epoch", "trigger", "chosen", "budget", "sample_period")}
               for r in tuner.retunes]
    return out, retunes


def autotune_64k(torch, np):
    """Phase 14: the search, the three profile replays, the online legs;
    launches counted over the whole phase."""
    from repro_torch.kernels import ops

    search, winner, launches = autotune_search(torch, np)
    free_device(torch)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    replays = {name: profile_replay(torch, np, fam, name) for fam, name in AT_PROFILES}
    online, retunes = online_legs(torch, np)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    launches = {k: launches[k] + after[k] for k in launches}
    # the online legs' live manager ticks alone (three tally an epoch); the
    # search, the replays and the bursts tick as fleets, under vmap
    check(not any(v for k, v in launches.items() if k != "tally")
          and launches["tally"] > 0 and launches["tally"] % 3 == 0,
          f"the tuner's path launches tally only, from the live manager: {launches}")
    return search, winner, replays, online, retunes, launches


def exact_seams(hillclimb, moved: list):
    """tests/test_torch_autotune.py's seams: ``sample_period`` pinned to 1
    and every sweep at 4 KiB pages and 40 us epochs (exact counts inside
    the heat bins); returns an undo."""
    from repro_torch.core.simulator import OPTANE

    space, orig = hillclimb.SEARCH_SPACE, hillclimb.run_sweep
    pinned = dict(space)
    pinned["sample_period"] = dict(kind="int", lo=1, hi=1, log=True, default=1)

    def wrapped(sweep, **kw):
        res = orig(sweep, machine=dataclasses.replace(OPTANE, page_bytes=4096),
                   epoch_seconds=4e-5, **kw)
        moved.append(max(sum(r.migrated_pages for r in v.history) for v in res.results.values()))
        return res

    hillclimb.SEARCH_SPACE, hillclimb.run_sweep = pinned, wrapped

    def undo():
        hillclimb.SEARCH_SPACE, hillclimb.run_sweep = space, orig

    return undo


def tuner_gpu_vs_cpu(torch, np) -> dict:
    """Phase 15: the exact search on the card and on the CPU, trajectory
    and winner equal; then sampled on the card, the same seed twice and a
    search stopped at ``stop_after`` and resumed, each equal to the first."""
    import tempfile

    from repro_torch.launch import hillclimb

    geom = hillclimb.TunerGeometry(n_pages=TG_PAGES, n_epochs=TG_EPOCHS, fast=TG_FAST,
                                   policy_chunk=TG_CHUNK)

    def tuner(device, **kw):
        return hillclimb.PolicyAutotuner("skewshift", geom, population=TG_POPULATION,
                                         generations=TG_GENERATIONS, seed=TG_SEED,
                                         device=device, **kw)

    moved: list = []
    undo = exact_seams(hillclimb, moved)
    try:
        times = {}
        runs = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            runs[dev] = tuner(dev).search()
            times[dev] = time.perf_counter() - t0
    finally:
        undo()
    gpu, cpu = runs["cuda"], runs["cpu"]
    exact_equal = gpu.trajectory == cpu.trajectory and gpu.winner == cpu.winner \
        and gpu.ref == cpu.ref
    check(exact_equal, "the exact search's trajectory and winner equal on the card and the CPU")
    check(max(moved) > 0, f"a candidate migrated pages in the exact search: {moved}")

    t0 = time.perf_counter()
    first = tuner("cuda").search()
    sampled_s = time.perf_counter() - t0
    again = tuner("cuda").search()
    same_seed = first.trajectory == again.trajectory and first.winner == again.winner
    check(same_seed, "the same seed gives the same trajectory on the card")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as out:
        partial = tuner("cuda", out_dir=out, checkpoint_every=4).search(stop_after=5)
        resumed = tuner("cuda", out_dir=out, checkpoint_every=4).search(resume=True)
    check(partial.interrupted and not resumed.interrupted, "stopped, then resumed to the end")
    resume_equal = resumed.trajectory == first.trajectory and resumed.winner == first.winner
    check(resume_equal, "the resumed search equals the uninterrupted one on the card")
    return dict(pages=TG_PAGES, epochs=TG_EPOCHS, population=TG_POPULATION,
                generations=TG_GENERATIONS, exact_gpu_s=times["cuda"], exact_cpu_s=times["cpu"],
                exact_trajectory_equal=exact_equal, exact_max_migrated=max(moved),
                sampled_search_s=sampled_s, same_seed_equal=same_seed,
                resume_equal=resume_equal, winner_generation=first.winner["generation"],
                winner_index=first.winner["index"])


# ------------------------------------------------------------------ phase 16
# train-qwen25-3b: qwen2.5-3b at full width and depth on the train_4k cell's
# 4,096-token rows (the port's LM_SHAPES), 8 rows a step in 4 microbatches,
# from SyntheticTokens through PrefetchIterator as launch/train.py wires them
TR_ARCH, TR_BATCH, TR_MICRO, TR_TIMED = "qwen2.5-3b", 8, 4, 4
TR_SEQ = get_shape("train_4k").seq_len
TR_PARAMS = get_config(TR_ARCH).param_count()  # equal to the materialised tree's
TR_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=100)
TR_PEAK_GIB = 80.0


def train_qwen25(torch, np, device):
    """Phase 16: ``train_cell`` on qwen2.5-3b."""
    from repro_torch.configs import get_config

    return train_cell(torch, np, device, get_config(TR_ARCH), batch=TR_BATCH, seq=TR_SEQ,
                      micro=TR_MICRO, n_params=TR_PARAMS, tag="phase16", timed=TR_TIMED)


def train_cell(torch, np, device, cfg, *, batch: int, seq: int, micro: int, n_params: int,
               tag: str, timed: int, extra=None):
    """One warm-up step and ``timed`` timed steps on batch 0 of
    ``SyntheticTokens`` (through ``PrefetchIterator``, as launch/train.py
    wires it), each split into the batch's copy to the card (host), forward
    + backward and the optimizer (synchronised at the optimizer's start and
    end), then one step under the profiler. ``extra(cfg, batch)`` adds
    inputs to the batch on the card (whisper's frame embeddings). The
    model-FLOPs share is ``roofline.model_flops_per_step`` of the step's
    rows over its mean time and the card's bf16 peak."""
    from repro_torch.analysis import roofline
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, PrefetchIterator, SyntheticTokens
    from repro_torch.launch.train import to_device
    from repro_torch.training import train_state as ts
    from repro_torch.training.optimizer import AdamWConfig, named_leaves

    t0 = time.perf_counter()
    state = ts.init_train_state(cfg, SEED, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    got_params = sum(p.numel() for _, p in named_leaves(state.params))
    check(got_params == n_params, f"{cfg.name} has {n_params} parameters ({got_params})")
    step = ts.make_train_step(cfg, AdamWConfig(**TR_OPT), remat="block", microbatch=micro)
    it = PrefetchIterator(SyntheticTokens(DataConfig(cfg.vocab_size, seq, batch, seed=17)))
    try:
        data_step, host_batch = next(it)
    finally:
        it.close()
    check(data_step == 0, "the prefetch iterator starts at batch 0")
    more = extra(cfg, batch) if extra else {}

    marks = {}
    update = ts.adamw_update

    def timed_update(*args, **kw):
        torch.cuda.synchronize()
        marks["opt0"] = time.perf_counter()
        out = update(*args, **kw)
        torch.cuda.synchronize()
        marks["opt1"] = time.perf_counter()
        return out

    ts.adamw_update = timed_update
    rows = []
    try:
        for i in range(1 + timed):
            t_h = time.perf_counter()
            b = {**to_device(host_batch, device), **more}
            torch.cuda.synchronize()
            t_s = time.perf_counter()
            state, m = step(state, b)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            t_e = time.perf_counter()
            rows.append(dict(step_ms=(t_e - t_h) * 1e3, host_ms=(t_s - t_h) * 1e3,
                             fwd_bwd_ms=(marks["opt0"] - t_s) * 1e3,
                             optimizer_ms=(marks["opt1"] - marks["opt0"]) * 1e3,
                             loss=loss, grad_norm=gnorm, lr=float(m["lr"])))
            emit(f"{tag} step {i}" + (" (warm-up)" if i == 0 else ""), **rows[-1])
        prof = device_busy(torch, lambda: step(state, b), 1)
    finally:
        ts.adamw_update = update
    timed = rows[1:]
    step_s = sum(r["step_ms"] for r in timed) / len(timed) / 1e3
    tok_s = batch * seq / step_s
    model_flops = roofline.model_flops_per_step(
        cfg, ShapeConfig(f"train_{seq}", seq, batch, "train"), 1)
    mean = {k: sum(r[k] for r in timed) / len(timed)
            for k in ("step_ms", "host_ms", "fwd_bwd_ms", "optimizer_ms")}
    del state, step, b, more
    return dict(params=got_params, batch=batch, seq=seq, microbatch=micro,
                init_s=init_s, **mean, tokens_per_s=tok_s, model_flops=model_flops,
                model_flops_share=model_flops / step_s / roofline.PEAK_FLOPS,
                losses=";".join(f"{r['loss']:.5f}" for r in rows),
                grad_norms=";".join(f"{r['grad_norm']:.4f}" for r in rows),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, **prof)


def check_train(np, tr: dict) -> None:
    losses = [float(x) for x in tr["losses"].split(";")]
    norms = [float(x) for x in tr["grad_norms"].split(";")]
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"finite loss and grad norm at every step: {losses} {norms}")
    check(losses[-1] < losses[1], f"the loss falls over the timed steps: {losses[1:]}")
    check(tr["peak_gib"] < TR_PEAK_GIB, f"peak {tr['peak_gib']:.2f} GiB under {TR_PEAK_GIB}")


# ------------------------------------------------------------------ phase 17
# lm-decode: the contiguous-cache decode at the same width and depth: 8
# prompts of 1,024 tokens, 128 greedy steps in each commit branch
LD_BATCH, LD_PROMPT, LD_STEPS, LD_AGREE, LD_FORCED = 8, 1024, 128, 16, 8
LD_MAX = LD_PROMPT + LD_STEPS
# the two commit branches round differently (the eager one normalises the
# probabilities before its bf16 cast, the deferred one merges the current
# token in float32): each step's logits agree within bf16's tolerance
# (ATTN_TOL) in relative L2 norm, and each branch's greedy token is within
# that share of the row's largest |logit| of the other branch's top
LD_TOL = ATTN_TOL["bfloat16"]


def decode_bytes(params_bytes: int, cfg, pos: int) -> int:
    """Bytes one decode step at ``pos`` must move: every weight once, the
    cache's first ``pos`` keys and values of every layer, the new key and
    value written, the float32 logits written."""
    row = cfg.num_kv_heads * cfg.d_head * 2  # one token's key (or value) of a layer, bf16
    return (params_bytes + 2 * cfg.num_layers * LD_BATCH * (pos + 1) * row
            + LD_BATCH * cfg.vocab_size * 4)


def top2_margin(torch, logits) -> float:
    """The smallest gap between the two largest logits of any row."""
    top = torch.topk(logits.float(), 2, dim=-1).values
    return float((top[:, 0] - top[:, 1]).min())


def near_top(torch, logits, tok, tol: float) -> bool:
    """Every row's logit at ``tok`` is within ``tol`` x the row's largest
    |logit| of its largest logit: ``tok`` is a greedy choice of these logits
    up to that tolerance (the logits are bf16 products, so the top of a
    151,936-way row holds exact ties)."""
    top = logits.max(dim=-1).values
    at = logits.gather(1, tok[:, None])[:, 0]
    return bool((at >= top - tol * logits.abs().max(dim=-1).values).all())


def lm_decode(torch, np, device):
    """Prefill, then LD_STEPS greedy steps under the deferred commit; the eager
    branch is fed the same tokens (so their logits compare at every step)
    and its own greedy choices are compared with the deferred branch's;
    then teacher forcing and one profiled step."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import tuning
    from repro_torch.models.model import get_model
    from repro_torch.models.transformer import KVCache

    cfg = get_config(TR_ARCH)
    api = get_model(cfg)
    params = api.init(seed=SEED, device=device)
    params_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    prompt = torch.as_tensor(SyntheticTokens(DataConfig(cfg.vocab_size, LD_PROMPT, LD_BATCH,
                                                        seed=SEED)).batch_at(0)["tokens"],
                             device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits0, cache0 = api.prefill(params, prompt, LD_MAX)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3

    def fresh():
        return KVCache(cache0.k.clone(), cache0.v.clone(), cache0.pos)

    first = torch.argmax(logits0[:, -1], dim=-1)
    feed, ref_logits, out = [first], [], {}
    for deferred in (True, False):
        cache, tok, times, choice, diffs, l2, near = fresh(), first, [], [], [], [], []
        with tuning.tuned(decode_deferred_commit=deferred):
            for i in range(LD_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, cache = api.decode(params, tok, cache)
                nxt = torch.argmax(logits, dim=-1)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
                if deferred:
                    ref_logits.append(logits)
                    feed.append(nxt)
                    tok = nxt
                else:  # the deferred branch's tokens in, its own choice out
                    choice.append(nxt)
                    ref = ref_logits[i]
                    diffs.append(float((logits - ref).abs().max() / ref.abs().max()))
                    l2.append(float(torch.linalg.vector_norm(logits - ref)
                                    / torch.linalg.vector_norm(ref)))
                    near.append(near_top(torch, logits, feed[i + 1], LD_TOL)
                                and near_top(torch, ref, nxt, LD_TOL))
                    tok = feed[i + 1]
        times.sort()
        name = "deferred" if deferred else "eager"
        out[name] = dict(step_ms_p50=times[len(times) // 2],
                         step_ms_p99=times[min(len(times) - 1, int(0.99 * len(times)))],
                         tokens_per_s=LD_BATCH * LD_STEPS / (sum(times) / 1e3))
        if not deferred:
            same = [int((c == f).sum()) for c, f in zip(choice, feed[1:])]
            out["branches"] = dict(
                tol=LD_TOL, max_rel_l2_logit_diff=max(l2), first_step_rel_l2=l2[0],
                max_elem_diff_over_max_logit=max(diffs), first_step_elem_diff=diffs[0],
                max_logit=float(ref_logits[0].abs().max()),
                near_top_lead_steps=next((i for i, ok in enumerate(near) if not ok),
                                         len(near)),
                argmax_equal_lane_steps=sum(same), lane_steps=LD_BATCH * LD_STEPS,
                argmax_equal_lane_steps_first16=sum(same[:LD_AGREE]),
                min_top2_margin_first16=min(top2_margin(torch, x)
                                            for x in ref_logits[:LD_AGREE]))
    # teacher forcing: the prompt and the first 8 generated tokens predict the 9th
    gen = torch.stack(feed, dim=1)  # [B, 1 + LD_STEPS]
    forced, _ = api.prefill(params, torch.cat([prompt, gen[:, :LD_FORCED]], dim=1),
                            LD_PROMPT + LD_FORCED)
    forced_tok = torch.argmax(forced[:, -1], dim=-1)
    yard = ref_logits[LD_FORCED - 1]  # the decode step that predicted the same token
    out["teacher_forcing"] = dict(
        lanes_equal=int((forced_tok == gen[:, LD_FORCED]).sum()), lanes=LD_BATCH,
        prefill_vs_decode_rel_l2=float(torch.linalg.vector_norm(forced[:, -1] - yard)
                                       / torch.linalg.vector_norm(yard)),
        forced_top2_margin=top2_margin(torch, forced[:, -1]),
        decode_top2_margin=top2_margin(torch, ref_logits[LD_FORCED - 1]))
    del ref_logits

    out["prefill_logits"] = logits0.cpu()
    cache = fresh()
    prof = device_busy(torch, lambda: api.decode(params, first, cache), 1)
    mean_pos = LD_PROMPT + (LD_STEPS - 1) / 2
    out["deferred"].update(prof, prefill_ms=prefill_ms,
                           bound_ms=bound_ms(decode_bytes(params_bytes, cfg, int(mean_pos))),
                           bound_gb=decode_bytes(params_bytes, cfg, int(mean_pos)) / 1e9)
    del params, cache, cache0
    return out


def check_decode(out: dict) -> None:
    br, tf = out["branches"], out["teacher_forcing"]
    check(br["max_rel_l2_logit_diff"] <= LD_TOL,
          f"the commit branches' logits within {LD_TOL} in relative L2 at every step: {br}")
    check(br["near_top_lead_steps"] >= LD_AGREE,
          f"each branch's greedy token is a greedy choice of the other's logits, within "
          f"bf16's tolerance, for the first {LD_AGREE} steps: {br}")
    check(tf["lanes_equal"] == LD_BATCH, f"teacher forcing predicts every lane: {tf}")


# ------------------------------------------------------------------ phase 18
# train-gpu-vs-cpu: the smoke train steps on the card and the CPU, then
# checkpoint / resume bit for bit (full width, 2 layers) and through the CLI
GC_STEPS, GC_LOSS_RTOL, GC_PARAM_ATOL = 6, 1e-4, 2e-4
RS_LAYERS, RS_BATCH, RS_SEQ = 2, 2, 512


def _leaf_list(state):
    from repro_torch.training.optimizer import named_leaves

    out = [t for tree in (state.params, state.opt.m, state.opt.v)
           for _, t in named_leaves(tree)]
    return out + [state.opt.step]


def bit_equal(torch, a, b) -> bool:
    return all(torch.equal(bits(torch, x), bits(torch, y))
               for x, y in zip(_leaf_list(a), _leaf_list(b)))


def train_gpu_vs_cpu(torch, np, device):
    import shutil
    import tempfile

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch import train
    from repro_torch.training.optimizer import AdamWConfig, named_leaves
    from repro_torch.training.train_state import init_train_state, make_train_step, state_to

    out = {}
    # the smoke config in float32, one state on the CPU and its copy on the card
    check(not torch.backends.cuda.matmul.allow_tf32, "float32 products without TF32")
    cfg = get_config(TR_ARCH).smoke()
    cpu = init_train_state(cfg, SEED, device="cpu")
    gpu = state_to(cpu, device)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2), microbatch=2)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 64, 4, seed=17))
    rel = 0.0
    for s in range(GC_STEPS):
        b = {k: torch.as_tensor(v) for k, v in data.batch_at(s).items()}
        cpu, mc = step(cpu, b)
        gpu, mg = step(gpu, {k: v.to(device) for k, v in b.items()})
        rel = max(rel, abs(float(mg["loss"]) - float(mc["loss"])) / abs(float(mc["loss"])))
    err = max(float((g.cpu() - c).abs().max())
              for (_, c), (_, g) in zip(named_leaves(cpu.params), named_leaves(gpu.params)))
    out["smoke"] = dict(steps=GC_STEPS, loss_max_rel_diff=rel, param_max_abs_diff=err)
    check(rel <= GC_LOSS_RTOL, f"card and CPU losses within {GC_LOSS_RTOL} relative ({rel})")
    check(err <= GC_PARAM_ATOL, f"card and CPU parameters within {GC_PARAM_ATOL} ({err})")
    del cpu, gpu

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    torch.use_deterministic_algorithms(True)
    try:
        # full width cut to 2 layers, bf16: 3 steps, save, restore, 3 steps
        cfg2 = dataclasses.replace(get_config(TR_ARCH), num_layers=RS_LAYERS)
        step2 = make_train_step(cfg2, AdamWConfig(**TR_OPT), remat="block")
        data2 = SyntheticTokens(DataConfig(cfg2.vocab_size, RS_SEQ, RS_BATCH, seed=17))

        def run(state, start, n):
            for s in range(start, start + n):
                batch = {k: torch.as_tensor(v).to(device)
                         for k, v in data2.batch_at(s).items()}
                state, _ = step2(state, batch)
            return state

        straight = run(init_train_state(cfg2, SEED, device=device), 0, 6)
        half = run(init_train_state(cfg2, SEED, device=device), 0, 3)
        ck = Checkpointer(os.path.join(tmp, "resume"))
        t0 = time.perf_counter()
        ck.save(3, half, blocking=True)
        save_s = time.perf_counter() - t0
        del half
        t0 = time.perf_counter()
        resumed, _ = ck.restore(init_train_state(cfg2, SEED + 1, device=device))
        restore_s = time.perf_counter() - t0
        resumed = run(resumed, 3, 3)
        out["resume"] = dict(layers=RS_LAYERS, save_s=save_s, restore_s=restore_s,
                             checkpoint_gb=sum(t.numel() * t.element_size()
                                               for t in _leaf_list(straight)) / 1e9,
                             bit_equal=bit_equal(torch, straight, resumed))
        del straight, resumed
        check(out["resume"]["bit_equal"], "3 steps + save + restore + 3 steps == 6 steps")

        # the CLI on the card: 12 steps straight; step 6's checkpoint resumed
        args = ["--arch", TR_ARCH, "--smoke", "--steps", "12", "--ckpt-every", "6",
                "--log-every", "6"]
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        straight = train.main(args + ["--ckpt-dir", a])
        os.makedirs(b)
        shutil.copytree(os.path.join(a, "step_00000006"), os.path.join(b, "step_00000006"))
        resumed = train.main(args + ["--ckpt-dir", b, "--resume"])
        out["cli"] = dict(device=str(straight.params["embed"].device),
                          bit_equal=bit_equal(torch, straight, resumed),
                          step=int(resumed.opt.step))
        check(out["cli"]["bit_equal"] and out["cli"]["step"] == 12
              and straight.params["embed"].device.type == device.type,
              f"the CLI on the card, resumed at step 6, equals 12 straight steps: {out['cli']}")
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ------------------------------------------------------------------ phases 19-22
# the SSM, hybrid and encoder-decoder families at full width and depth, bf16
# weights from a seed and float32 AdamW moments. Training: the train_4k cell's
# 4,096-token rows (the port's LM_SHAPES), 8 of its 256 rows a step (one
# card); whisper at its published 448-token decoder length, 32 rows over 1,500
# stub frames each. The parameters are the materialised trees' counts, which
# differ from ``param_count`` for these three
# (tests/test_torch_config_shapes.py pins each difference)
FM_TRAIN = {  # arch -> (rows a step, tokens a row, microbatches, parameters)
    "mamba2-130m": (8, TR_SEQ, 1, 128_983_488),
    "zamba2-1.2b": (8, TR_SEQ, 4, 1_088_160_640),
    "whisper-tiny": (32, 448, 1, 36_448_128),
}
# decode: arch -> (lanes, prompt tokens, cache positions); whisper's prompt
# is one start token per lane after the encoder's prefill
FM_DECODE = {
    "mamba2-130m": (8, 1024, 1024 + 128),
    "zamba2-1.2b": (8, 4608, 4608 + 128),  # longer than the 4,096 window: the ring wraps
    "whisper-tiny": (32, 1, 448),
}
FM_STEPS, FM_FORCED, FM_TIMED = 128, 8, 4
FM_TOL = ATTN_TOL["bfloat16"]
FG_HANDOFF_TOL = 1e-4  # float32: the prefill of the consumed tokens against the decode
# the long_500k cell for mamba2-130m (the port's LM_SHAPES and
# LONG_CONTEXT_ARCHS): one lane, 524,288 tokens, then 32 steps, against 32
# steps after a 1,024-token prompt
FM_LONG = get_shape("long_500k").seq_len
FM_SHORT, FM_LONG_STEPS, FM_LONG_RATIO = 1024, 32, 1.5


def stub_frames(torch, cfg, batch: int, device, seed: int = SEED):
    """Whisper's stub frontend output: [batch, 1,500, d] float32 normal
    frame embeddings from ``seed``, as tests/test_arch_smoke.py makes them."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn((batch, cfg.max_encoder_len, cfg.d_model), generator=g, device=device)


def train_family(torch, np, device, arch: str, tag: str):
    from repro_torch.configs import get_config

    rows, seq, micro, n_params = FM_TRAIN[arch]
    extra = None
    if arch == "whisper-tiny":
        def extra(cfg, batch):
            return {"enc_embeds": stub_frames(torch, cfg, batch, device)}
    return train_cell(torch, np, device, get_config(arch), batch=rows, seq=seq, micro=micro,
                      n_params=n_params, tag=tag, timed=FM_TIMED, extra=extra)


def nbytes(tree) -> int:
    """Bytes of every tensor in a nested dict / NamedTuple."""
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, tuple):
        return sum(nbytes(v) for v in tree)
    return tree.numel() * tree.element_size() if hasattr(tree, "numel") else 0


def family_step_bytes(cfg, params_bytes: int, cache, lanes: int, pos: int) -> int:
    """Bytes one decode step at ``pos`` must move: every weight once, the
    SSM states and conv windows read and written, the attention keys and
    values up to ``pos`` (the hybrid's ring: at most its window) read and
    the new ones written, the float32 logits written."""
    row = cfg.num_kv_heads * cfg.d_head * 2  # one token's key (or value), bf16
    out = params_bytes + lanes * cfg.vocab_size * 4
    if cfg.family == "ssm":
        return out + 2 * nbytes(cache.layers)
    if cfg.family == "hybrid":
        n = min(pos + 1, cache.k.shape[2])
        return (out + 2 * (nbytes(cache.group_ssm) + nbytes(cache.tail_ssm))
                + 2 * cfg.attn_invocations * lanes * n * row)
    T = cache.ck.shape[2]
    return out + 2 * cfg.num_layers * lanes * ((pos + 1) + T) * row


def clone_cache(torch, cache):
    """A copy of a decode cache: the decode writes its tensors in place."""
    if isinstance(cache, torch.Tensor):
        return cache.clone()
    if isinstance(cache, tuple):
        return type(cache)(*(clone_cache(torch, c) for c in cache))
    return cache


def rel_l2(torch, a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).float()) / torch.linalg.vector_norm(b.float()))


def decode_family(torch, np, device, arch: str):
    """Prefill (its ``flash_attention`` launches counted), FM_STEPS greedy
    decode steps (p50 / p99, tokens/s), one step profiled against its bytes
    bound, then teacher forcing: the context and the first FM_FORCED tokens
    the decode consumed, prefilled, give the logits of the decode step that
    consumed the last of them (relative L2 within bf16's tolerance) and rank
    the token that step chose within that tolerance of their top."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.models import encdec
    from repro_torch.models.model import get_model

    cfg = get_config(arch)
    api = get_model(cfg)
    lanes, plen, max_len = FM_DECODE[arch]
    params = api.init(seed=SEED, device=device)
    params_bytes = nbytes(params)
    prompt = torch.as_tensor(SyntheticTokens(DataConfig(cfg.vocab_size, plen, lanes,
                                                        seed=SEED)).batch_at(0)["tokens"],
                             device=device)
    audio = cfg.family == "audio"
    enc = stub_frames(torch, cfg, lanes, device) if audio else None
    torch.cuda.synchronize()
    before = ops.launch_counts()["flash_attention"]
    t0 = time.perf_counter()
    if audio:
        cache0 = api.prefill(params, enc, max_len)  # encdec.prefill_cross
        first = prompt[:, 0]  # the start token
    else:
        logits0, cache0 = api.prefill(params, prompt, max_len)
        first = torch.argmax(logits0, dim=-1)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_flash = ops.launch_counts()["flash_attention"] - before
    context = prompt[:, :0] if audio else prompt
    forced_k = FM_FORCED + (1 if audio else 0)  # the start token and 8 generated

    cache, tok, times, consumed, kept = clone_cache(torch, cache0), first, [], [first], {}
    for i in range(FM_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = api.decode(params, tok, cache)
        tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        consumed.append(tok)
        if i == forced_k - 1:
            kept["forced"] = logits
        check(bool(torch.isfinite(logits).all()), f"{arch}: finite logits at step {i}")
    times.sort()
    out = dict(lanes=lanes, prompt=plen, steps=FM_STEPS, prefill_ms=prefill_ms,
               prefill_flash_launches=prefill_flash,
               step_ms_p50=times[len(times) // 2],
               step_ms_p99=times[min(len(times) - 1, int(0.99 * len(times)))],
               tokens_per_s=lanes * FM_STEPS / (sum(times) / 1e3))
    gen = torch.stack(consumed, dim=1)
    ctx = torch.cat([context, gen[:, :forced_k]], dim=1)
    if audio:
        forced, _ = encdec.prefill(params, enc, ctx, cfg, max_len)
    else:
        forced, _ = api.prefill(params, ctx, ctx.shape[1])
    want = kept["forced"]
    out["teacher_forcing"] = dict(
        tokens=ctx.shape[1], prefill_vs_decode_rel_l2=rel_l2(torch, forced, want),
        lanes_equal=int((torch.argmax(forced, dim=-1) == gen[:, forced_k]).sum()),
        near_top=near_top(torch, forced, gen[:, forced_k], FM_TOL),
        forced_top2_margin=top2_margin(torch, forced))
    mean_pos = (0 if audio else plen) + (FM_STEPS - 1) // 2
    one = clone_cache(torch, cache0)
    prof = device_busy(torch, lambda: api.decode(params, first, one), 1)
    step_bytes = family_step_bytes(cfg, params_bytes, cache0, lanes, mean_pos)
    out.update(prof, params_gb=params_bytes / 1e9, bound_ms=bound_ms(step_bytes),
               bound_gb=step_bytes / 1e9)
    del params, cache, cache0, one
    return out


def check_family_decode(arch: str, out: dict) -> None:
    """The token the decode chose lies within FM_TOL of the top of the
    teacher-forced prefill's logits, as phase 17 holds it. Their relative L2
    gap is printed, not held: in bf16 the chunked prefill and the recurrent
    decode round differently, a gap that grows with depth in the reference
    too (tests/test_torch_lm_families.py::test_bf16_handoff_gap_is_the_reference_s);
    phase 22 holds the handoff in float32."""
    tf = out["teacher_forcing"]
    check(tf["near_top"], f"{arch}: the decode's token is a greedy choice of the teacher-forced "
                          f"prefill's logits within {FM_TOL}: {tf}")


def lane_steps(torch, api, params, lanes: dict, names, n: int) -> dict:
    """``n`` greedy decode steps of each named lane of ``lanes`` (name ->
    (token, cache), advanced in place), taken in turns; per lane the p50 and
    the largest wall ms of a step, and the host's cost of one bare launch
    (an in-place add on one element, 2,000 issued back to back) right after:
    the step is launch-bound, so the two move together."""
    wall, finite = ({name: [] for name in names} for _ in range(2))
    for _ in range(n):
        for name in names:
            tok, cache = lanes[name]
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = api.decode(params, tok, cache)
            tok = torch.argmax(logits, dim=-1)
            torch.cuda.synchronize()
            wall[name].append((time.perf_counter() - t) * 1e3)
            finite[name].append(bool(torch.isfinite(logits).all()))
            lanes[name] = (tok, cache)
    one = torch.zeros(1, device=tok.device)
    launch_us = host_ms(torch, lambda: one.add_(1), launches=2000) * 1e3
    out = {}
    for name in names:
        w = sorted(wall[name])
        out[name] = dict(step_ms_p50=w[len(w) // 2], step_ms_max=w[-1], launch_us=launch_us,
                         finite=all(finite[name]))
    return out


def mamba_long(torch, np, device):
    """The long_500k cell: one lane prefilled with 1,024 tokens and stepped
    FM_LONG_STEPS times alone, twice with nothing between (the host's drift
    alone); then one prefilled with 524,288 tokens, and FM_LONG_STEPS
    greedy steps of each lane taken in turns (the two positions under the
    same host conditions), again after ``free_device``, one step of each
    profiled, and the short lane's steps once more after the profiler. The
    state is O(1): neither the step's wall time nor its device busy time may
    grow with the position; the short lane's steps at each stage, beside
    the host's cost of a bare launch, tell what else moves the host-bound
    step."""
    from repro_torch.models.model import get_model

    check("mamba2-130m" in LONG_CONTEXT_ARCHS, "mamba2-130m may run the long_500k cell")
    cfg = get_config("mamba2-130m")
    api = get_model(cfg)
    params = api.init(seed=SEED, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 5)
    out, lanes = {}, {}
    for name, n in (("short", FM_SHORT), ("long", FM_LONG)):
        if name == "long":
            for seg in ("short_before", "short_again"):
                out[seg] = lane_steps(torch, api, params, lanes, ("short",),
                                      FM_LONG_STEPS)["short"]
        prompt = torch.randint(0, cfg.vocab_size, (1, n), generator=g, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, prompt)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        del prompt
        lanes[name] = (torch.argmax(logits, dim=-1), cache)
        out[name] = dict(prompt=n, prefill_s=prefill_s, prefill_tokens_per_s=n / prefill_s,
                         prefill_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del logits, cache
    for name, row in lane_steps(torch, api, params, lanes, ("short", "long"),
                                FM_LONG_STEPS).items():
        out[name].update(row)
    free_device(torch)
    freed = lane_steps(torch, api, params, lanes, ("short", "long"), FM_LONG_STEPS)
    out["short_freed"], out["long_freed"] = freed["short"], freed["long"]
    for name in ("short", "long"):
        tok, cache = lanes[name]
        one = clone_cache(torch, cache)
        busy = device_busy(torch, lambda: api.decode(params, tok, one), 1)
        out[name].update(step_device_busy_ms=busy["device_busy_ms"], pos=cache.pos)
        del one
    out["short_profiled"] = lane_steps(torch, api, params, lanes, ("short",),
                                       FM_LONG_STEPS)["short"]
    short = out["short"]["step_ms_p50"]
    out["ratio"] = out["long"]["step_ms_p50"] / short
    out["freed_ratio"] = out["long_freed"]["step_ms_p50"] / out["short_freed"]["step_ms_p50"]
    short_busy = out["short"]["step_device_busy_ms"]
    out["device_ratio"] = out["long"]["step_device_busy_ms"] / short_busy if short_busy else None
    # the short lane's step at each stage against its first, beside the
    # host's cost of a launch there
    first = out["short_before"]
    for seg in ("short_again", "short", "short_freed", "short_profiled"):
        out[f"{seg}_over_before"] = out[seg]["step_ms_p50"] / first["step_ms_p50"]
        out[f"{seg}_launch_over_before"] = out[seg]["launch_us"] / first["launch_us"]
    del params, lanes
    return out


def check_long(out: dict) -> None:
    rows = ("short_before", "short_again", "short", "long", "short_freed", "long_freed",
            "short_profiled")
    check(all(out[r]["finite"] for r in rows), f"finite logits: {out}")
    for key in ("ratio", "freed_ratio", "device_ratio"):
        check(out[key] is not None and out[key] < FM_LONG_RATIO,
              f"{key}: the step at position {FM_LONG} under {FM_LONG_RATIO}x the step at "
              f"{FM_SHORT}: {out[key]}")


# phase 22: each family at full width, cut in depth, in float32, the same
# weights on the card and on the CPU; rows of 256 tokens reach the published
# chunks (128, 256)
FG_CUTS = {
    "mamba2-130m": dict(num_layers=2),
    "zamba2-1.2b": dict(num_layers=3, attn_every=2),  # one group of 2 + a tail of 1
    "whisper-tiny": dict(num_layers=2, encoder_layers=2),
}
FG_BATCH, FG_SEQ, FG_STEPS, FG_DECODE, FG_PROMPT = 1, 256, 3, 8, 256
FG_LOGIT_TOL = 1e-4
FG_GRAD_TOL = 1e-4  # each gradient leaf of the first step, of its largest entry
# Adam turns an element's gradient into a step of about lr whatever its size,
# so an element whose gradient is within float32's noise of zero at some step
# takes a step of another size (even sign) on each device. At full vocabulary
# a few of the tied embedding's tens of millions do (1 of 38.6M in mamba2's,
# 2 of 65.5M in zamba2's, in this phase's card runs): the card is held on the
# gradients leaf by leaf, every other leaf within GC_PARAM_ATOL after the
# steps, and at most FG_EMBED_PAST of the embedding's elements past it
FG_EMBED_PAST = 4


def family_grads(torch, cfg, params, batch):
    """(loss, {path: gradient}) of one batch by autograd through the
    model's loss."""
    from repro_torch.models.model import get_model
    from repro_torch.training.optimizer import named_leaves, tree_map

    leaf = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = get_model(cfg).loss(leaf, batch)
    flat = named_leaves(leaf)
    grads = torch.autograd.grad(loss, [p for _, p in flat])
    return loss.detach(), {path: g for (path, _), g in zip(flat, grads)}


def families_gpu_vs_cpu(torch, np, device) -> dict:
    """Per family: the first batch's gradients from one state on the card
    and the CPU (every leaf within FG_GRAD_TOL of its largest entry, all
    finite); FG_STEPS train steps on each (losses and gradient norms within
    GC_LOSS_RTOL relative and finite; parameters within GC_PARAM_ATOL but
    for at most FG_EMBED_PAST elements of the tied embedding); then a prefill and FG_DECODE decode
    steps on each with the trained weights (logits within FG_LOGIT_TOL of
    the largest, the CPU's greedy tokens fed to both) and the state handoff
    on the card."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import encdec, hybrid, ssm_lm
    from repro_torch.training.optimizer import AdamWConfig, named_leaves
    from repro_torch.training.train_state import init_train_state, make_train_step, state_to

    check(not torch.backends.cuda.matmul.allow_tf32, "float32 products without TF32")
    out = {}
    for arch, cut in FG_CUTS.items():
        cfg = dataclasses.replace(get_config(arch), param_dtype="float32",
                                  compute_dtype="float32", **cut)
        cpu = init_train_state(cfg, SEED, device="cpu")
        gpu = state_to(cpu, device)
        step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2))
        data = SyntheticTokens(DataConfig(cfg.vocab_size, FG_SEQ, FG_BATCH, seed=17))
        frames = (stub_frames(torch, cfg, FG_BATCH, "cpu") if cfg.is_encoder_decoder else None)

        def batch_at(s):
            b = {k: torch.as_tensor(v) for k, v in data.batch_at(s).items()}
            if frames is not None:
                b["enc_embeds"] = frames
            return b

        b0 = batch_at(0)
        _, gc = family_grads(torch, cfg, cpu.params, b0)
        _, gg = family_grads(torch, cfg, gpu.params, {k: v.to(device) for k, v in b0.items()})
        grad_err, finite = 0.0, True
        for path, g in gc.items():
            finite &= bool(torch.isfinite(g).all()) and bool(torch.isfinite(gg[path]).all())
            d = float((gg[path].cpu() - g).abs().max()) / max(float(g.abs().max()), 1e-30)
            grad_err = max(grad_err, d)
        del gc, gg
        rel = 0.0
        for s in range(FG_STEPS):
            b = batch_at(s)
            cpu, mc = step(cpu, b)
            gpu, mg = step(gpu, {k: v.to(device) for k, v in b.items()})
            for k in ("loss", "grad_norm"):
                rel = max(rel, abs(float(mg[k]) - float(mc[k])) / abs(float(mc[k])))
                finite &= bool(np.isfinite(float(mc[k])) and np.isfinite(float(mg[k])))
        err, rest_err, past, n = 0.0, 0.0, 0, 0
        for (path, c), (_, g) in zip(named_leaves(cpu.params), named_leaves(gpu.params)):
            d = (g.cpu() - c).abs()
            err, n = max(err, float(d.max())), n + d.numel()
            if path == ("embed",):
                past = int((d > GC_PARAM_ATOL).sum())
            else:
                rest_err = max(rest_err, float(d.max()))
        row = dict(layers=cfg.num_layers, steps=FG_STEPS, seq=FG_SEQ,
                   chunk=cfg.ssm_chunk if cfg.ssm_state else 0,
                   grad_max_diff_over_leaf_max=grad_err, loss_gnorm_max_rel_diff=rel,
                   param_max_abs_diff=err, params_but_embed_max_abs_diff=rest_err,
                   embed_past_atol=past, params=n, finite=finite)
        check(finite, f"{arch}: finite losses and gradients on both devices at the "
                      f"published chunk: {row}")
        check(grad_err <= FG_GRAD_TOL, f"{arch}: card and CPU gradients within {FG_GRAD_TOL} "
                                       f"of each leaf's largest: {row}")
        check(rel <= GC_LOSS_RTOL, f"{arch}: card and CPU losses and gradient norms within "
                                   f"{GC_LOSS_RTOL}: {row}")
        check(rest_err <= GC_PARAM_ATOL and past <= FG_EMBED_PAST,
              f"{arch}: card and CPU parameters within {GC_PARAM_ATOL} but for at most "
              f"{FG_EMBED_PAST} elements of the tied embedding: {row}")

        prompt = torch.as_tensor(data.batch_at(FG_STEPS)["tokens"][:, :FG_PROMPT])
        max_len = FG_PROMPT + FG_DECODE
        # the decode paths compared on the same weights: the CPU's trained ones
        runs = {}
        for dev, p in (("cpu", cpu.params), ("gpu", to_device(cpu.params, device))):
            pr = prompt.to(p["embed"].device)
            if arch == "whisper-tiny":
                logits, cache = encdec.prefill(p, frames.to(pr.device), pr, cfg, max_len)
                mod = encdec
            elif arch == "zamba2-1.2b":
                logits, cache = hybrid.prefill(p, pr, cfg, max_len)
                mod = hybrid
            else:
                logits, cache = ssm_lm.prefill(p, pr, cfg, max_len)
                mod = ssm_lm
            runs[dev] = (p, mod, logits, cache)
        diff, scale, fed = 0.0, 0.0, []
        lc, lg = runs["cpu"][2], runs["gpu"][2]
        caches = {d: runs[d][3] for d in runs}
        for i in range(FG_DECODE + 1):
            diff = max(diff, float((lg.cpu() - lc).abs().max()))
            scale = max(scale, float(lc.abs().max()))
            if i == FG_DECODE:
                break
            tok = torch.argmax(lc, dim=-1)
            fed.append(tok)
            lc, caches["cpu"] = runs["cpu"][1].decode_step(runs["cpu"][0], tok, caches["cpu"],
                                                           cfg)
            lg, caches["gpu"] = runs["gpu"][1].decode_step(runs["gpu"][0], tok.to(device),
                                                           caches["gpu"], cfg)
        # the state handoff on the card: the prompt and the tokens the decode
        # consumed, prefilled, against the last decode step's logits
        p, mod = runs["gpu"][0], runs["gpu"][1]
        ctx = torch.cat([prompt, torch.stack(fed, dim=1)], dim=1).to(device)
        if arch == "whisper-tiny":
            forced, _ = mod.prefill(p, frames.to(device), ctx, cfg, ctx.shape[1])
        else:
            forced, _ = mod.prefill(p, ctx, cfg, ctx.shape[1])
        handoff = float((forced - lg).abs().max() / lg.abs().max())
        row.update(decode_steps=FG_DECODE, logits_max_abs_diff=diff, logits_max=scale,
                   handoff_max_diff_over_max=handoff)
        check(diff <= FG_LOGIT_TOL * scale,
              f"{arch}: card and CPU logits within {FG_LOGIT_TOL} of the largest: {row}")
        check(handoff <= FG_HANDOFF_TOL,
              f"{arch}: on the card the prefill of the consumed tokens equals the decode "
              f"within {FG_HANDOFF_TOL} of the largest logit: {row}")
        out[arch] = row
        del cpu, gpu, runs, caches
    return out


def family_phases(torch, np, device):
    """Phases 19-22; returns each path's kernel launches and, per path, the
    ``flash_attention`` rows at the shapes its prefills launched, each with
    its launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    # phases 19-21: the SSM, hybrid and encoder-decoder families at full width
    t_fam = time.perf_counter()
    fam_launches, fam_flash = {}, {}
    for phase, arch, cell in ((19, "mamba2-130m", "lm-mamba2"), (20, "zamba2-1.2b", "lm-zamba2"),
                              (21, "whisper-tiny", "lm-whisper")):
        tag = f"phase{phase} {cell}"
        emit(f"clock {tag}", elapsed_s=time.perf_counter() - t_fam)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        ftr = train_family(torch, np, device, arch, tag)
        torch.cuda.synchronize()
        fam_launches[f"{cell} train"] = ops.launch_counts()
        emit(f"{tag} train", **ftr)
        emit(f"{tag} train launches", **fam_launches[f"{cell} train"])
        check_train(np, ftr)
        check(not any(fam_launches[f"{cell} train"].values()),
              f"{arch}: the train step launches no kernel: {fam_launches[f'{cell} train']}")
        free_device(torch)

        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        tally, undo = flash_tally()
        try:
            fdec = decode_family(torch, np, device, arch)
        finally:
            undo()
        torch.cuda.synchronize()
        fam_launches[cell] = ops.launch_counts()
        emit(f"{tag} decode", **{k: v for k, v in fdec.items() if k != "teacher_forcing"},
             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        emit(f"{tag} teacher-forcing", **fdec["teacher_forcing"])
        emit(f"{tag} launches", **fam_launches[cell])
        check_family_decode(arch, fdec)
        cfg_f = get_config(arch)
        want_flash = {"mamba2-130m": 0, "zamba2-1.2b": cfg_f.attn_invocations,
                      "whisper-tiny": cfg_f.encoder_layers}[arch]
        # the prefill, then the teacher-forcing prefill (whisper's decoder adds
        # its causal and cross attention per layer)
        forced_flash = want_flash + (2 * cfg_f.num_layers if arch == "whisper-tiny" else 0)
        check(fdec["prefill_flash_launches"] == want_flash
              and fam_launches[cell]["flash_attention"] == want_flash + forced_flash
              and not any(v for k, v in fam_launches[cell].items() if k != "flash_attention"),
              f"{arch}: the prefill launches flash_attention {want_flash} times, the teacher "
              f"forcing {forced_flash}, nothing else: {fdec['prefill_flash_launches']} "
              f"{fam_launches[cell]}")
        check(sum(tally.values()) == fam_launches[cell]["flash_attention"],
              f"{arch}: the launches by shape add up to the path's: {tally}")
        free_device(torch)

        if arch == "mamba2-130m":  # the long_500k cell
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            lg = mamba_long(torch, np, device)
            torch.cuda.synchronize()
            fam_launches["lm-mamba2 long"] = ops.launch_counts()
            for name in ("short_before", "short_again", "short", "long", "short_freed",
                         "long_freed", "short_profiled"):
                emit(f"{tag} long_500k {name}", **lg[name])
            emit(f"{tag} long_500k", **{k: v for k, v in lg.items() if not isinstance(v, dict)},
                 **fam_launches["lm-mamba2 long"])
            check_long(lg)
            check(not any(fam_launches["lm-mamba2 long"].values()),
                  f"the SSM path launches no kernel: {fam_launches['lm-mamba2 long']}")
            free_device(torch)
        # flash_attention at every shape the prefills launched it with: zamba2's
        # windowed prompt and teacher-forced context; whisper's encoder, its
        # decoder's causal self-attention and its cross-attention
        fam_flash[cell] = tally_rows(torch, device, tally)
        for row, n in fam_flash[cell]:
            emit(f"{tag} flash_attention {row['shape']}", launches=n, **{
                k: (v.replace(" ", "_") if isinstance(v, str) else v) for k, v in row.items()})
        free_device(torch)

    # phase 22, families-gpu-vs-cpu: each family card against CPU, float32
    emit("clock phase22", elapsed_s=time.perf_counter() - t_fam)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    fg = families_gpu_vs_cpu(torch, np, device)
    torch.cuda.synchronize()
    fam_launches["families-gpu-vs-cpu"] = ops.launch_counts()
    for arch, row in fg.items():
        emit(f"phase22 families-gpu-vs-cpu {arch}", **row)
    emit("phase22 launches", **fam_launches["families-gpu-vs-cpu"])
    free_device(torch)
    emit("phases19-22", wall_s=time.perf_counter() - t_fam)
    return fam_launches, fam_flash


# ------------------------------------------------------------------ phase 23
def sharded_sweep(torch, np):
    """Phase 23: sweep-64k's fleet split over the card and the CPU
    (``devices=["cuda:0", "cpu"]``: 8 machines a slice) and on the card
    alone (``["cuda:0"]``), with exact counts (``sample_period`` 1; 4 KiB
    pages and 40 us epochs, so that exact counts stay inside the heat bins
    and pages move): every record and phase equal between the two, the
    machine-epochs/s of each, and each slice's seconds on the dispatch
    thread (its tick, then its telemetry copy) as a share of the wall."""
    from repro_torch.core.scenario import ScenarioSweep, run_sweep
    from repro_torch.core.simulator import OPTANE
    from repro_torch.kernels import ops
    from repro_torch.launch.families import sweep_points, sweep_scenario

    sc = sweep_scenario(FL_PAGES, FL_EPOCHS)
    points = sweep_points(FL_MACHINES, FL_BUDGET)
    out, runs = {}, {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for tag, devs in (("card", ["cuda:0"]), ("card_cpu", ["cuda:0", "cpu"])):
        seen = {}
        t0 = time.perf_counter()
        res = run_sweep(
            ScenarioSweep(scenario=sc, points=points), num_pages=FL_PAGES, fast_capacity=FL_FAST,
            migration_budget=FL_BUDGET, max_tenants=FL_TENANTS, sample_period=1,
            epoch_seconds=4e-5, machine=dataclasses.replace(OPTANE, page_bytes=4096),
            policy_chunk=FL_CHUNK, devices=devs, on_fleet=lambda f: seen.setdefault("fleet", f))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fleet = seen["fleet"]
        check([d.type for d in fleet.devices] == [torch.device(d).type for d in devs]
              and res.devices == len(devs), f"{tag}: the fleet ran over {devs}: {fleet.devices}")
        check(all(len(r.history) == FL_EPOCHS for r in res.results.values()),
              f"{tag}: {FL_EPOCHS} records a machine")
        runs[tag] = res
        out.update({f"{tag}_wall_s": wall,
                    f"{tag}_machine_epochs_per_s": FL_MACHINES * FL_EPOCHS / wall,
                    f"{tag}_fleet_epoch_ms": wall / FL_EPOCHS * 1e3})
        for i, d in enumerate(fleet.devices):
            sec = fleet.slice_seconds[i]
            out[f"{tag}_slice{i}_{d.type}_machines"] = fleet.num_padded // fleet.num_shards
            out[f"{tag}_slice{i}_{d.type}_ms_per_epoch"] = sec / FL_EPOCHS * 1e3
            out[f"{tag}_slice{i}_{d.type}_share"] = sec / wall
    launches = ops.launch_counts()
    card, mixed = runs["card"].results, runs["card_cpu"].results
    hist = sum(text_of(card[p.name].history) == text_of(mixed[p.name].history) for p in points)
    phases = sum(text_of(card[p.name].phases) == text_of(mixed[p.name].phases) for p in points)
    moved = min(sum(r.migrated_pages for r in res.history) for res in card.values())
    out.update(histories_equal=hist, phases_equal=phases, min_migrated=moved,
               mixed_over_card_wall=out["card_cpu_wall_s"] / out["card_wall_s"])
    check(hist == FL_MACHINES and phases == FL_MACHINES,
          f"every machine's records and phases equal split over the card and the CPU and on "
          f"the card alone: {hist}, {phases}")
    check(moved > 0, f"pages move on every machine: {moved}")
    check(not any(launches.values()), f"the fleet path launches no kernel: {launches}")
    return out, launches


# ------------------------------------------------------------------ phase 24
# the cost count: phase 16's own step (qwen2.5-3b at full width and depth,
# batch 0 of its 8 x 4,096 tokens in 4 microbatches) counted on the card and
# priced by compute_terms against the step time phase 16 measured; then the
# same model cut to CC_LAYERS layers, a CC_TRAIN (rows, tokens) train step
# and the lm-decode prefill's 8 x 1,024, counted on the card and on the CPU
# (small: the CPU runs the same calls), FLOPs and kernel bytes equal; then
# the prefill at full depth on the card, counted against flash_tally. The
# counted pass also follows the live bytes (analysis.memory), held against
# the card's caching allocator over the same call: its max_memory_allocated
# less memory_allocated at the start, after reset_peak_memory_stats. The
# full-depth and 2-layer step and prefill read within MEM_SLACK bytes of the
# allocator (on an H100 80GB HBM3 at 700 W the gaps were 0 to 3.5 MiB, blocks
# no dispatch mode sees; one layer's saved input of the full-depth step is
# 32 MiB); the 2-layer step and prefill reach one peak on the card, the CPU
# and fake tensors of each; each launched kernel alone equals the allocator
# (kernel_memory)
CC_LAYERS, CC_TRAIN, CC_TOP = 2, (1, 256), 15
MEM_SLACK = 16 << 20


def allocator_peak(torch, fn):
    """(``fn()``, the bytes the card's caching allocator gained at its
    highest while it ran)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - start


def tracked(torch, device, fn, *args):
    """(ModuleCost, MemoryAnalysis, the allocator's bytes) of one call
    ``fn(*args)``, counted and followed on ``device`` in one pass."""
    from repro_torch.analysis import memory
    from repro_torch.analysis.hlo_cost import CostCounter

    def run():
        with CostCounter(device=device) as counter:
            out = fn(*args)
        return counter.cost, memory.analysis(args, out, counter.live)

    (cost, mem), alloc = allocator_peak(torch, run)
    return cost, mem, alloc


def count_on(torch, device, fn, *args):
    """(ModuleCost, contributions, MemoryAnalysis, the allocator's bytes) of
    ``fn(*args)``: ``tracked``, then ``attribution.attribute``, one call
    each."""
    from repro_torch.analysis import attribution

    cost, mem, alloc = tracked(torch, device, fn, *args)
    rows = attribution.attribute(fn, *args)
    return cost, rows, mem, alloc


def memory_row(tag: str, mem, alloc) -> dict:
    return {f"{tag}_argument_bytes": mem.argument_bytes, f"{tag}_temp_bytes": mem.temp_bytes,
            f"{tag}_peak_bytes": mem.peak_bytes, f"{tag}_peak_gib": mem.peak_bytes / 2**30,
            f"{tag}_allocator_bytes": alloc, f"{tag}_gap_bytes": mem.temp_bytes - alloc}


def check_near_allocator(tag: str, mem, alloc) -> None:
    check(abs(mem.temp_bytes - alloc) <= MEM_SLACK,
          f"{tag}: the tracker's peak above the arguments ({mem.temp_bytes}) within "
          f"{MEM_SLACK} bytes of the allocator's ({alloc})")


def count_step(torch, np, device, step_ms: float):
    """Phase 24's first part: phase 16's step counted on the card,
    ``roofline.compute_terms`` of the count against ``step_ms`` (phase
    16's mean), the top contributions by bytes, and the live bytes against
    the allocator's."""
    from repro_torch.analysis import roofline
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.train import to_device
    from repro_torch.training import train_state as ts
    from repro_torch.training.optimizer import AdamWConfig

    cfg = get_config(TR_ARCH)
    state = ts.init_train_state(cfg, SEED, device=device)
    step = ts.make_train_step(cfg, AdamWConfig(**TR_OPT), remat="block", microbatch=TR_MICRO)
    batch = to_device(SyntheticTokens(DataConfig(cfg.vocab_size, TR_SEQ, TR_BATCH, seed=17))
                      .batch_at(0), device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cost, rows, mem, alloc = count_on(torch, device, step, state, batch)
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t0
    del state, step, batch
    check_near_allocator("the full-depth step", mem, alloc)
    check(sum(r.flops for r in rows) == cost.flops,
          "the step's contributions add up to its count's FLOPs")
    check(not cost.kernel_calls, f"the train step calls no kernel: {dict(cost.kernel_calls)}")
    shape = ShapeConfig(f"train_{TR_SEQ}", TR_SEQ, TR_BATCH, "train")
    terms = roofline.compute_terms(cfg, shape, 1, cost.flops, cost.bytes, cost.coll_total)
    check(0.5 < terms.useful_ratio < 1.0,
          f"the counted FLOPs exceed the model's by remat's forward and the loss's "
          f"recompute at most: useful ratio {terms.useful_ratio}")
    step_s = step_ms / 1e3
    out = dict(step_count_s=count_s, step_flops=cost.flops, step_bytes=cost.bytes,
               step_coll_bytes=cost.coll_total, step_rows=len(rows), step_ms=step_ms,
               compute_ms=terms.compute_s * 1e3, memory_ms=terms.memory_s * 1e3,
               collective_ms=terms.collective_s * 1e3, dominant=terms.dominant,
               model_flops=terms.model_flops, useful_ratio=terms.useful_ratio,
               model_flops_share=terms.model_flops / step_s / roofline.PEAK_FLOPS,
               counted_flops_share=cost.flops / step_s / roofline.PEAK_FLOPS,
               bound_over_step=terms.step_time_s / step_s, **memory_row("step", mem, alloc))
    return out, sorted(rows, key=lambda r: -r.bytes)[:CC_TOP]


def cost_count(torch, np, device, step_ms: float):
    """Phase 24: ``count_step``; then ``count_on`` of a train step and a
    prefill cut to CC_LAYERS layers on the card and on the CPU, FLOPs and
    the kernels' bytes equal, and their peaks on fake tensors of each
    device, every peak equal; the counter's ``flash_attention`` calls
    against the launches (``flash_tally``) at full depth, and its live
    bytes against the allocator's."""
    from repro_torch.analysis import roofline
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.model import get_model
    from repro_torch.training import train_state as ts
    from repro_torch.training.optimizer import AdamWConfig

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.memory import memory_analysis

    out, top = count_step(torch, np, device, step_ms)
    free_device(torch)
    full = get_config(TR_ARCH)
    cfg = dataclasses.replace(full, num_layers=CC_LAYERS)
    B, S = CC_TRAIN
    cpu = torch.device("cpu")

    def small_train(dev):
        state = ts.init_train_state(cfg, SEED, device=dev)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator(
            device=dev).manual_seed(SEED), device=dev)
        return (ts.make_train_step(cfg, AdamWConfig(**TR_OPT), remat="block"), state,
                {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)})

    def small_prefill(dev):
        params = get_model(cfg).init(seed=SEED, device=dev)
        prompts = torch.randint(0, cfg.vocab_size, (LD_BATCH, LD_PROMPT),
                                generator=torch.Generator(device=dev).manual_seed(SEED + 1),
                                device=dev)
        return lambda p, t: transformer.prefill(p, t, cfg, LD_MAX), params, prompts

    train, pre = {}, {}
    for tag, dev in (("cuda", device), ("cpu", cpu)):
        fn, *args = small_train(dev)
        t0 = time.perf_counter()
        train[tag] = count_on(torch, dev, fn, *args)
        out[f"small_train_count_{tag}_s"] = time.perf_counter() - t0
        del fn, args
        fn, *args = small_prefill(dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        pre[tag] = count_on(torch, dev, fn, *args)
        torch.cuda.synchronize()
        out[f"prefill_count_{tag}_s"] = time.perf_counter() - t0
        out[f"prefill_{tag}_launches"] = ops.launch_counts()["flash_attention"]
        del fn, args
        free_device(torch)
    # the same calls on fake tensors of each device: the peaks alone
    fake_peaks = {}
    for tag, dev in (("fake_cuda", device), ("fake_cpu", cpu)):
        t0 = time.perf_counter()
        with FakeTensorMode():
            for kind, make in (("train", small_train), ("prefill", small_prefill)):
                fn, *args = make(dev)
                fake_peaks[f"small_{kind}_{tag}"] = memory_analysis(fn, *args).peak_bytes
                del fn, args
        out[f"small_{tag}_s"] = time.perf_counter() - t0
    (tc, trows, tm, _), (cc, crows, cm, _) = train["cuda"], train["cpu"]
    (tp, prows, pm, _), (cp, _, cpm, _) = pre["cuda"], pre["cpu"]
    peaks = {"small_train_cuda": tm.peak_bytes, "small_train_cpu": cm.peak_bytes,
             "small_prefill_cuda": pm.peak_bytes, "small_prefill_cpu": cpm.peak_bytes,
             **fake_peaks}
    out.update({f"{k}_peak_bytes": v for k, v in peaks.items()})
    out.update(**memory_row("small_train", tm, train["cuda"][3]),
               **memory_row("small_prefill", pm, pre["cuda"][3]))
    check_near_allocator("the 2-layer step", tm, train["cuda"][3])
    check_near_allocator("the 2-layer prefill", pm, pre["cuda"][3])
    for kind in ("train", "prefill"):
        got = {k: v for k, v in peaks.items() if k.startswith(f"small_{kind}_")}
        check(len(set(got.values())) == 1,
              f"the 2-layer {kind}'s peak is one on the card, the CPU and fakes: {got}")
    for tag, c, rows in (("small_train", tc, trows), ("small_train_cpu", cc, crows),
                         ("prefill", tp, prows), ("prefill_cpu", cp, pre["cpu"][1])):
        check(sum(r.flops for r in rows) == c.flops,
              f"{tag}: the contributions add up to the count's FLOPs")
        out.update({f"{tag}_flops": c.flops, f"{tag}_bytes": c.bytes,
                    f"{tag}_kernel_flops": c.kernel_flops, f"{tag}_kernel_bytes": c.kernel_bytes,
                    f"{tag}_kernel_calls": dict(c.kernel_calls), f"{tag}_rows": len(rows)})
    check(tc.flops == cc.flops and tc.kernel_bytes == cc.kernel_bytes == 0,
          f"the train step counts the same FLOPs on the card and the CPU: {tc.flops} {cc.flops}")
    check((tp.flops, tp.kernel_flops, tp.kernel_bytes) == (cp.flops, cp.kernel_flops,
                                                           cp.kernel_bytes),
          f"the prefill counts the same FLOPs and kernel bytes on the card and the CPU: "
          f"{(tp.flops, tp.kernel_flops, tp.kernel_bytes)} {(cp.flops, cp.kernel_flops, cp.kernel_bytes)}")
    # count_on runs each call twice (module_cost's and attribute's)
    check(dict(tp.kernel_calls) == dict(cp.kernel_calls) == {"flash_attention": CC_LAYERS}
          and out["prefill_cuda_launches"] == 2 * CC_LAYERS
          and out["prefill_cpu_launches"] == 0,
          f"one flash_attention call a layer, launched on the card only: {out}")
    out["prefill_model_flops"] = roofline.model_flops_per_step(
        cfg, ShapeConfig("prefill", LD_PROMPT, LD_BATCH, "prefill"), 1)

    # the prefill at full depth on the card: the counter's calls are the launches
    params = get_model(full).init(seed=SEED, device=device)
    prompts = torch.randint(0, full.vocab_size, (LD_BATCH, LD_PROMPT), device=device,
                            generator=torch.Generator(device=device).manual_seed(SEED + 1))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tally, undo = flash_tally()
    try:
        deep, _, deep_mem, deep_alloc = count_on(
            torch, device, lambda p, t: transformer.prefill(p, t, full, LD_MAX), params, prompts)
    finally:
        undo()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    out.update(memory_row("deep_prefill", deep_mem, deep_alloc))
    check_near_allocator("the full-depth prefill", deep_mem, deep_alloc)
    out.update(deep_prefill_flops=deep.flops, deep_prefill_kernel_flops=deep.kernel_flops,
               deep_prefill_kernel_bytes=deep.kernel_bytes,
               deep_prefill_calls=deep.kernel_calls["flash_attention"],
               deep_prefill_tally=sum(tally.values()),
               deep_prefill_model_flops=roofline.model_flops_per_step(
                   full, ShapeConfig("prefill", LD_PROMPT, LD_BATCH, "prefill"), 1))
    check(deep.kernel_calls["flash_attention"] == full.num_layers
          and sum(tally.values()) == launches["flash_attention"] == 2 * full.num_layers,
          f"the counter's flash_attention calls equal the launches: {deep.kernel_calls} "
          f"{tally} {launches}")
    del params, prompts
    return out, top, launches


def kernel_memory(torch, np, device) -> dict:
    """Phase 24's kernel checks: each launched kernel alone at one shape of
    PERF.md §6's table (``flash_attention`` at the lm-decode prompt,
    ``paged_attention`` at yi-6b's decode batch, ``hot_bins`` at 531,470
    ids over 1,048,576 pages, ``tally`` at the tick's 32 (tenant, tier)
    sums over 1,048,576 pages, ``page_move`` at the 16-entry expert swap),
    the tracker's bytes (the kernel's new outputs and workspace) equal to
    the allocator's over the call; ``page_move`` cold, its workspace made
    and grown (88 MiB of scratch), then warm (nothing). Each call runs
    after ``free_device``, on fresh segments, so that no cached block is
    handed out whole (up to 1 MiB larger than asked)."""
    from repro_torch.kernels import ops, page_copy

    full, moe = get_config(TR_ARCH), get_config("qwen2-moe-a2.7b")
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 30)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).to(bf16)

    q = randn(LD_BATCH, full.num_heads, LD_PROMPT, full.d_head)
    kv = [randn(LD_BATCH, full.num_kv_heads, LD_PROMPT, full.d_head) for _ in range(2)]
    rows = moe.num_layers * moe.num_experts
    pool = torch.empty((rows, moe.d_model * moe.moe_d_ff), dtype=bf16, device=device)
    src, dst = (torch.as_tensor(x, device=device)
                for x in expert_swap_plan(np, np.random.default_rng(SEED + 31), rows))
    pages = 1 << 20
    counts = torch.randint(0, 1 << 10, (pages,), generator=g, device=device, dtype=torch.int32)
    ids = torch.randint(0, pages, (531_470,), generator=g, device=device, dtype=torch.int32)
    ids64 = torch.randint(0, 33, (pages,), generator=g, device=device)
    counts64 = counts.to(torch.int64)
    paged = paged_inputs(torch, np, bf16, device)
    calls = (
        ("flash_attention", lambda: ops.flash_attention(q, *kv)),
        ("paged_attention", lambda: ops.paged_attention(*paged)),
        ("hot_bins", lambda: ops.hot_bins(ids, counts)),
        ("tally", lambda: ops.tally(ids64, 32, counts64)),
        ("page_move_cold", lambda: ops.page_move(pool, src, dst)),
        ("page_move_warm", lambda: ops.page_move(pool, src, dst)),
    )
    page_copy._WORKSPACES.pop(pool.device, None)  # page_move_cold makes it anew
    out = {}
    for name, fn in calls:
        free_device(torch)
        _, mem, alloc = tracked(torch, device, fn)
        out[f"{name}_tracked_bytes"], out[f"{name}_allocator_bytes"] = mem.temp_bytes, alloc
        check(mem.temp_bytes == alloc,
              f"{name} alone: the tracker's {mem.temp_bytes} bytes are the allocator's {alloc}")
    ws = page_copy._WORKSPACES.get(pool.device)
    out["page_move_scratch_bytes"] = scratch = 0 if ws is None else ws.scratch.numel()
    check(out["page_move_cold_tracked_bytes"] > scratch > 0
          and out["page_move_warm_tracked_bytes"] == 0,
          f"page_move's workspace grows once, then holds: {out}")
    return out


# --------------------------------------------------------------------- main
# ------------------------------------------------------------------ phase 25
# mesh-one-card: the mesh layer on a unit mesh, an NCCL group of one rank
MO_TOKENS = ((SV_BATCH, 1), (1, LD_PROMPT))  # the decode batch, one 1,024-token row
MO_TOL = 2e-3  # tests/test_model_consistency.py:68
MO_STEP = (2, 512, 2)  # 25c: rows, tokens a row, layers (float32, full width)
MO_INT8 = 1 << 24  # 25d: elements of the all-reduced gradient


def bits_equal(torch, a, b) -> bool:
    """Bit for bit, a DTensor gathered whole first."""
    a = a.full_tensor() if hasattr(a, "full_tensor") else a
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(bits(torch, a), bits(torch, b)))


def mesh_moe(torch, np, device, mesh):
    """25a: layer 0's MoE block of phase 7's weights through
    ``moe_mlp_shardmap`` (``moe_mlp`` under ``use_partitioning``, on
    ``DTensor``s) against the mesh-less ``moe_mlp``, at the decode batch and
    at one 1,024-token row: gate ids equal (each path's routing recorded),
    outputs within MO_TOL relative, aux equal; each timed."""
    from repro_torch.launch import partitioning as part
    from repro_torch.launch.shardings import rules_for
    from repro_torch.models import moe
    from repro_torch.models.model import get_model
    from repro_torch.models.transformer import take

    cfg = get_config("qwen2-moe-a2.7b")
    params = get_model(cfg).init(seed=SEED, device=device)
    block = {k: (v.clone() if not isinstance(v, dict) else {a: b.clone() for a, b in v.items()})
             for k, v in take(params["layers"], 0)["moe"].items()}
    del params
    free_device(torch)
    rules = rules_for(cfg, mesh)
    specs = {k: (part.NamedSharding(mesh, part.spec_for(f"moe/{k}", v.shape, rules))
                 if not isinstance(v, dict) else
                 {a: part.NamedSharding(mesh, part.spec_for(f"moe/{k}/{a}", b.shape, rules))
                  for a, b in v.items()}) for k, v in block.items()}
    dblock = part.distribute(block, specs)
    gen = torch.Generator(device=device).manual_seed(SEED + 25)
    out, routes, plain_route = {}, [], moe.route

    def spy(*a, **kw):
        r = plain_route(*a, **kw)
        routes.append(r.gate_ids)
        return r

    for B, S in MO_TOKENS:
        x = torch.randn((B, S, cfg.d_model), generator=gen, device=device).to(cfg.cdtype)
        xd = part.distribute(x, part.NamedSharding(mesh, part.P("data", None, None)))

        def meshed():
            with part.use_partitioning(mesh, rules):
                return moe.moe_mlp(dblock, xd, cfg)

        moe.route = spy
        try:
            routes.clear()
            o1, a1 = meshed()
            o0, a0 = moe.moe_mlp(block, x, cfg)
            ids_equal = len(routes) == 2 and bool(torch.equal(routes[0], routes[1]))
        finally:
            moe.route = plain_route
        o1 = o1.full_tensor()
        rel = float((o1.float() - o0.float()).abs().max() / o0.float().abs().max())
        tag = f"{B}x{S}"
        out[tag] = dict(tokens=B * S, gate_ids_equal=ids_equal, out_max_rel_diff=rel,
                        bit_equal=bits_equal(torch, o1, o0),
                        aux_equal=bits_equal(torch, a1, a0),
                        shardmap_ms=time_cuda(torch, meshed, reps=3, launches=5),
                        plain_ms=time_cuda(torch, lambda: moe.moe_mlp(block, x, cfg), reps=3,
                                           launches=5))
        check(ids_equal, f"25a {tag}: both paths route to the same experts")
        check(rel <= MO_TOL, f"25a {tag}: outputs within {MO_TOL} relative ({rel})")
        check(out[tag]["aux_equal"], f"25a {tag}: aux losses equal")
    del block, dblock
    return out


def mesh_prefill(torch, np, device, mesh, ld_logits):
    """25b: phase 17's prefill (qwen2.5-3b, full width and depth, 8 x 1,024)
    with the parameters distributed by ``params_sharding`` on the unit mesh,
    under ``use_partitioning``: logits and cache bit-equal to the mesh-less
    prefill's and to phase 17's logits; flash_attention launched once a
    layer, on the local shards."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.launch import partitioning as part
    from repro_torch.launch.shardings import params_sharding, rules_for
    from repro_torch.models.model import get_model

    cfg = get_config(TR_ARCH)
    api = get_model(cfg)
    params = api.init(seed=SEED, device=device)
    prompt = torch.as_tensor(SyntheticTokens(DataConfig(cfg.vocab_size, LD_PROMPT, LD_BATCH,
                                                        seed=SEED)).batch_at(0)["tokens"],
                             device=device)
    rules = rules_for(cfg, mesh)
    logits0, cache0 = api.prefill(params, prompt, LD_MAX)
    plain_ms = time_cuda(torch, lambda: api.prefill(params, prompt, LD_MAX), reps=3, launches=2)
    dparams = part.distribute(params, params_sharding(params, mesh, rules))
    del params
    dprompt = part.distribute(prompt, part.NamedSharding(
        mesh, part.logical_spec(("batch", "seq"), rules)))

    def meshed():
        with part.use_partitioning(mesh, rules):
            return api.prefill(dparams, dprompt, LD_MAX)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    logits1, cache1 = meshed()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    out = dict(logits_bit_equal=bits_equal(torch, logits1, logits0),
               cache_bit_equal=bits_equal(torch, cache1.k, cache0.k)
               and bits_equal(torch, cache1.v, cache0.v),
               phase17_logits_bit_equal=bits_equal(torch, logits1, ld_logits.to(device)),
               logits_placements=",".join(str(p) for p in logits1.placements),
               flash_launches=launches["flash_attention"],
               mesh_ms=time_cuda(torch, meshed, reps=3, launches=2), plain_ms=plain_ms)
    check(out["logits_bit_equal"] and out["cache_bit_equal"],
          f"25b: the meshed prefill's logits and cache bit-equal to the mesh-less one: {out}")
    check(out["phase17_logits_bit_equal"], "25b: logits bit-equal to phase 17's prefill")
    check(launches["flash_attention"] == cfg.num_layers
          and not any(v for k, v in launches.items() if k != "flash_attention"),
          f"25b: flash_attention once a layer, nothing else: {launches}")
    del dparams, logits1, cache1, logits0, cache0
    return out, launches


def mesh_step(torch, np, device, mesh):
    """25c: a float32 train step at full width cut to 2 layers on the unit
    mesh (state distributed by ``train_state_sharding``) against the
    mesh-less step, deterministic algorithms on: loss and every parameter
    leaf bit-equal (else the largest difference is printed)."""
    from repro_torch.launch import partitioning as part
    from repro_torch.launch.shardings import rules_for, train_state_sharding
    from repro_torch.training.optimizer import AdamWConfig, named_leaves
    from repro_torch.training.train_state import init_train_state, make_train_step

    B, S, layers = MO_STEP
    cfg = dataclasses.replace(get_config(TR_ARCH), num_layers=layers, param_dtype="float32",
                              compute_dtype="float32")
    rules = rules_for(cfg, mesh)
    step = make_train_step(cfg, AdamWConfig(**TR_OPT), remat="block")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device=device,
                           generator=torch.Generator(device=device).manual_seed(SEED))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    torch.use_deterministic_algorithms(True)
    try:
        plain = init_train_state(cfg, SEED, device=device)
        plain, m0 = step(plain, batch)
        meshed = init_train_state(cfg, SEED, device=device)
        meshed = part.distribute(meshed, train_state_sharding(meshed, mesh, rules))
        with part.use_partitioning(mesh, rules):
            t0 = time.perf_counter()
            meshed, m1 = step(meshed, batch)
            torch.cuda.synchronize()
            mesh_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    diffs = {"/".join(path): float((a.full_tensor() - b).abs().max())
             for (path, a), (_, b) in zip(named_leaves(meshed.params), named_leaves(plain.params))}
    worst = max(diffs, key=diffs.get)
    out = dict(rows=B, tokens=S, layers=layers, loss=float(m0["loss"]),
               loss_bit_equal=bits_equal(torch, m1["loss"], m0["loss"]),
               params_bit_equal=all(bits_equal(torch, a, b) for (_, a), (_, b) in zip(
                   named_leaves(meshed.params), named_leaves(plain.params))),
               max_param_diff=diffs[worst], max_param_diff_leaf=worst, mesh_step_s=mesh_s)
    check(out["loss_bit_equal"] and out["params_bit_equal"],
          f"25c: the unit-mesh step bit-equal to the mesh-less one: {out}")
    del plain, meshed
    return out


def mesh_int8(torch, np, device, mesh):
    """25d: ``shardmap_int8_psum`` over the one-rank "data" group against the
    reference's formula (each rank quantised with its own scale, the codes
    summed in int32, times the largest scale, over n), which at one rank is
    the same: bit-equal; timed."""
    from repro_torch.training.grad_compression import _quant, shardmap_int8_psum

    g = torch.randn((MO_INT8,), generator=torch.Generator(device=device).manual_seed(SEED),
                    device=device)
    reduce = shardmap_int8_psum(mesh, ("data",))
    y = reduce(g)
    q, scale = _quant(g)
    ref = q.to(torch.int32).float() * scale / 1  # psum and pmax of one rank, n = 1
    out = dict(elements=MO_INT8, bit_equal=bits_equal(torch, y, ref),
               ms=time_cuda(torch, lambda: reduce(g), reps=3, launches=5))
    check(out["bit_equal"], "25d: the one-rank int8 all-reduce is the reference's formula")
    return out


def mesh_one_card(torch, np, device, ld_logits):
    """Phase 25: an NCCL group of one rank and the (1, 1) mesh; 25a-25d."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import build_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = build_mesh((1, 1), ("data", "model"), device_type="cuda")
        moe_out = mesh_moe(torch, np, device, mesh)
        free_device(torch)
        pre, launches = mesh_prefill(torch, np, device, mesh, ld_logits)
        free_device(torch)
        step = mesh_step(torch, np, device, mesh)
        free_device(torch)
        i8 = mesh_int8(torch, np, device, mesh)
    finally:
        dist.destroy_process_group()
    return moe_out, pre, launches, step, i8


# ------------------------------------------------------------------ phase 26
# dryrun-cells: the four cells of tests/test_dryrun_small.py and one
# production cell, each counted by ``python -m repro_torch.launch.dryrun`` on
# fake cuda tensors in its own process (all started together)
DR_CELLS = (("qwen2.5-3b", "train_4k", ("--test-mesh",)),
            ("qwen2-moe-a2.7b", "decode_32k", ("--test-mesh",)),
            ("mamba2-130m", "long_500k", ("--test-mesh",)),
            ("yi-6b", "train_4k", ("--test-mesh", "--multi-pod")),
            ("qwen2.5-3b", "train_4k", ()))
DR_RATIO = (1.0, 1.5)
DR_TIMEOUT = 600


def start_dryrun_cells(out_dir: str):
    """Start every DR_CELLS cell's process; returns them with their logs."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, extra in DR_CELLS:
        log = tempfile.TemporaryFile(mode="w+")
        procs.append((arch, shape, extra, log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             shape, "--out-dir", out_dir, *extra], env=env, cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT)))
    return procs


def finish_dryrun_cells(procs, out_dir: str, step_flops: float, step_rows: int):
    """Phase 26: wait for the cells and read their JSON. Gates: every cell
    counted, FLOPs > 0, a dominant term and its live bytes followed
    (integer temp and peak bytes); the test-mesh qwen2.5-3b train
    cell's FLOPs a device x 16 within DR_RATIO of phase 24's unsharded step
    scaled to the cell's 256 rows."""
    rows = []
    try:
        for arch, shape, extra, log, p in procs:
            rc = p.wait(timeout=DR_TIMEOUT)
            log.seek(0)
            text = log.read()
            check(rc == 0 and "1/1 cells counted" in text,
                  f"26: the dry-run of {arch} {shape} {extra} counted: {text[-2000:]}")
            sub = "multipod" if "--multi-pod" in extra else (
                "testmesh" if "--test-mesh" in extra else "singlepod")
            with open(os.path.join(out_dir, sub, f"{arch}__{shape}.json")) as f:
                rows.append(json.load(f))
    finally:
        for *_, log, p in procs:
            p.kill()
            log.close()
    for r in rows:
        check(r["flops_per_device"] > 0 and r["roofline"]["dominant"] in
              ("compute", "memory", "collective"), f"26: {r['arch']} {r['shape']} {r['mesh']}")
        mem = r["memory"]
        check(isinstance(mem["peak_bytes"], int) and mem["temp_bytes"] == mem["peak_bytes"]
              - mem["argument_bytes"] >= 0,
              f"26: {r['arch']} {r['shape']} {r['mesh']} followed its live bytes: {mem}")
    cell = next(r for r in rows if (r["arch"], r["shape"], r["mesh"]) == ("qwen2.5-3b",
                                                                          "train_4k", [4, 4]))
    whole = step_flops * get_shape("train_4k").global_batch / step_rows
    ratio = cell["flops_per_device"] * cell["n_chips"] / whole
    check(DR_RATIO[0] <= ratio <= DR_RATIO[1],
          f"26: the test-mesh cell's FLOPs x 16 within {DR_RATIO} of the unsharded step: {ratio}")
    return rows, dict(unsharded_flops=whole, ratio=ratio)


def shape_entry(k: dict, path: str, launches) -> dict:
    """One measured shape of a kernel for the ``kernels`` line."""
    keys = ("shape", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms", "classes_a_b_s")
    return {"path": path, "launches": launches, **{x: k[x] for x in keys if x in k}}



def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs on the GPU",
              file=sys.stderr)
        return 2
    # a vmap op without a batching rule falls back to a loop over the
    # machines and warns: on this path that is an error (every thread)
    warnings.filterwarnings("error", message=BATCHING_RULE)
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    t_main = time.perf_counter()
    t0 = time.perf_counter()
    libs = _build.build()
    emit("phase1", build_s=round(time.perf_counter() - t0, 3),
         torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0).replace(" ", "_"))
    for src, name, *args in PTXAS_KERNELS:
        log = libs[src].with_suffix(".log")
        found = ptxas_report(log.read_text(errors="replace")) if log.exists() else {}
        tid = template_id(name, *args)
        lines = [line for fn, line in found.items() if tid in fn]
        full = f"{name}<{', '.join(map(str, args))}>" if args else name
        check(len(lines) == 1, f"ptxas reports {full} once in {log}")
        print(f"phase1 ptxas {full}: {lines[0]}", flush=True)
    device = torch.device("cuda")

    from repro_torch.configs import get_config
    from repro_torch.models.model import get_model

    moe_cfg = get_config("qwen2-moe-a2.7b")
    kern = kernel_checks(torch, np, device)
    kern.update(tally_checks(torch, np, device))
    free_device(torch)
    page_move_widths(torch, np, device, "yi-6b")
    moves = page_move_widths(torch, np, device, "qwen2-moe-a2.7b")
    moves["expert5.5m"] = page_move_experts(torch, np, device, moe_cfg)
    attn = attention_checks(torch, np, device)
    attn.update(attention_checks(torch, np, device, nh=moe_cfg.num_heads,
                                 nkv=moe_cfg.num_kv_heads, dtypes=("bfloat16",),
                                 tag=" qwen2moe"))

    torch.cuda.reset_peak_memory_stats()
    res = run_slice(torch, np, device)
    emit("phase3", **{k: v for k, v in res.items() if k not in ("queue", "launches")},
         peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    emit("phase3 queue", **res["queue"])
    emit("phase3 launches", **res["launches"])

    ints_equal, ulp, counters = gpu_vs_cpu(torch, np)
    emit("phase4", pages=CHECK_PAGES, integer_leaves_equal=ints_equal, a_miss_max_ulp=ulp,
         **counters)
    check(ints_equal, "GPU and CPU runs bit-equal on integer state and page bytes")
    check(ulp <= 2, "FMMR within 2 ulp between GPU and CPU")

    free_device(torch)
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("yi-6b")
    t0 = time.perf_counter()
    params = get_model(cfg).init(seed=SEED, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sv, tenants, sv_launches, sv_queue = run_serving(torch, np, device, cfg, params,
                                                     warmup=SV_WARMUP, steps=SV_STEPS)
    emit("phase5 serve-yi6b", init_s=init_s, **sv)
    for name, t in tenants.items():
        emit(f"phase5 tenant {name}", **t)
    emit("phase5 queue", **sv_queue)
    emit("phase5 launches", **sv_launches)
    del params
    free_device(torch)

    for arch, tag in (("yi-6b", ""), ("qwen2-moe-a2.7b", " qwen2-moe")):
        rel, cmp = serving_gpu_vs_cpu(torch, np, arch)
        emit(f"phase6{tag}", layers=2, logits_max_rel_diff=rel, **cmp)
        check(rel <= 1e-3, f"{arch}: GPU and CPU logits within 1e-3 relative ({rel})")
        check(cmp["tokens_equal"] and cmp["counts_equal"],
              f"{arch}: greedy tokens and access counts equal")
        check(cmp["state_equal"] and cmp["slot_of_equal"] and cmp["queue_equal"],
              f"{arch}: manager state and slot map equal between GPU and CPU")
    free_device(torch)

    # phase 7, serve-qwen2moe: qwen2-moe-a2.7b at full width and depth
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = get_model(moe_cfg).init(seed=SEED, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gib = sum(t.numel() * t.element_size() for t in leaves(params)) / 2**30
    sv7, tenants7, sv7_launches, sv7_queue = run_serving(torch, np, device, moe_cfg, params,
                                                         warmup=SV7_WARMUP, steps=SV7_STEPS)
    emit("phase7 serve-qwen2moe", init_s=init_s, weights_gib=weights_gib, **sv7)
    for name, t in tenants7.items():
        emit(f"phase7 tenant {name}", **t)
    emit("phase7 queue", **sv7_queue)
    emit("phase7 launches", **sv7_launches)
    emit("phase7 moe-split", layers=moe_cfg.num_layers,
         **moe_split(torch, moe_cfg, params, device, SV_BATCH))
    free_device(torch)

    # phase 8, coloc-legs: the colocation benchmark's three placements
    torch.cuda.reset_peak_memory_stats()
    legs, claim, cl_launches = coloc_legs(torch, np, device, moe_cfg, params)
    for mode, leg in legs.items():
        emit(f"phase8 coloc-legs {mode}", **leg)
    emit("phase8 claim (as found, not gated)", **claim)
    emit("phase8 launches", **cl_launches,
         peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    check(all(cl_launches[k] > 0 for k in ("paged_attention", "flash_attention", "page_move")),
          f"the legs launched paged_attention, flash_attention and page_move: {cl_launches}")
    free_device(torch)

    # phase 9, expert-tiering: the expert weights tiered by routing skew
    torch.cuda.reset_peak_memory_stats()
    et = expert_tiering(torch, np, device, moe_cfg, params)
    emit("phase9 expert-tiering", **et, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del params
    free_device(torch)

    emit("clock after phase 9", elapsed_s=time.perf_counter() - t_main)
    # phase 10, scenario-1M: the paper's scenario engine on the card's manager
    torch.cuda.reset_peak_memory_stats()
    sc10, sc10_queue, sc10_launches = scenario_1m(torch, np, device)
    emit("phase10 scenario-1M", **sc10, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    emit("phase10 queue", **sc10_queue)
    emit("phase10 launches", **sc10_launches)
    free_device(torch)

    # phase 11, scenario-gpu-vs-cpu: the Fig. 4 timeline on the card and the CPU
    sc11, policies, sc11_launches = scenario_gpu_vs_cpu(torch, np)
    emit("phase11 scenario-gpu-vs-cpu", **{k: v for k, v in sc11.items() if k != "queue"})
    emit("phase11 queue", **sc11["queue"])
    emit("phase11 launches", **sc11_launches)
    for name, row in policies.items():
        emit(f"phase11 steady phase {name} (as found, not gated)", **row)
    free_device(torch)

    # phase 12, sweep-64k: the fleet sweep at BENCH_fleet.json's size
    sc12, sc12_launches = sweep_64k(torch, np)
    emit("phase12 sweep-64k", **sc12)
    emit("phase12 launches", **sc12_launches)
    free_device(torch)

    # phase 13, fleet-gpu-vs-cpu: golden trace, the parity sweep, machines axis
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    sc13 = fleet_gpu_vs_cpu(torch, np)
    torch.cuda.synchronize()
    sc13_launches = ops.launch_counts()
    emit("phase13 fleet-gpu-vs-cpu", **sc13)
    emit("phase13 launches", **sc13_launches)
    check(not any(sc13_launches.values()), f"the fleet path launches no kernel: {sc13_launches}")
    free_device(torch)

    # phase 14, autotune-64k: the tuner's search, the profile replays, online
    at_search, at_winner, at_replays, at_online, at_retunes, at_launches = autotune_64k(torch, np)
    emit("phase14 autotune-64k search", **at_search)
    emit("phase14 winner", **at_winner)
    for name, row in at_replays.items():
        emit(f"phase14 replay {name} (as found, not gated)", **row)
    emit("phase14 online", **at_online)
    for r in at_retunes:
        emit("phase14 retune", **r)
    emit("phase14 launches", **at_launches)
    free_device(torch)

    # phase 15, tuner-gpu-vs-cpu: the exact search on the card and the CPU
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tg = tuner_gpu_vs_cpu(torch, np)
    torch.cuda.synchronize()
    tg_launches = ops.launch_counts()
    emit("phase15 tuner-gpu-vs-cpu", **tg)
    emit("phase15 launches", **tg_launches)
    check(not any(tg_launches.values()), f"the tuner's path launches no kernel: {tg_launches}")
    free_device(torch)

    emit("clock after phase 15", elapsed_s=time.perf_counter() - t_main)
    # phase 16, train-qwen25-3b: the trainer at full width and depth
    t_lm = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    tr = train_qwen25(torch, np, device)
    torch.cuda.synchronize()
    tr_launches = ops.launch_counts()
    emit("phase16 train-qwen25-3b", **tr)
    emit("phase16 launches", **tr_launches)
    check_train(np, tr)
    check(not any(tr_launches.values()), f"the train step launches no kernel: {tr_launches}")
    free_device(torch)

    # phase 17, lm-decode: prefill + the contiguous-cache decode, both commits
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ld_tally, undo = flash_tally()
    try:
        ld = lm_decode(torch, np, device)
    finally:
        undo()
    torch.cuda.synchronize()
    ld_launches = ops.launch_counts()
    ld_logits = ld.pop("prefill_logits")
    for name, row in ld.items():
        emit(f"phase17 lm-decode {name}", **row)
    emit("phase17 launches", **ld_launches, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    check_decode(ld)
    n_layers = get_config(TR_ARCH).num_layers
    check(ld_launches["flash_attention"] == 2 * n_layers
          and not any(v for k, v in ld_launches.items() if k != "flash_attention"),
          f"two prefills launch flash_attention {n_layers} times each, nothing else: "
          f"{ld_launches}")
    check(sum(ld_tally.values()) == ld_launches["flash_attention"],
          f"the launches by shape add up to the path's: {ld_tally}")
    # the prompt's shape and the teacher-forced context's
    ld_flash = tally_rows(torch, device, ld_tally)
    for row, n in ld_flash:
        emit(f"phase17 flash_attention lm-decode {row['shape']}", launches=n, **{
            k: (v.replace(" ", "_") if isinstance(v, str) else v) for k, v in row.items()})
    free_device(torch)

    # phase 18, train-gpu-vs-cpu: smoke steps, checkpoint resume, the CLI
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    gc_out = train_gpu_vs_cpu(torch, np, device)
    torch.cuda.synchronize()
    gc_launches = ops.launch_counts()
    for name, row in gc_out.items():
        emit(f"phase18 train-gpu-vs-cpu {name}", **row)
    emit("phase18 launches", **gc_launches)
    check(not any(gc_launches.values()), f"the training paths launch no kernel: {gc_launches}")
    free_device(torch)
    emit("phases16-18", wall_s=time.perf_counter() - t_lm)

    # phases 19-22: the SSM, hybrid and encoder-decoder families
    fam_launches, fam_flash = family_phases(torch, np, device)
    emit("clock after phase 22", elapsed_s=time.perf_counter() - t_main)

    # phase 23, sharded-sweep: sweep-64k's fleet over the card and the CPU
    sh23, sh23_launches = sharded_sweep(torch, np)
    emit("phase23 sharded-sweep", **sh23)
    emit("phase23 launches", **sh23_launches)
    free_device(torch)

    # phase 24, cost-count: the counter on the card and the CPU
    cc24, top24, cc24_launches = cost_count(torch, np, device, tr["step_ms"])
    emit("phase24 cost-count", **{k: (str(v).replace(" ", "") if isinstance(v, dict) else v)
                                  for k, v in cc24.items()})
    for i, r in enumerate(top24):
        emit(f"phase24 top bytes {i}", bytes=r.bytes, flops=r.flops, comp=r.comp, kind=r.kind,
             rtype=r.rtype, op_name=r.op_name.replace(" ", "_"))
    emit("phase24 launches", **cc24_launches)
    free_device(torch)
    emit("phase24 kernel-memory", **kernel_memory(torch, np, device))
    free_device(torch)
    emit("clock after phase 24", elapsed_s=time.perf_counter() - t_main)

    # phase 26's cells count on the host in processes of their own, while
    # phase 25 runs on the card
    t_mesh = time.perf_counter()
    dr_dir = os.path.join(ROOT, "chiprun_out", "dryrun_torch")
    dr_procs = start_dryrun_cells(dr_dir)
    # phase 25, mesh-one-card: the mesh layer on a unit mesh
    mo, mo_pre, mo_launches, mo_step, mo_int8 = mesh_one_card(torch, np, device, ld_logits)
    for tag, row in mo.items():
        emit(f"phase25a moe-shardmap {tag}", **row)
    emit("phase25b prefill-mesh", **mo_pre)
    emit("phase25b launches", **mo_launches)
    emit("phase25c train-step-mesh", **mo_step)
    emit("phase25d int8-psum", **mo_int8)
    emit("phase25", wall_s=time.perf_counter() - t_mesh)
    free_device(torch)
    # phase 26, dryrun-cells
    dr_rows, dr_ratio = finish_dryrun_cells(dr_procs, dr_dir, cc24["step_flops"], TR_BATCH)
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    for r in dr_rows:
        emit(f"phase26 dryrun {r['arch']} {r['shape']} {'x'.join(map(str, r['mesh']))}",
             count_s=r["count_seconds"], flops_per_device=r["flops_per_device"],
             bytes_per_device=r["bytes_per_device"], collective_bytes_total=r[
                 "collective_bytes_total"], **{f"coll_{k}": v for k, v in
                                              r["collective_bytes"].items()},
             **{k: r["roofline"][k] for k in ("compute_s", "memory_s", "collective_s",
                                              "dominant", "useful_ratio")},
             **{k: r["memory"][k] for k in ("argument_bytes", "output_bytes", "temp_bytes",
                                             "peak_bytes")},
             peak_gib=r["memory"]["peak_bytes"] / 2**30, card_gib=card_bytes / 2**30,
             fits=r["memory"]["peak_bytes"] <= card_bytes)
    emit("phase26 ratio", **dr_ratio)
    emit("phases25-26", wall_s=time.perf_counter() - t_mesh)
    emit("clock after phase 26", elapsed_s=time.perf_counter() - t_main)

    sources = {
        "page_move": ("src/repro_torch/kernels/csrc/page_copy.cu",
                      "src/repro/kernels/page_copy.py:34"),
        "page_copy": ("src/repro_torch/kernels/csrc/page_copy.cu",
                      "src/repro/kernels/page_copy.py:68"),
        "hot_bins": ("src/repro_torch/kernels/csrc/hot_bins.cu",
                     "src/repro/kernels/hot_bins.py:59"),
        "tally": ("src/repro_torch/kernels/csrc/tally.cu",
                  "none (the JAX package's tick scatters in XLA)"),
    }
    rows = []
    for name, (src, replaces) in sources.items():
        k = kern["tally hist" if name == "tally" else name]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": res["launches"][name], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": "bytes", "library_ms": k["library_ms"],
            "device_ms": k["device_ms"], "library_device_ms": k["library_device_ms"],
        })
    attn_sources = {
        "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:87"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:103"),
    }
    for name, (src, replaces) in attn_sources.items():
        k = attn[f"{name} bfloat16"]  # the serving slice's dtype
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sv_launches[name], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "device_ms": k["device_ms"], "library_device_ms": k["library_device_ms"],
        })
    # the MoE slice's shapes (phases 7-9), each with its launches on its path;
    # the colocation legs' (phase 8, 4-token pages) are counted, not timed
    half7 = sv7_launches["page_move"] // 2  # K and V, then the two summaries
    by_name = {r["name"]: r for r in rows}
    by_name["page_move"]["shapes"] = [
        shape_entry(moves["kv64k"], "serve-qwen2moe K/V", half7),
        shape_entry(moves["summary8k"], "serve-qwen2moe summaries", half7),
        shape_entry(moves["expert5.5m"], "expert-tiering", et["launches_page_move"]),
        {"path": "coloc-legs", "launches": cl_launches["page_move"]},
        {"path": "scenario-1M", "launches": sc10_launches["page_move"]},
        {"path": "scenario-gpu-vs-cpu", "launches": sc11_launches["page_move"]},
    ]
    by_name["tally"]["shapes"] = [shape_entry(kern[f"tally {site}"], "kvs-gups-8m cell", None)
                                  for site in ("sums", "bins")]
    by_name["page_copy"]["shapes"] = [
        {"path": "scenario-1M", "launches": sc10_launches["page_copy"]},
        {"path": "scenario-gpu-vs-cpu", "launches": sc11_launches["page_copy"]},
    ]
    by_name["paged_attention"]["shapes"] = [
        shape_entry(attn["paged_attention bfloat16 qwen2moe"], "serve-qwen2moe",
                    sv7_launches["paged_attention"]),
        {"path": "coloc-legs", "launches": cl_launches["paged_attention"]},
    ]
    by_name["flash_attention"]["shapes"] = [
        shape_entry(attn["flash_attention bfloat16 qwen2moe"], "serve-qwen2moe S1024 and S512",
                    sv7_launches["flash_attention"]),
        shape_entry(attn["flash_attention bfloat16 qwen2moe S512"], "serve-qwen2moe S512", None),
        {"path": "coloc-legs", "launches": cl_launches["flash_attention"]},
    ]
    by_name["flash_attention"]["shapes"] += [shape_entry(r, "lm-decode", n) for r, n in ld_flash]
    for row in rows:  # the fleet and training paths (phases 12-16, 18) launch none
        row.setdefault("shapes", []).extend([
            {"path": "sweep-64k", "launches": sc12_launches[row["name"]]},
            {"path": "fleet-gpu-vs-cpu", "launches": sc13_launches[row["name"]]},
            {"path": "autotune-64k", "launches": at_launches[row["name"]]},
            {"path": "tuner-gpu-vs-cpu", "launches": tg_launches[row["name"]]},
            {"path": "train-qwen25-3b", "launches": tr_launches[row["name"]]},
            {"path": "train-gpu-vs-cpu", "launches": gc_launches[row["name"]]},
        ])
        if row["name"] != "flash_attention":
            row["shapes"].append({"path": "lm-decode", "launches": ld_launches[row["name"]]})
        # the families' paths (phases 19-22): only the prefills launch a kernel
        for path, counts in fam_launches.items():
            if row["name"] != "flash_attention" or path not in ("lm-zamba2", "lm-whisper"):
                row["shapes"].append({"path": path, "launches": counts[row["name"]]})
        row["shapes"].extend([
            {"path": "sharded-sweep", "launches": sh23_launches[row["name"]]},
            {"path": "cost-count (full-depth prefill)", "launches": cc24_launches[row["name"]]},
        ])
    by_name["flash_attention"]["shapes"] += [
        shape_entry(r, path, n) for path in ("lm-zamba2", "lm-whisper") for r, n in fam_flash[path]]
    # the unit mesh's prefill (phase 25b): phase 17's prompt shape, on local shards
    prompt_row = next(r for r, _ in ld_flash if r["shape"].startswith(
        f"q[{LD_BATCH},{get_config(TR_ARCH).num_heads},{LD_PROMPT},"))
    by_name["flash_attention"]["shapes"].append(
        shape_entry(prompt_row, "prefill-mesh", mo_launches["flash_attention"]))
    for row in rows:
        if row["name"] != "flash_attention":
            row["shapes"].append({"path": "prefill-mesh", "launches": mo_launches[row["name"]]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
