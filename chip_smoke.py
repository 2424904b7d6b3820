#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Drives the port's main paths through the entry points a user calls —
registered instructions, fused chains and the coalesced batch path, all
launching the generated Triton kernel K1; the paper's two applications
(§4.3), which launch the sorting networks K5/K6 (CUDA C++) and the
look-back scan K3 (CUDA C++); the Mamba2 SSD state scan, which launches
K4 (the affine fold, CUDA C++) — at full size (every array
≥ 4× the 50 MB L2: 2²⁶ 4-byte elements = 256 MiB); the LM server at
Kimi-K2's published widths, whose MoE router launches K7 (top-k, CUDA
C++) and K3 and whose prefill attention launches K8 (CUDA C++, wgmma and
TMA in bfloat16); and the server on Mamba2-1.3B and Hymba-1.5B, every
layer at every published width, whose prefill launches K4 once a layer
(and, for Mamba2, the scheduled decode with SLO shedding); and the
trainer (``launch.api.make_train_step``) on Mamba2-1.3B at every
published width and all 48 layers, whose forward, remat recompute and
backward launch K4 (its backward the reverse walk of the same kernel),
then MoE training at Kimi-K2's reduced config (K7 with its gradient, K3)
and the train entry point with a checkpoint and a resume. It builds
every kernel from the checkout's sources (the CUDA sources first, one
nvcc each, in parallel, with ptxas's register and shared-memory report),
holds each against its plain PyTorch version and the torch oracles on
the card, times it (CUDA events around each call while the device is
held busy, so the time is device time; and host wall time per call),
and prints one ``kernels`` JSON line and, last, the device JSON line.
Phase I serves two tenants through the scheduler, whose batches and plan
parts launch K1, and prints a ``sched`` JSON line before the kernels
line; phases H, J and K each print a ``serve`` JSON line, L a ``train``
line and M a ``train_moe`` line.
Exits non-zero, printing no result, when no CUDA device is visible or
any phase fails.

Phases (inputs from numpy with a fixed seed):
  A  c0_copy / c0_scale / c0_add / c0_triad solo at N = 2²⁶ (float32);
     then c0_add at N = 2²⁶ − 1000, the tail masked where the former
     path padded both operands by a copy
  B  fuse(c0_scale, c0_add) and fuse(c0_scale, c0_add, c0_copy) at N = 2²⁶
  C  call_batch of 16 scale→add requests, 16 distinct scalars, N = 2²² each:
     one launch of K1's batch kernel on the items where they lie (no
     item copied; one torch.profiler trace of the batch shows that kernel
     and nothing else), the launch alone timed on the items in place;
     then a ragged batch (16 items of 2²² − 1000, one of them a view at
     storage offset 1, which alone is copied)
  D  the carried c7_absmax_scale template (examples/quickstart.py) on a
     (4096, 16384) input; then its program's call_batch of 4 ragged
     (1000, 16381) items
  E  the mergesort app (examples/sort_prefix_apps.py §1): 2²⁶ int32 keys
     in one row through ops.sortnet_mergesort(v[None], max_kernel_width=
     4096) — one K5 launch (width 8), nine K6 launches (one at each
     w = 8…2048), then 14 torch.sort levels as in the reference; plus K5
     alone at widths 16, 64, 512 and 4096 in float32 and 64 in bfloat16
     (one instance per width), and K6 alone at each of the nine widths on
     that level's operands
  F  the prefix-sum app (§2 of the same example): ops.prefix_sum over one
     row of 2²⁶ float32 — one K3 launch
  G  the SSD inter-chunk state scan at Mamba2-1.3B's widths
     (src/repro/configs/mamba2_1p3b.py: headdim 64, state 128, d_inner
     4096 → 64 heads), batch 4, seq 8192 at chunk 256 → 32 chunks:
     ops.chunk_scan_state(a, states, axis=1), states (4, 32, 64, 64, 128)
     float32 — one launch of K4's state-scan entry on the states where
     they lie; K4's rows entry on the decay broadcast to state rank and
     both moved (2 × 256 MiB of copies) run beside it
  H  the LM server (repro_torch.launch.serve.generate) on Kimi-K2 1T-A32B
     (src/repro/configs/kimi_k2_1t.py) at every published width — d_model
     7168, 64 heads, 8 KV heads of 128, 384 experts top-8 of width 2048,
     vocab 163840, bf16 — with 2 of its 61 layers (2 layers of weights are
     67.9 GiB on the 80 GB card) and attn_impl="kernel" (the switch under
     which prefill launches c6); random weights from a seeded CUDA
     generator. 4 prompts of 1024 tokens, 16 greedy tokens each: K8 twice
     (prefill, one per layer), K7 and K3 2 × 16 = 32 times each (prefill and
     15 decode steps, one per layer). The router's (tokens, 384) logits
     go to K7 in place, standing for rows of 512 (no padded copy: one
     torch.profiler trace of a router top-k call holds one K7 kernel and
     no concatenation). The path's own K7 inputs (layer 0 of prefill and
     of the first decode step) and K8 inputs (layer 0 of prefill) are
     recorded and held against the plain versions and the oracles; K7 and
     K8 are also held off the path at the same shapes (K7: a tile of
     ties, bfloat16, int32, a tile of ±0.0 and NaN of either sign, rows
     of 8192 at k 8 and the full network at k 40; K8 causal at sq < sk;
     K8 in float32). The same
     request through the plain path (isa.use("interpret")) is printed
     beside it, not gated: near-tied router logits may flip an expert
  I  the multi-tenant scheduler (repro_torch.sched) with
     CostModel(hierarchy=H100), weighted fair queueing over two lanes,
     wall clock: tenant A submits 16 fuse(c0_scale, c0_add) requests of
     2²² float32 sharing one scalar (one coalesced batch: one
     k1_batch_kernel launch on the items in place); tenant B submits
     the axpby_residual and saxpby plans of ops.c0_pipeline_graph,
     partitioned under the H100 preset at 2²⁶ (two parts, two K1
     launches each). One torch.profiler trace of the run holds those
     five kernels and no copy; the recorded run replays. Printed in the
     ``sched`` line: each batch's predicted and observed ms, each plan's
     device ms against its unfused partition (one launch a node) on the
     same inputs, host µs per dispatch (wall per batch less device per
     batch) for the same mix at 2¹², and a least-squares fit of
     t = overhead_s + bytes / peak_bw to c0_copy's device time at
     2¹⁰…2¹⁸ (H100_HBM.overhead_s is assumed, 1 µs)
  J  the LM server (serve.generate) on Mamba2-1.3B
     (src/repro/configs/mamba2_1p3b.py) at every published width and all
     48 layers — d_model 2048, d_inner 4096, 64 heads of 64, state 128,
     chunk 256, vocab 50280, bf16 — random weights from a seeded CUDA
     generator; 4 prompts of 8192 tokens (each layer's state scan is G's
     (4, 32, 64, 64, 128)), 16 greedy tokens: K4 48 times in prefill and
     never in a decode step, each call held as it runs against float64
     of its own inputs (nothing stored), and the SSD chunk-output kernel
     48 times in prefill (none declined). That kernel alone at the
     benchmark cell's shape (8 × 8192 tokens: (8, 32, 256, 64 heads,
     headdim 64, state 128)) on random operands whose decays carry, held
     against its plain version within 1e-5 of max |y| (its single-term
     control outside), timed beside its byte bound and its plain version. Then serve.main with --sched
     --slo-shed --obs-tail --obs-trace at 4 × 256 tokens and a generous
     --slo-ms: its tokens equal the unscheduled server's at the same
     seed, it sheds nothing, and prints its sched, SLO and blame reports
  K  the same on Hymba-1.5B (src/repro/configs/hymba_1p5b.py), all 32
     layers at every published width — d_model 1600, 25 heads and 5 KV
     heads of 64, d_ff 5504, 64 SSM heads of 50, state 16, SWA window
     1024, vocab 32001 — 4 prompts of 2048 tokens (twice the window: the
     rolled SWA cache), 16 greedy tokens: K4 and the SSD chunk-output
     kernel 32 times each in prefill (that kernel also alone at K's
     (4, 8, 256, 64, 50, 16), as in J); the
     sliding-window attention takes the chunked path, as in the reference
     (no K8)
  L  the trainer (repro_torch.launch.api.make_train_step) on Mamba2-1.3B
     uncut — every published width, all 48 layers, bf16 params, AdamW
     with float32 moments, remat full, attn_impl chunked as the
     reference's train.py keeps it — random weights from a seeded CUDA
     generator, 3 steps of 4 × 4096 tokens from SyntheticLMData(seed):
     each step launches K4 96 times forward (48 in the forward, 48 in
     remat's recompute) and 48 times in reverse (the backward), and no
     other kernel; ms a step, tokens/s, one traced step's device time by
     kernel kind, its idle share and K4's forward and reverse device ms
     (told apart by their order in the trace); every K4 call of a step
     scans states of (4, 16, 64, 64, 128) (16 chunks of 256). Then, at
     that shape on random decays in (0, 1] (the model's own decays are 0
     in float32, so there λ = g): K4's forward entry, its reverse walk
     on the backward's operands, and c4_statescan's backward
     (ops.chunk_scan_state under autograd: the shifted decay, the
     reverse walk, da's reduction) in kernel and interpret modes; the
     forward's and the reverse walk's ``kernels`` rows at that shape
     with the step's launch counts. Last, one gradient of the loss at
     the same widths and tokens cut to 2 layers in float32 (so that the
     modes differ only in the scans' rounding), A_log and dt_bias reset
     so that a chunk's decay is spread over (0.05, 0.95) (carrying_decays):
     kernel and interpret mode against ref mode
  M  MoE training at Kimi-K2's reduced config (a full-width MoE train
     step does not fit one card: Kimi-K2's experts are 16.9 B params a
     layer; 2 layers, 8 experts top-2, capacity factor 8): one train step
     with K7 and K3 (isa kernel mode) against the same step on the
     oracles (ref mode) from the same state and batch; K7's gradient at
     H's router shape (4096, 384), k 8; then the train entry point
     (repro_torch.launch.train.main) on reduced Mamba2 for 6 steps with
     checkpoints every 3 in a temporary directory under build/, and a
     resume to 9
  N  the device mesh, its ranks processes spawned by torch.multiprocessing
     that all use the one card (NCCL refuses two ranks on one device), in
     a gloo group over a file store under build/, GLOO_SOCKET_IFNAME=lo:
     every collective stages CUDA tensors through pinned host buffers
     (distributed/collectives.py), so its time is host-staged. Each
     case's ranks run together, the cases one after another; a rank that
     raises fails the spawn. N1: make_pod_sync on a (pod 4, data 1,
     model 1) mesh over Mamba2-1.3B's whole param tree (48 layers, bf16),
     rank r's params the base plus r·1e-3. N2: one MoE layer at Kimi-K2's
     published widths (384 experts top-8, d_ff_expert 2048, bf16) on 4
     ranks of H's 4 × 1024 tokens, EP on (data 4, model 1) (96 experts a
     rank, each its own rows) then TP on (1, 4) (each expert's FFN in 4,
     the model peers on rank 0's rows); every rank draws only its shards
     (draw_leaf, as init_params(mesh=) draws: blocks seeded per leaf and
     block, the values of a world of one); the parent first runs
     _dispatch_combine with all 384 experts on one process (33.8 GB). N3: FSDP training of
     Mamba2-1.3B uncut on (data 2, model 1), 2 steps of L's 4 × 4096
     global batch (2 × 4096 a rank), after the same 2 steps on one
     process over the same row blocks (L's path with grad_accum 2); K4 held at a rank's (2, 16, 64, 64, 128) as L
     holds it. N4: Mamba2-1.3B's forward in 4 GPipe stages of 12 layers,
     8 microbatches of (1, 2048) tokens, against the same 48 layers on
     one process. N5: Scheduler(mesh=, mesh_axis="parts") on 2 ranks
     serves I's tenant A (16 fuse(c0_scale, c0_add) of 2²² float32). N6:
     train.main --model-parallel 2 on 4 ranks (2×2) for Mamba2 and
     Kimi-K2 reduced, 4 steps with checkpoints, and with
     --pod-sync-every 2; the resume of both on 2 ranks (2×1);
     serve.main --model-parallel 2 (1×2) and on 2×1, against one
     process's tokens; serve.main --sched --slo-shed on 2×1 with a
     --slo-ms of 0.5 that every decode step misses (rank 0's SLO monitor
     decides each admission and broadcasts it). N7: the dense layers
     split over ``model`` on a (data 1, model 2) mesh, each rank on its
     heads, FFN columns and vocabulary block — N7a trains Mamba2-1.3B
     uncut (48 layers, every published width, bf16, AdamW, remat full,
     SP on) for 2 steps of 2 × 4096 tokens, K4 scanning each rank's
     (2, 16, 32, 64, 128) states (96 forward and 48 reverse launches a
     step), after one process's loss on the same params and batches and
     a 2-layer float32 gradient cut of one process (the ranks take its
     params and batch); N7b serves Llama-3-8B uncut (32 layers, bf16,
     attn_impl "kernel", 8.0 GB of shards a rank) on 4 × 2048 prompts
     with 16 greedy tokens, K8 on each rank's (4, 16, 2048, 128) heads
     (32 launches a rank in prefill), after one process serves the same
     prompts and the float32 forward of the same weights gives the
     logits both are held against. Prints one ``distributed`` JSON line
     (each case's seconds split into compute and collective, bytes
     staged through host, launches, rank peaks) before the kernels
     line, whose rows gain K7 and K3 at N2's router shapes, K4 at N3's,
     N4's and N7a's, K8 at N7b's and K1 at N5's chunk
  O  O1: two shape-changing instructions defined as a user defines them
     (isa.define from the oracle, isa.bind_kernel for the template's
     launch): pairsum (out[:, j] = x[:, 2j] + x[:, 2j+1], (rows, cols/2))
     and to_bf16 (float32 → bfloat16, same shape), each launched once on
     K1 at (8192, 8192) float32 with the templates' 8×1024 tile (the
     output block 8×512 for pairsum). O2: the dry run
     (launch.dryrun.count_cell) of phase L's cell — Mamba2-1.3B uncut,
     train, 4 × 4096, a mesh of one — printed as its JSON report, and
     one real step of the same cell on the card under FlopCounterMode;
     then two plain steps timed. Prints a ``dryrun`` JSON line
  P  the four user-facing examples (examples/*.py) through their twins in
     repro_torch.examples, each main(argv) with every count set to 0 just
     before it and read just after, at the reference scripts' own sizes:
     quickstart (c7_absmax_scale validated and inside a program, two K1
     launches; the two tenants coalesced into one k1_batch_kernel
     launch), sort_prefix_apps at its default 16 MiB (2²² keys: K5 and
     nine K6 levels, K3, each a warm-up and a timed call; the plan's two
     K1 parts at 2²²), serve_decode (reduced Hymba-1.5B, 4 × 64 prompts,
     32 sampled tokens: K4 once a layer in prefill, each call held
     against float64 as it runs; run again, and once on the plain path),
     train_lm --tiny for TRAIN_LM_STEPS = 200 steps (reduced Llama-3:
     dense, chunked attention, so no kernel of K1–K8; 200 and not 20
     steps because the optimizer's warmup holds the learning rate at
     2% of its peak through step 20, where the reduced model's loss on
     the CPU went 6.6566 → 6.7326 from step 10 to 20, and 6.7160 →
     6.5789 over the first and last five logged of 200). Prints one
     ``example`` JSON line per twin: wall seconds, launches

Tolerances (fixed before any run):
  * copy, scale, add: bit-exact against the emulator and the oracle;
  * multiply-add chains (triad, scale→add…): |Δ| ≤ 4·eps_f32·(|s·x| + |b|)
    elementwise — Triton contracts a·s + b into one FMA (one rounding),
    torch eager rounds twice;
  * every call_batch item: bit-identical to its solo K1 call (ragged,
    misaligned and carried items too: the batch masks the tail a solo
    call pads with zeros);
  * I: every scheduled result bit-identical to that request's own solo
    call (A's items to fuse(...)(s, x, b), each plan's outputs to the
    plan called alone), and against ref at the multiply-add bound
    4·eps_f32·Σ|term| (A: |s·x| + |b|; axpby_residual |s·x| + |b| and
    |x| + |t·b|; saxpby |a·x| + |b·y|); the replay of the recorded wall
    run takes the same decisions (item, lane, round, batch, predicted
    time) and replays itself with placements_match true;
  * c7_absmax_scale: ≤ 2 ulp — Triton's fp32 ``/`` lowers to
    ``div.full.f32`` (≤ 2 ulp), torch divides with IEEE rounding;
  * sorts and merges (E): bit-exact against the plain network, the oracle
    and torch.sort;
  * prefix sum (F), against a float64 cumsum, each scan at the
    first-order bound of its own summation order,
    |ŷᵢ − yᵢ| ≤ eps_f32·(k_abs·Σ_{j≤i}|xⱼ| + k_ends·Σ_{e<i}|y_e| + |yᵢ|),
    e over the ends of the earlier 4096-column blocks. The plain version
    (the carried walk): k_abs = ⌈log2 bc⌉, a tree inside each block, and
    k_ends = 1, one add of the carry per block, which rounds on a partial
    sum, not on Σ|x|. K3 (the look-back scan,
    ``prefix_scan.k3_bound_constants``): k_abs = 26, at most 25 adds
    inside a tile plus one unit that absorbs the double-precision
    look-back, and k_ends = 1, the exclusive prefix rounded once from
    double near the previous tile's end. K3 against its plain version:
    |Δ| ≤ 0.05, a regression limit about 6× the largest |Δ| measured on
    an H100 at this seed with the earlier, carried K3;
  * state scan (G), against a float64 sequential recurrence:
    k4_bound_steps(i)·eps_f32·Σ_{j≤i}|bⱼ| = (i + 2)·eps_f32·Σ|bⱼ|, valid
    since 0 < a ≤ 1: K4 folds in order, bⱼ passing i − j products and
    i − j + 1 adds, each rounded once; the former Gluon kernel (a tree
    in one block of the C chunks) within max(i + 2, ⌈log2 C⌉ + 3) of the
    same; K4's rows entry on G's materialised operands (32 columns: the
    fold) within the same bound and bit for bit to its plain walk, the
    former Gluon kernel beside it within max(i + 2, ⌈log2 32⌉ + 3); on
    the few long rows of K4_ROWS_SHAPES (past 64 columns: the Gluon
    kernel kept) it and its plain walk within
    prefix_scan.k4_rows_bound_steps, ⌈log2 bc⌉ + ⌈(i+1)/bc⌉ + 2, the
    tree in a block of bc columns and a carry a block;
  * "was" (every K1 solo row of A, B, D, O1 and I's plans, every K4 row):
    the former kernel (experiments/former_kernels.py) on the same inputs,
    timed in turns was, new, new, was; K1's new solo kernel bit for bit
    against it (the same stage arithmetic on every element, each row's
    carry in the same column order), the ragged row also against the
    emulator and torch.add;
  * K7 (H): values (by their bits) and indices bit-exact against the
    oracle ref.topk (lax.top_k's order) everywhere, and against the plain
    network (the JAX kernel's) on every input without NaN and without
    both signed zeros, where the two orders agree; K3 in H (sums of 0/1
    below 2²⁴) bit-exact;
  * K8 (H) in float32, per row i against the plain version and the oracle:
    (D·eps_f32·scale·max_j Σ_d|q_id·k_jd| + sk·eps_f32)·2·max|v| — the
    logits' fp32 dot products, then the weighted sums, in other orders;
    in bfloat16 that bound plus one bfloat16 ulp at |plain| + bound (both
    round the fp32 result once; near zero, and where the random weights
    make the logits large, the fp32 difference alone can exceed an ulp),
    and the number of elements beyond one ulp is printed. In bfloat16
    also against the float64 result (`attn_f64_misses`), on the path's own
    inputs and at the prefill's shape with unit-scale logits: every output
    o_d within half a bf16 ulp plus the row's relative term above times
    2·(Σ_j p_j·|v_jd| + |o_d|) (its own scale, not the head's max|v|); and
    no more outputs beyond one bf16 ulp of float64 than the plain version
    has. On the path's inputs strictly; at unit scale, where K8 and plain
    both sit at fp32's floor (~850 of 33.5 M each) and differ only in which
    elements they miss, give or take UNIT_SCALE_NOISE = 4 standard
    deviations of the paired difference (√ of the elements only one of
    them misses) — two bf16 terms of p, or the three terms chained in one
    accumulator, miss 10× and 4× as many there. "Within one bf16 ulp of the
    plain version" holds only for a kernel that sums q·kᵀ in the plain
    version's own order: at the random weights' logits (~10³, fp32 ulp
    6e-5) a logit's last bit moves an output near zero by more than an
    ulp;
  * H: every prefill and decode logit finite, the greedy tokens of two
    runs on the same inputs bit-identical, the launch counts above;
  * G: the in-place call bit-identical to K4's rows entry on the
    materialised operands and to the plain walk (one fold, each product
    and add rounded alone); it and the plain version each within the
    float64 bound above. J, K: each prefill K4 call within the same bound
    on its own inputs (a weak hold: under the reference's init every
    chunk's decay is 0 in float32, so y = b there); so, at the path's
    shape on G's kind of random decays in (0, 1], G's holds; logits finite, two
    greedy runs bit-identical, the launch counts above, J's scheduled
    tokens equal to its unscheduled ones with nothing shed;
  * L: every step's loss and gradient norm finite; step 0 (warmup, lr
    0) leaves the params bit for bit; step 1 moves them; the launch
    counts above, each step (K4's da pass once a reverse walk). At the
    step's states shape: K4's forward entry with G's holds; the reverse
    walk bit-identical to the forward entry on flipped copies (it maps
    the chunk index only), and, flipped, G's holds; c4_statescan's
    backward in kernel and interpret modes bit for bit (λ the same fold,
    da the same reduction order: state_da_plain), da the same bits on a
    second run, both modes and the former path (the former walk, then
    the product at the states' size summed by torch) against float64 at
    ``statescan_grad_misses``' bounds (ds = λ at G's bound counted from
    the end, da through the product and the reduction: b_da), the fused
    da within 2·b_da of the former path's. The 2-layer float32
    gradient: every leaf of kernel mode and of interpret mode within
    TRAIN_GRAD_REL = 1e-4 of its max |g| of ref mode's, and the loss
    within 1e-4 relative (the issue's tolerance for the port's gradients
    against the JAX package's; at the reduced Mamba2 on the CPU the two
    modes differ by 3e-7 of max |g|, and a backward that drops the
    carry, drops da or walks the unshifted decay by 1e-1 or more), the
    chunks' median decay above 0.05;
  * M: kernel-mode gradients, loss, gradient norm and new train state
    bit-identical to ref mode's (K7 and K3 are exact against their
    oracles; scatters and gathers in their deterministic form in both),
    K7 and K3 launched 2 × 2 times in kernel mode (forward and recompute
    of each layer) and nothing in ref mode; K7's gradient at the router
    shape equal to the scatter of ref.topk's picks; train.main's resume
    prints "resumed from step 6" and ends on a finite loss;
  * N1: every leaf of every rank bit for bit against
    ring_allreduce_plain of the four ranks' leaves, replayed once a leaf
    on the parent after the ranks exit (each hop one IEEE operation; the
    ranks' leaves compared by SHA-256), and within 8/127 of the float64
    mean's absmax (the reference test's bound); N2: routing (ids, dst) bit-exact against the
    one-process layer on the same rows, outputs within 4 bf16 ulps of
    each row's max |ref| (each expert's output and TP's four partials are
    rounded to bf16 once, and EP's expert buffers have 4·cap rows: another
    product algorithm), K7 and K3 once a rank a call; N3: step 0's loss
    within rtol 2e-4 of the one-process run's (the reference test's), each
    step's grad norm within rtol 1e-2 (bf16 gradients summed over two
    shards in another order), each step's reduced gradient shards leaf
    by leaf within 2⁻⁷ (one bf16 ulp) of the max |g| of one process's
    gradient over the same row blocks (grad_accum 2: a rank's reduced
    gradient is the bf16 rounding of the mean that one process sums in
    float32; the whole batch's gradient at once is printed beside it, up
    to 0.18 of the max away from both in bf16 through 48 layers), K4 96
    forward and 48 reverse a step a rank; after step 1 every param finite, and where the two steps'
    gradients are well above their error (n3_hold_params; at least half
    the params) within one bf16 ulp plus lr/8 of the one-process run's;
    N4:
    the last stage's outputs bit-identical to the one-process forward
    (same ops and shapes; the handoff is a copy), K4 12 times a stage an
    active tick, each stage idle on 3 of 11 ticks (bubble_fraction(4, 8));
    N5: every result bit for bit against its solo K1 launch, one
    k1_batch_kernel a rank, both ranks' placements equal; N6: the resume
    prints "resumed from step 4 on mesh 2x1", the served tokens equal
    one process's; the --slo-shed run sheds the same steps on both
    ranks, at least one, and both return the same tokens; N7a: each
    step's loss within N7A_LOSS_RTOL = 1e-3 of one process's on the same
    params and rows (each of the 48 layers' exit rounds the two ranks'
    bf16 partial sums and their sum where one process rounds one
    product, ≤ 1.5 bf16 ulps of the layer's update; the loss, a mean
    over 8192 tokens of a function whose gradient in the logits has L1
    norm ≤ 2, moves by at most twice the largest logit's change, and
    1e-3 of ≈ ln 50280 = 10.8 allows 5e-3 at every token at once), K4
    96 forward and 48 reverse a step a rank on (2, 16, 32, 64, 128)
    only, the gradient cut's reduced shards within TRAIN_GRAD_REL = 1e-4
    of one process's max |g| (float32, as L), K4 at the rank's shape as
    L holds it; N7b: each rank's prefill logits (gathered over
    ``model``) within N7B_F32_FACTOR = 4 times one process's distance
    from the float32 forward of the same weights (the split rounds each
    row-parallel product twice where one process rounds once, so its
    bf16 error is of the same order: twice, with room), equal on both
    ranks, K8 32 launches a rank on (4, 16, 2048, 128) and no other
    kernel; that bound is loose by nature: at the reference's random
    init a deep model is chaotic (on the CPU, a 256-wide Llama-3 of 16
    layers: one process's float32 logits 0.46 of their max from its
    float64 ones, 3.4e-3 at 8 layers, 3.9e-6 at 2),
    so the split is also held where rounding stays small, on a float32
    cut of N7B_CUT_LAYERS = 2 layers at every published width (K8's
    float32 path, 2 launches a rank): its logits within N7B_CUT_REL =
    1e-4 of their max of one process's (the 2-layer gradient cut's
    bound; float32 rounding over 4096-term products and two layers,
    against 2.6e-6 measured at 256 wide on the CPU); the greedy tokens' agreement with one process printed, not
    gated (an argmax of two logits a bf16 rounding apart may flip); each
    rank's peak under N_RANK_PEAK (counted there);
  * O1: each instruction's K1 result bit for bit against the emulator,
    the oracle and the one PyTorch call (x.view(r, c // 2, 2).sum(-1):
    one IEEE add an element; x.to(torch.bfloat16): one rounding to
    nearest even), one K1 launch each; bound 256 MiB read + 128 MiB
    written at 3.35 TB/s = 0.1202 ms;
  * O2: the dry run's FLOPs equal FlopCounterMode's over the real step
    exactly (both count the same matrix products: K4's kernel on the
    card and its oracle on meta tensors hold none); its predicted peak
    (arguments + the walk's live storages) within O2_PEAK_RATIO = (0.8,
    1.25) of torch.cuda.max_memory_allocated over that step — the walk
    counts every storage's exact bytes, and the card adds the caching
    allocator's 512-byte rounding, library workspaces and K4 in place of
    its oracle's temporaries, each well under a GB of a ~37 GB peak,
    while a count that missed the optimizer's moments or the saved
    layer inputs (each ≥ 5 GB) would fall outside; its roofline lower
    bound beside the measured step seconds, not gated;
  * P: the launch counts above, exactly; c7 ≤ 2 ulp against the oracle
    and the emulator (D's), the program's value equal to the sum of the
    validated launch's output; each tenant's result bit for bit against
    its solo K1 launch and the interpret path, and against ref at the
    multiply-add bound; the sort bit-exact against torch.sort and the
    plain network, the prefix sum at F's K3 bound against float64, the
    plan's outputs at I's bound (hold_plan); serve_decode's K4 calls at
    J's bound, its tokens in range and equal on a second run (the plain
    path's agreement printed, not gated: sampling at temperature 0.8);
    train_lm's final loss finite, a checkpoint written, and the mean of
    its last TRAIN_LM_WINDOW = 5 logged losses below that of its first
    five by more than TRAIN_LM_FALL = 0.05;
  * peak device memory per phase: 3 GB for A–D, 6 GB for E (torch.sort's
    own temporaries in the reference's base-core levels), 4 GB for F and G
    (padding the one-row operand to 8 rows would pass it), for H the
    weights' bytes + 8 GB, 3 GB for I (≈ 0.8 GB for A's requests,
    ≈ 1.6 GB for B's inputs and outputs), and for J and K the weights'
    bytes plus a count of one layer's largest intermediates
    (``ssm_peak_limit``: 14.5 GB for J, 8.4 GB for K); for L the larger
    of a train step's two peaks counted in bytes (``train_peak_limit``:
    the forward and backward's, the optimizer update's: 50.2 GB); 3 GB
    for M; for N's parent L's (N2's one-process layer holds 33.8 GB of
    experts, N3's reference is L's step); 3 GB for O1 (x 256 MiB and
    four outputs of 128 MiB), L's for O2 (L's step), 3 GB for P.

Bounds: the larger of the bytes a call must move at 3.35 TB/s and its
operations at the peak rate of their kind — 67 TFLOP/s for fp32 work on
the CUDA cores, 989 TFLOP/s for K8's products (bf16 on the tensor cores);
each row names the one it used.

Generated Triton sources go to ``build/repro_torch/``, the CUDA libraries
to ``build/repro_torch/cuda/`` and Triton's cache to ``build/triton/``
unless the environment names others.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "experiments"))   # former_kernels (was)
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("REPRO_TORCH_BUILD_DIR",
                      str(ROOT / "build" / "repro_torch"))

import repro_torch.kernels  # noqa: E402,F401  (registers the ISA)
from repro_torch.core import isa  # noqa: E402
from repro_torch.core import fused_kernel as fk  # noqa: E402
from repro_torch.core import program as prog_mod  # noqa: E402
from repro_torch.core.fused_kernel import K1  # noqa: E402
from repro_torch.core.stream import flatten_to_blocks  # noqa: E402
from repro_torch.core.template import KernelTemplate  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import prefix_scan as ps  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import flashattn as fa  # noqa: E402
from repro_torch.kernels import sortnet as sn  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.kernels import stream_copy  # noqa: E402
from repro_torch.kernels import topk as tk  # noqa: E402
from repro_torch.kernels.flashattn import K8  # noqa: E402
from repro_torch.kernels.prefix_scan import K3, K4  # noqa: E402
from repro_torch.kernels.sortnet import K5, K6  # noqa: E402
from repro_torch.kernels.ssd_chunk import SSD_CHUNK  # noqa: E402
from repro_torch.kernels.topk import K7  # noqa: E402
from repro_torch.launch import api, dryrun, serve, train  # noqa: E402
from repro_torch.launch.mesh import DryMesh  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import SyntheticLMData, to_device  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from repro_torch.graph import partition  # noqa: E402
from repro_torch.memhier import H100  # noqa: E402
from repro_torch.sched import (CostModel, RequestQueue, Scheduler,  # noqa: E402
                               TraceRecorder, placements_match, replay)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import (DTYPES, param_specs, tree_items,  # noqa: E402,E501
                                       tree_map)

SEED = 0
N_STREAM = 1 << 26                 # 256 MiB per float32 array
N_ITEM, N_ITEMS = 1 << 22, 16      # phase C: 16 requests of 16 MiB
N_RAGGED = N_ITEM - 1000           # phase C's second batch: a masked tail
N_RAGGED_SOLO = N_STREAM - 1000    # phase A's ragged solo call
CARRIED_ITEM = (1000, 16381)       # phase D's batch of 4 (ragged) items
ABSMAX_SHAPE = (4096, 16384)       # phase D
SCALE, TRIAD_S = 2.5, 3.0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
OPS_PER_S = {"fp32": 67e12,        # H100 SXM, FP32 outside tensor cores
             "bf16 tensor": 989e12}   # bf16 dense on the tensor cores
N_SORT = 1 << 26                   # phase E: 256 MiB of int32 keys
MAX_KERNEL_WIDTH = 4096            # the app's merge cut-over to torch.sort
MERGE_WIDTHS = tuple(8 << k for k in range(9))   # phase E's K6 levels
N_SCAN = 1 << 26                   # phase F: 256 MiB of float32
SSD_SHAPE = (4, 32, 64)            # phase G: (batch, chunks, heads)
SSD_STATE = (64, 128)              # (headdim, state) of mamba2_1p3b
EPS = float(torch.finfo(torch.float32).eps)
K3_PLAIN_LIMIT = 0.05              # phase F: |K3 − plain|, see the docstring
UNIT_SCALE_NOISE = 4.0             # phase H: K8's paired count (docstring)
TOPK_WIDE = (64, 8192)             # phase H: K7 rows above 4096 (k ≤ 32)
TOPK_FULL_K = 40                   # phase H: K7's full network (k > 32)
K5_WIDTHS = (("float32", 16), ("float32", 64), ("bfloat16", 64),
             ("float32", 512), ("float32", 4096))   # phase E, off the app
LM_ARCH = "kimi_k2_1t"             # phase H: the served model
LM_LAYERS = 2                      # of 61 (see the docstring)
LM_BATCH, LM_PROMPT, LM_GEN = 4, 1024, 16
N_SCHED_ITEM, N_SCHED_ITEMS = 1 << 22, 16   # phase I: tenant A's requests
N_SCHED_PLAN = 1 << 26             # phase I: tenant B's plans
N_HOST = 1 << 12                   # phase I: the same mix for host overhead
HOST_REPS = 10                     # phase I: runs of that mix
FIT_NS = tuple(1 << k for k in range(10, 19))   # phase I: c0_copy sizes
PLAN_S, PLAN_T = 1.5, 0.5          # axpby_residual's scalars
SAX_A, SAX_B = 2.0, -0.75          # saxpby's scalars
SSM_SERVES = {   # phase: (arch, batch, prompt length, greedy tokens)
    "J": ("mamba2_1p3b", 4, 8192, 16),
    "K": ("hymba_1p5b", 4, 2048, 16),
}
SCHED_PROMPT, SCHED_SLO_MS = 256, 1000.0   # phase J's scheduled run
# the SSD chunk-output kernel alone (batch, chunks, chunk, heads, headdim,
# state): J's at the benchmark cell's 8 × 8192 tokens, K's at its own
SSD_CHUNK_SHAPES = {"J": (8, 32, 256, 64, 64, 128),
                    "K": (4, 8, 256, 64, 50, 16)}
SSD_TOL = 1e-5                     # of max |y|: the SSD layer tolerance
TRAIN_ARCH = "mamba2_1p3b"         # phase L: trained uncut
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4096, 3
TRAIN_GRAD_LAYERS = 2              # phase L's gradient check (docstring)
TRAIN_GRAD_REL = 1e-4              # each leaf, of its max |g|
MOE_ARCH = "kimi_k2_1t"            # phase M: reduced (see the docstring)
ROUTER_SHAPE, ROUTER_K = (4096, 384), 8     # phase M: H's prefill router
O1_SHAPE = (8192, 8192)            # phase O1: 2²⁶ float32 elements
O2_PEAK_RATIO = (0.8, 1.25)        # phase O2: predicted / measured peak
N6_SLO_MS = 0.5                    # N6's --slo-shed run: every step misses
TRAIN_LM_STEPS = 200               # phase P's train_lm (see the docstring)
TRAIN_LM_WINDOW, TRAIN_LM_FALL = 5, 0.05   # its losses: means of 5 logged
LM_REDUCED = ["n_layers 61 → 2: two layers of bf16 weights are 67.9 GiB "
              "on one 80 GB card",
              "attn_impl chunked → kernel: the switch under which prefill "
              "launches c6 (K8)"]


def lm_config(n_layers: int = LM_LAYERS):
    """Kimi-K2 at its published widths, cut in depth, attention on c6."""
    return dataclasses.replace(get_config(LM_ARCH), n_layers=n_layers,
                               attn_impl="kernel")


def weight_bytes(cfg) -> int:
    return sum(math.prod(s.shape) * DTYPES[s.dtype or cfg.param_dtype].itemsize
               for _, s in tree_items(param_specs(cfg)))


def ssm_peak_limit(cfg, batch: int, seq: int) -> float:
    """Phase J/K's device-memory limit, counted from the weights and the
    largest intermediates of one layer's prefill: three of the SSD's
    (B, C, Q, Q, H) float32 intra-chunk tensors (the tensor, its
    contiguous copy for the product, one spare), ten float32 (B, S,
    d_inner) activations (x, z, their casts, the chunk views and the
    copy for the product, y_intra, y_inter, y, the inter-chunk term),
    and, with attention, three (B, KV, G, chunk, S) float32 logit tensors
    of the chunked path (logits, softmax, the cast weights)."""
    q = min(cfg.ssm_chunk, seq)
    quad = batch * seq * q * cfg.ssm_heads * 4
    act = batch * seq * cfg.d_inner * 4
    attn = (batch * cfg.n_heads * min(cfg.attn_chunk, seq) * seq * 4
            if cfg.has_attention else 0)
    return weight_bytes(cfg) + 3 * quad + 10 * act + 3 * attn


def train_peak_limit(cfg, batch: int, seq: int) -> float:
    """Phase L's device-memory limit, counted in bytes: the larger of the
    two peaks of a train step.

    * forward and backward: the params, their gradient, the gradient's
      per-layer parts before the stack (bf16, one copy each) and two
      float32 moments (4 × the bf16 params); the 48 saved layer inputs
      (B, S, D) in bf16 (remat full); one layer's recompute and backward
      intermediates: eight (B, C, Q, Q, H) float32 intra-chunk tensors
      (the saved exp, the masked decay, its two products, and the
      backward's gradients of them) and 24 float32 (B, S, d_inner)
      activations; four (B·S, vocab) float32 tensors (the logits, the
      log-sum-exp's exp and gradient, the gather's gradient);
    * the optimizer's update: the old params, moments and clipped
      gradient and the new params and moments (11 × the bf16 params),
      and six float32 copies of the largest leaf (its gradient, the
      two moments, the update and two temporaries)."""
    params = weight_bytes(cfg)
    q = min(cfg.ssm_chunk, seq)
    quad = batch * seq * q * cfg.ssm_heads * 4
    act = batch * seq * cfg.d_inner * 4
    logits = batch * seq * cfg.vocab * 4
    saved = cfg.n_layers * batch * seq * cfg.d_model * 2
    largest = max(math.prod(s.shape) for _, s in
                  tree_items(param_specs(cfg))) * 4
    forward_backward = 7 * params + saved + 8 * quad + 24 * act + 4 * logits
    update = 11 * params + 6 * largest
    return max(forward_backward, update)


PEAK_MEM_LIMIT = {"A": 3e9, "B": 3e9, "C": 3e9, "D": 3e9,
                  "E": 6e9, "F": 4e9, "G": 4e9,
                  "H": weight_bytes(lm_config()) + 8e9, "I": 3e9,
                  **{ph: ssm_peak_limit(get_config(arch), b, p)
                     for ph, (arch, b, p, _) in SSM_SERVES.items()},
                  "L": train_peak_limit(get_config(TRAIN_ARCH), TRAIN_BATCH,
                                        TRAIN_SEQ),
                  "M": 3e9, "O1": 3e9, "P": 3e9,
                  "O2": train_peak_limit(get_config(TRAIN_ARCH),
                                         TRAIN_BATCH, TRAIN_SEQ)}
KERNELS = {   # name: (route, source in the repo, the TPU kernel it replaces)
    "K1": ("triton", "src/repro_torch/core/fused_kernel.py",
           "src/repro/core/program.py:914"),
    "K3": ("cuda", "src/repro_torch/kernels/csrc/prefix_scan.cu",
           "src/repro/kernels/prefix_scan.py:66"),
    "K4": ("cuda", "src/repro_torch/kernels/csrc/prefix_scan.cu",
           "src/repro/kernels/prefix_scan.py:123"),
    # K4's rows entry past 64 columns: the former Gluon kernel, kept
    "K4 rows": ("triton", "src/repro_torch/kernels/prefix_scan.py",
                "src/repro/kernels/prefix_scan.py:123"),
    "K5": ("cuda", "src/repro_torch/kernels/csrc/sortnet.cu",
           "src/repro/kernels/sortnet.py:139"),
    "K6": ("cuda", "src/repro_torch/kernels/csrc/sortnet.cu",
           "src/repro/kernels/sortnet.py:186"),
    "K7": ("cuda", "src/repro_torch/kernels/csrc/topk.cu",
           "src/repro/kernels/topk.py:50"),
    "K8": ("cuda", "src/repro_torch/kernels/csrc/flashattn.cu",
           "src/repro/kernels/flashattn.py:84"),
    "SSD": ("cuda", "src/repro_torch/kernels/csrc/ssd_chunk.cu",
            "none (the chunk output the JAX package leaves to XLA)"),
}


# ---------------------------------------------------------------------------
# phase D's user-defined instruction: the quickstart's (examples/quickstart.py
# §1–3, repro_torch.examples.quickstart)
# ---------------------------------------------------------------------------

ABSMAX = quickstart.TEMPLATE


def register_absmax() -> None:
    isa.register(quickstart.instruction(), overwrite=True)


# ---------------------------------------------------------------------------
# phase O1's user-defined shape-changing instructions (isa.define)
# ---------------------------------------------------------------------------

def _pairsum_body(scalars, ins, carry, step):
    x = ins[0]
    return (x[..., 0::2] + x[..., 1::2],), carry


_PAIRSUM_TRITON = """
def pairsum(x0, carry, step):
    a, b = tl.split(tl.reshape(x0, (x0.shape[0], x0.shape[1] // 2, 2)))
    return a + b, carry
"""


def _to_bf16_body(scalars, ins, carry, step):
    return (ins[0].to(torch.bfloat16),), carry


_TO_BF16_TRITON = """
def to_bf16(x0, carry, step):
    return x0.to(tl.bfloat16), carry
"""

# out[:, j] = x[:, 2j] + x[:, 2j+1]: rows kept, columns halved, so the
# 8×1024 tile writes an 8×512 block
PAIRSUM = KernelTemplate(
    name="pairsum", body=_pairsum_body, block_rows=8, block_cols=1024,
    out_shapes=lambda x: [torch.empty((x.shape[0], x.shape[1] // 2),
                                      dtype=x.dtype, device="meta")],
    triton_body=_PAIRSUM_TRITON)
# float32 → bfloat16 (round to nearest even): same shape, another dtype
TO_BF16 = KernelTemplate(
    name="to_bf16", body=_to_bf16_body, block_rows=8, block_cols=1024,
    out_shapes=lambda x: [torch.empty(x.shape, dtype=torch.bfloat16,
                                      device="meta")],
    triton_body=_TO_BF16_TRITON)


def pairsum_plain(x: torch.Tensor) -> torch.Tensor:
    """The one PyTorch call computing ``pairsum``."""
    return x.view(x.shape[0], x.shape[1] // 2, 2).sum(-1)


def to_bf16_plain(x: torch.Tensor) -> torch.Tensor:
    """The one PyTorch call computing ``to_bf16``."""
    return x.to(torch.bfloat16)


O1_TEMPLATES = {"pairsum": (PAIRSUM, pairsum_plain),
                "to_bf16": (TO_BF16, to_bf16_plain)}


def define_o1() -> None:
    """Phase O1's two instructions as a user defines them (paper §2.2):
    ``isa.define`` from the oracle, then ``isa.bind_kernel`` attaches the
    template's launch (K1 at the template's declared tile)."""
    for name, (tpl, plain) in O1_TEMPLATES.items():
        isa.define(name, itype="I'", vector_in=1, vector_out=1,
                   pipeline_depth=tpl.pipeline_depth(), overwrite=True,
                   doc=f"{name}: a shape-changing stage on K1")(plain)
        isa.bind_kernel(name, lambda x, interpret=False, tpl=tpl: tpl(
            x, interpret=interpret))


# ---------------------------------------------------------------------------
# the main path, phase by phase (also driven at tiny sizes by the tests)
# ---------------------------------------------------------------------------

def make_inputs(seed: int, shapes, device) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .to(device) for s in shapes]


A_CASES = {   # case: (call, bytes per element, operations per element)
    "c0_copy": (lambda a, b, m: ops.stream_copy(a, mode=m), 8, 0),
    "c0_scale": (lambda a, b, m: ops.stream_scale(a, SCALE, mode=m), 8, 1),
    "c0_add": (lambda a, b, m: ops.stream_add(a, b, mode=m), 12, 1),
    "c0_triad": (lambda a, b, m: ops.stream_triad(a, b, TRIAD_S, mode=m),
                 12, 2),
}


def phase_a(a, b, mode):
    """The four STREAM instructions, solo."""
    return {case: call(a, b, mode) for case, (call, _, _) in A_CASES.items()}


def phase_b(x, b, mode):
    """Two fused chains, one launch each."""
    return {"c0_scale+c0_add": isa.fuse("c0_scale", "c0_add")(
                SCALE, x, b, mode=mode),
            "c0_scale+c0_add+c0_copy": isa.fuse(
                "c0_scale", "c0_add", "c0_copy")(SCALE, x, b, mode=mode)}


def batch_scalars(k: int) -> list[float]:
    return [0.25 * (i + 1) for i in range(k)]


def phase_c(xs, bs, interpret: bool):
    """scale→add requests with distinct scalars, coalesced in one launch."""
    prog = isa.fuse("c0_scale", "c0_add").program
    return prog.call_batch(
        [(s, x, b) for s, x, b in zip(batch_scalars(len(xs)), xs, bs)],
        interpret=interpret)


def phase_d(x, mode):
    """The user-defined carried instruction (register_absmax() first)."""
    return isa.call("c7_absmax_scale", x, mode=mode)


def phase_o1(x, mode):
    """The two shape-changing instructions (define_o1() first), one
    launch each."""
    return {name: isa.call(name, x, mode=mode) for name in O1_TEMPLATES}


def sort_keys(seed: int, n: int, device) -> torch.Tensor:
    """Uniform int32 keys, as the example draws them."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n,
                                         dtype=np.int32)).to(device)


def phase_e(v, mode):
    """The mergesort app (paper §4.3.1): c2_sort, then c1_merge levels."""
    return ops.sortnet_mergesort(v[None], max_kernel_width=MAX_KERNEL_WIDTH,
                                 mode=mode)[0]


def phase_f(x, mode):
    """The prefix-sum app (paper §4.3.2): c3_prefixsum over one row."""
    return ops.prefix_sum(x[None], mode=mode)[0]


def ssd_inputs(seed: int, shape, state, device):
    """Per-(batch, chunk, head) decays in (0, 1] and chunk end-states."""
    rng = np.random.default_rng(seed)
    a = np.exp(-np.abs(rng.standard_normal(shape, dtype=np.float32)))
    b = rng.standard_normal(tuple(shape) + tuple(state), dtype=np.float32)
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def phase_g(a, states, mode):
    """SSD's inter-chunk recurrence (models/ssm.py): c4_statescan."""
    return ops.chunk_scan_state(a, states, axis=1, mode=mode)


def serve_prompts(seed: int, cfg, batch: int, prompt_len: int, device):
    """Uniform token ids from seeded numpy."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt_len))
                            ).to(device)


def phase_h(cfg, params, prompts, gen: int, mode):
    """The LM server (launch/serve.py): prefill, cache growth, greedy
    decode; phases H, J and K. Returns (tokens (B, gen), prefill s,
    decode s)."""
    with isa.use(mode):
        return serve.generate(cfg, params, prompts, gen)


def sched_plans(n: int, model=H100):
    """Tenant B's two plans, partitioned under ``model`` at ``n``
    elements: axpby_residual (two parts) and saxpby (two parts)."""
    return (partition(ops.c0_pipeline_graph("axpby_residual"), model=model,
                      n_elems=n),
            partition(ops.c0_pipeline_graph("saxpby"), model=model,
                      n_elems=n))


def phase_i(xs, bs, x, b, plans, mode, recorder=None, hierarchy=H100,
            cost=None):
    """Two tenants through the scheduler (weighted fair, two lanes, wall
    clock): tenant A's fuse(c0_scale, c0_add) requests share one scalar
    and coalesce into one batch; tenant B submits the two plans on
    (x, b). ``cost`` defaults to a fresh CostModel over ``hierarchy``.
    Returns (report, A's items, B's items)."""
    q = RequestQueue()
    fused = isa.fuse("c0_scale", "c0_add")
    a_items = [q.submit(fused, (SCALE, xa, ba), tenant="A")
               for xa, ba in zip(xs, bs)]
    axpby, saxpby = plans
    b_items = [q.submit(axpby, (x, b, PLAN_S, PLAN_T), tenant="B"),
               q.submit(saxpby, (x, b, SAX_A, SAX_B), tenant="B")]
    if cost is None:
        cost = CostModel(hierarchy=hierarchy)
    sched = Scheduler(q, cost=cost, policy="wfq", n_lanes=2, clock="wall",
                      mode=mode, recorder=recorder)
    return sched.drain(), a_items, b_items


def plan_terms(kind: str, x, b):
    """Σ|term| of each output of a tenant B plan (the FMA bound's)."""
    if kind == "axpby_residual":
        return ((PLAN_S * x).abs() + b.abs(), x.abs() + (PLAN_T * b).abs())
    return ((SAX_A * x).abs() + (SAX_B * b).abs(),)


class Tap:
    """Inside ``with``, ``module.name`` passes every call through and keeps
    ``record(args, kwargs, result)`` of each in ``calls`` (by default the
    triple itself); it launches nothing itself."""

    def __init__(self, module, name: str, record=lambda *call: call):
        self.module, self.name, self.calls = module, name, []
        self.record = record

    def __enter__(self):
        fn = self.fn = getattr(self.module, self.name)

        def tapped(*args, **kw):
            out = fn(*args, **kw)
            self.calls.append(self.record(args, kw, out))
            return out

        setattr(self.module, self.name, tapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def attn_row_error(q, k, scale=None) -> torch.Tensor:
    """(..., sq, 1): D·eps·scale·max_j Σ_d|q_id·k_jd| + sk·eps, each row's
    first-order relative error of fp32 attention (the logits' dot
    products, then the weighted sums); walked over the leading axis."""
    d, sk = q.shape[-1], k.shape[-2]
    scale = d ** -0.5 if scale is None else scale
    out = []
    for qb, kb in zip(q, k):
        qk = torch.matmul(qb.float().abs(), kb.float().abs().transpose(-1, -2))
        out.append(d * EPS * scale * qk.amax(-1, keepdim=True) + sk * EPS)
    return torch.stack(out)


def attn_bound(q, k, v, scale=None) -> torch.Tensor:
    """(..., sq, 1): each row's fp32 summation bound for attention computed
    in two orders, :func:`attn_row_error`·2·max|v| (max|v| over the row's
    head)."""
    vmax = torch.stack([vb.float().abs().amax(dim=(-2, -1), keepdim=True)
                        for vb in v])
    return attn_row_error(q, k, scale) * 2 * vmax


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(torch.finfo(torch.float32)
                                                 .tiny)))
    return torch.exp2(e - 7)


def attn_misses(got, want, bound) -> tuple[int, float, int | None]:
    """(elements outside the tolerance, max |Δ|, elements beyond one bf16
    ulp of ``want`` — None for float32): float32 within ``bound``;
    bfloat16 within ``bound`` plus one bf16 ulp at |want| + bound."""
    err = (got.float() - want.float()).abs()
    if got.dtype != torch.bfloat16:
        return int((err > bound).sum()), float(err.max()), None
    w = want.float().abs()
    return (int((err > bound + bf16_ulp(w + bound)).sum()), float(err.max()),
            int((err > bf16_ulp(w)).sum()))


def exact_attention(q, k, v, heads: int = 8):
    """Causal attention (bottom-right aligned) of the same bf16 or fp32
    values in float64, a few heads at a time; and each output's
    Σ_j p_j·|v_jd|, the scale of its summation errors."""
    sq, sk, d = q.shape[-2], k.shape[-2], q.shape[-1]
    mask = (torch.arange(sk, device=q.device)[None, :]
            > torch.arange(sq, device=q.device)[:, None] + sk - sq)
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    mass = torch.empty_like(out)
    for b in range(q.shape[0]):
        for h in range(0, q.shape[1], heads):
            s = torch.matmul(q[b, h:h + heads].double(),
                             k[b, h:h + heads].double().transpose(-1, -2))
            p = torch.softmax((s * d ** -0.5).masked_fill(mask, -math.inf),
                              -1)
            vb = v[b, h:h + heads].double()
            out[b, h:h + heads] = torch.matmul(p, vb)
            mass[b, h:h + heads] = torch.matmul(p, vb.abs())
    return out, mass


def attn_f64_misses(got, plain, q, k, v) -> dict:
    """bf16 ``got`` and ``plain`` (attention of q, k, v) against the float64
    result: the elements of each beyond one bf16 ulp of it, the elements
    beyond one ulp for ``got`` alone and for ``plain`` alone, and the
    elements of ``got`` outside their own bound, half a bf16 ulp plus
    :func:`attn_row_error`·2·(Σ_j p_j·|v_jd| + |o_d|) (a logit error δ
    moves o_d by at most max δ·Σ_j p_j·|v_jd − o_d|)."""
    exact, mass = exact_attention(q, k, v)
    ulp = bf16_ulp(exact.float()).double()
    err = (got.double() - exact).abs()
    over, plain_over = err > ulp, (plain.double() - exact).abs() > ulp
    bound = ulp / 2 + attn_row_error(q, k).double() * 2 * (mass
                                                           + exact.abs())
    return {"over_one_bf16_ulp_f64": int(over.sum()),
            "plain_over_one_bf16_ulp_f64": int(plain_over.sum()),
            "over_alone": int((over & ~plain_over).sum()),
            "plain_over_alone": int((plain_over & ~over).sum()),
            "outside_element_bound_f64": int((err > bound).sum())}


def oracle_attention(q, k, v):
    """ref.flash_attention (causal), one batch element at a time."""
    return torch.cat([ref.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1])
                      for i in range(q.shape[0])])


def routing_agreement(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of (token, expert) choices of ``a`` (t, k) that ``b`` makes."""
    return float((a[:, :, None] == b[:, None, :]).any(-1).float().mean())


def prefix_bound_misses(got, ref64, abs64, bc: int, k_abs: int,
                        k_ends: int = 1,
                        step: int = 1 << 22) -> tuple[int, float]:
    """(elements outside eps·(k_abs·Σ_{j≤i}|xⱼ| + k_ends·Σ_{e<i}|y_e| +
    |yᵢ|), the largest |Δ|) of a 1-D blocked scan against its float64
    reference ``ref64`` (``abs64`` = the cumsum of |x|; e = the last index
    of each earlier block of ``bc``); (k_abs, k_ends) are the constants of
    the scan's summation order; walked in slices to bound the memory."""
    n = got.numel()
    ends = ref64[bc - 1::bc].abs()
    carried = torch.nn.functional.pad(torch.cumsum(ends, 0), (1, 0))
    bad, worst = 0, 0.0
    for s in range(0, n, step):
        blk = torch.arange(s, min(s + step, n), device=got.device) // bc
        y = ref64[s:s + step]
        err = (got[s:s + step].double() - y).abs()
        bound = EPS * (k_abs * abs64[s:s + step] + k_ends * carried[blk]
                       + y.abs())
        bad += int((err > bound).sum())
        worst = max(worst, float(err.max()))
    return bad, worst


def fold_steps(c, n_c: int = 0, was: bool = False):
    """k(c) of K4's first-order bound k(c)·eps32·Σ|b| at walk step c
    (``prefix_scan.k4_bound_steps``: the sequential fold); with ``was``
    at least the former tree scan's over ``n_c`` chunks in one block,
    ⌈log2 n_c⌉ + 3, so that one bound holds for both designs."""
    k = ps.k4_bound_steps(c)
    return max(k, math.ceil(math.log2(max(n_c, 1))) + 3) if was else k


def statescan_f64(a, states, was: bool = False):
    """For each chunk c along axis 1: (c, the float64 sequential recurrence
    y_c = a_c·y_{c-1} + b_c, its bound fold_steps(c)·eps32·Σ_{j≤c}|b_j|;
    ``was``: the bound that also holds the former tree scan)."""
    y = torch.zeros_like(states[:, 0], dtype=torch.float64)
    s = torch.zeros_like(y)
    for c in range(states.shape[1]):
        b = states[:, c].double()
        y = a[:, c, :, None, None].double() * y + b
        s = s + b.abs()
        yield c, y, fold_steps(c, states.shape[1], was) * EPS * s


def statescan_bound_misses(got, a, states,
                           was: bool = False) -> tuple[int, float]:
    """The same bound for the state scan along axis 1, against a float64
    sequential recurrence y_c = a_c·y_{c-1} + b_c."""
    bad, worst = 0, 0.0
    for c, y, bound in statescan_f64(a, states, was):
        err = (got[:, c].double() - y).abs()
        bad += int((err > bound).sum())
        worst = max(worst, float(err.max()))
    return bad, worst


def hold_statescan(check, what, got, plain, a, states) -> float:
    """The kernel's ``got`` and the plain version's ``plain`` each within
    the state scan's float64 bound, and bit-identical to each other (one
    fold, one rounding order); returns the kernel's max |Δ| to float64."""
    bad = {"K4": 0, "plain": 0}
    worst = 0.0
    for c, y, bound in statescan_f64(a, states):
        g, p = got[:, c].double(), plain[:, c].double()
        for key, err in (("K4", (g - y).abs()), ("plain", (p - y).abs())):
            bad[key] += int((err > bound).sum())
        worst = max(worst, float((g - y).abs().max()))
    for key, n in bad.items():
        check.true(f"{what} {key}: {n} elements outside the summation "
                   f"bound", n == 0)
    check.exact(f"{what} K4 vs plain", got, plain)
    return worst


def statescan_grad_misses(grads: dict, a, states, g,
                          was: bool = False) -> tuple:
    """The backward of ``y = chunk_scan_state(a, states, axis=1)`` under
    the output's gradient ``g``, held against float64 for each mode's
    ``(da, ds)`` in ``grads`` and between the first two modes' ds and da;
    returns ({check: elements outside its bound}, {check: largest |Δ|}).

    * ds = λ, λ[c] = g[c] + a[c+1]·λ[c+1]: the state scan's first-order
      bound counted from the end, fold_steps(C−1−c)·eps32·Σ_{j≥c}|g_j|;
    * da[c] = Σ_{P,N} λ[c]·y[c−1] (y[−1] = 0): Σ(b_λ·|y[c−1]| +
      |λ[c]|·b_y[c−1]) + P·N·eps32·Σ|λ[c]·y[c−1]|, b_y the forward's
      bound, P·N·eps32 the product's and the reduction's own rounding in
      any summation order;
    * between the first two modes: ds within b_λ, da within 2·b_da
      (each within b_da of float64).

    ``was``: a mode is the former design (a tree scan in one block), so
    every step's constant is at least the tree's (:func:`fold_steps`)."""
    n_c = states.shape[1]
    ad = a.double()[..., None, None]
    sd, gd = states.double(), g.double()
    y, lam = torch.empty_like(sd), torch.empty_like(gd)
    acc = torch.zeros_like(sd[:, 0])
    for c in range(n_c):
        acc = ad[:, c] * acc + sd[:, c]
        y[:, c] = acc
    acc = torch.zeros_like(gd[:, 0])
    for c in reversed(range(n_c)):
        acc = gd[:, c] + (ad[:, c + 1] * acc if c + 1 < n_c else 0.0)
        lam[:, c] = acc
    shape = (1, n_c) + (1,) * (g.ndim - 2)
    k_y = torch.tensor([fold_steps(c, n_c, was) for c in range(n_c)],
                       dtype=torch.float64, device=g.device).reshape(shape)
    k_lam = k_y.flip(1)
    b_y = k_y * EPS * torch.cumsum(sd.abs(), 1)
    b_lam = k_lam * EPS * torch.cumsum(gd.abs().flip(1), 1).flip(1)
    del sd, gd, acc
    prev = torch.cat([torch.zeros_like(y[:, :1]), y[:, :-1]], 1)
    b_prev = torch.cat([torch.zeros_like(b_y[:, :1]), b_y[:, :-1]], 1)
    del y, b_y
    pay = tuple(range(a.ndim, g.ndim))
    prod = lam * prev
    da64 = prod.sum(pay)
    b_da = ((b_lam * prev.abs() + lam.abs() * b_prev).sum(pay)
            + math.prod(g.shape[a.ndim:]) * EPS * prod.abs().sum(pay))
    del prev, b_prev, prod
    bad, worst = {}, {}
    for mode, (da, ds) in grads.items():
        for key, err, bound in (
                (f"{mode} ds", (ds.double() - lam).abs(), b_lam),
                (f"{mode} da", (da.double() - da64).abs(), b_da)):
            bad[key] = int((err > bound).sum())
            worst[key] = float(err.max())
    m0, m1 = list(grads)[:2]
    for i, key, bound in ((1, f"|ds {m0} - {m1}|", b_lam),
                          (0, f"|da {m0} - {m1}|", 2 * b_da)):
        err = (grads[m0][i].double() - grads[m1][i].double()).abs()
        bad[key], worst[key] = int((err > bound).sum()), float(err.max())
    return bad, worst


def carrying_decays(params: dict, chunk: int, seed: int) -> None:
    """Sets, in place, every SSD mixer's A_log to 0 (A = −1) and its
    dt_bias so that a chunk's nominal decay exp(−chunk·softplus(dt_bias))
    (the token's own term left out) is uniform in [0.05, 0.95] over the
    heads, from seeded numpy: under the reference init a chunk decays by
    ≈ e^−500, 0 in float32, and the scans' carry would not be
    exercised."""
    rng = np.random.default_rng(seed)
    for sub in params.values():
        if not isinstance(sub, dict):
            continue
        if "dt_bias" in sub:
            want = rng.uniform(0.05, 0.95, tuple(sub["dt_bias"].shape))
            dt = -np.log(want) / chunk
            sub["dt_bias"].copy_(torch.from_numpy(np.log(np.expm1(dt))))
            sub["A_log"].zero_()
        else:
            carrying_decays(sub, chunk, seed + 1)


def grad_ratios(got: dict, want: dict) -> dict:
    """Each leaf's max |got − want| over its max |want|."""
    want = dict(tree_items(want))
    return {path: float((x.double() - want[path].double()).abs().max())
            / max(float(want[path].double().abs().max()), 1e-30)
            for path, x in tree_items(got)}


# ---------------------------------------------------------------------------
# measurement helpers (card only)
# ---------------------------------------------------------------------------

CARD = ""                           # nvidia-smi's name and power limit
GPU_CYCLES_PER_S = 2.0e9            # above the H100's top SM clock
SPIN_CYCLES = 10_000_000            # ~5 ms: a spin around a traced call


def time_ms(fn, reps: int = 20, warmup: int = 3) -> tuple[float, float, float]:
    """(device ms, wall ms, stream ms) of one call of ``fn``.

    Wall: host clock over ``reps`` back-to-back calls ending in a
    synchronize — what a caller waits, dispatch overhead included.
    Stream: CUDA events around the same back-to-back run, per call
    (device time plus any gaps the host leaves).
    Device: median over ``reps`` CUDA-event pairs, each around one call,
    taken while a spin kernel holds the device until the host has
    enqueued every call, so each pair brackets device time only."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s0 = torch.cuda.Event(enable_timing=True)
    s1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    s0.record()
    for _ in range(reps):
        fn()
    s1.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps * 1e3
    stream = s0.elapsed_time(s1) / reps
    torch.cuda._sleep(int(1.5 * wall * 1e-3 * reps * GPU_CYCLES_PER_S)
                      + 1_000_000)
    pairs = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return (float(np.median([e0.elapsed_time(e1) for e0, e1 in pairs])),
            wall, stream)


def bound_ms(n_bytes: float, n_ops: float,
             peak: str = "fp32") -> tuple[float, str]:
    """The least time for the bytes at HBM's rate and the operations at
    the peak rate of their kind (``OPS_PER_S[peak]``), and which binds."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fma_bound(terms) -> torch.Tensor:
    """4·eps·Σ|term|: the multiply-add tolerance, elementwise."""
    return 4 * EPS * sum(t.abs() for t in terms)


def max_ulp(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place (same-sign floats)."""
    return int((a.view(torch.int32).long()
                - b.view(torch.int32).long()).abs().max())


class Check:
    """Collects comparison verdicts; a phase fails on any False."""

    def __init__(self):
        self.failures: list[str] = []

    def exact(self, what, got, want):
        if not torch.equal(got, want):
            self.failures.append(f"{what}: not bit-exact (max |Δ| "
                                 f"{float((got - want).abs().max()):.3e})")

    def within(self, what, got, want, bound):
        bad = int(((got - want).abs() > bound).sum())
        if bad:
            self.failures.append(f"{what}: {bad} elements outside "
                                 f"the stated tolerance")

    def shaped(self, what, got, shape):
        if tuple(got.shape) != tuple(shape) or not bool(
                torch.isfinite(got).all()):
            self.failures.append(f"{what}: shape {tuple(got.shape)} != "
                                 f"{tuple(shape)} or non-finite values")

    def true(self, what, cond):
        if not cond:
            self.failures.append(what)


#: the CUDA sources' build report, filled by :func:`cuda_report` once the
#: sources are built: stem → {"nvcc_seconds", "kernels": {name: usage}};
#: for flashattn also "hgmma", each kernel's HGMMA count in its SASS
CUDA_REPORT: dict = {}


def kernel_name(demangled: str) -> str:
    """``k3_scan_kernel<float>`` from cu++filt's
    ``void (anonymous namespace)::k3_scan_kernel<float>(float const*, …)``
    (``k8_flash_wgmma<128>`` from ``…k8_flash_wgmma<(int)128>(…)``)."""
    depth = 0
    for i in range(len(demangled) - 1, -1, -1):    # drop the parameters
        depth += {")": 1, "(": -1}.get(demangled[i], 0)
        if depth == 0:
            demangled = demangled[:i] if demangled[i] == "(" else demangled
            break
    return demangled.rsplit("::", 1)[-1].removeprefix("void ").replace(
        "(int)", "")


def kernel_names(mangled) -> dict[str, str]:
    """Mangled kernel name → :func:`kernel_name`, through cu++filt (beside
    nvcc)."""
    mangled = sorted(set(mangled))
    filt = Path(_cuda.nvcc()).with_name("cu++filt")
    out = subprocess.run([str(filt), *mangled], capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return {m: kernel_name(d) for m, d in zip(mangled, out, strict=True)}


def cuda_report() -> dict:
    """Per CUDA source built in this process: nvcc's seconds and each
    kernel's registers, shared memory and spills (``-Xptxas -v``); and
    the HGMMA instructions in each K8 kernel's SASS."""
    for stem, info in _cuda.BUILD_LOG.items():
        usage = _cuda.ptxas_usage(info["ptxas"])
        names = kernel_names(usage)
        CUDA_REPORT[stem] = {
            "nvcc_seconds": info["seconds"],
            "kernels": {names[k]: u for k, u in usage.items()}}
    cuobjdump = Path(_cuda.nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(_cuda.library_path("flashattn"))],
        capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    names = kernel_names(counts)
    CUDA_REPORT.setdefault("flashattn", {})["hgmma"] = {
        names[k]: n for k, n in counts.items()}
    return CUDA_REPORT


def entry(case, launches, err, timed, plain, n_bytes, n_ops, library,
          kernel="K1", peak="fp32", **extra):
    """One ``kernels`` row; ``timed``/``plain``/``library`` come from
    :func:`time_ms` (library may be None); ``peak`` names the operations'
    rate in the bound."""
    b, by = bound_ms(n_bytes, n_ops, peak)
    route, source, replaces = KERNELS[kernel]
    row = {"name": f"{kernel} {case}", "route": route, "source": source,
           "replaces": replaces, "launches": launches,
           "max_abs_err": err, "ms": timed[0], "plain_ms": plain[0],
           "bound_ms": b, "bound_by": by, "ops_peak": peak,
           "ops_per_s": OPS_PER_S[peak],
           "library_ms": None if library is None else library[0],
           "wall_ms": timed[1], "stream_ms": timed[2], "bytes": n_bytes,
           "gb_per_s": n_bytes / timed[0] / 1e6}
    row.update(extra)
    return row


def max_abs(a, b) -> float:
    return float((a - b).abs().max())


# ---------------------------------------------------------------------------
# K1's former solo kernel in place of the new one ("was")
# ---------------------------------------------------------------------------

class _WasK1:
    """Stands in for ``fused_kernel.K1`` while a solo path runs on the
    former kernel (``experiments/former_kernels.py``): ``compile`` hands
    the chain itself to the launch, and a launch pads a flat operand to
    whole blocks (the former path's copy, where the tail is ragged), runs
    the former kernel and cuts the outputs back to ``n``. Not counted."""

    item_copies = 0

    @staticmethod
    def compile(stages, n_ext, batch: bool = False, ragged: bool = False):
        if batch:
            raise ValueError("the former solo kernel has no batch route")
        return (stages, n_ext), False

    def __call__(self, kernel, table, vectors, n_out, block_rows,
                 block_cols, out_specs=None):
        import former_kernels as former
        stages, n_ext = kernel
        v0 = vectors[0]
        flat = v0.ndim == 1
        vecs = ([flatten_to_blocks(v, block_cols, block_rows)[0]
                 for v in vectors] if flat else list(vectors))
        outs = former.k1_solo(stages, n_ext, table, vecs, n_out, block_rows,
                              block_cols, out_specs)
        return [o.reshape(-1)[:v0.numel()] for o in outs] if flat else outs


@contextlib.contextmanager
def former_k1(programs):
    """Inside: the solo launches of ``programs`` (their launch closures
    rebuilt on entry and on exit) go to the former kernel."""
    saved = fk.K1
    for prog in programs:
        prog._exe_cache.clear()
    fk.K1 = _WasK1()
    try:
        yield
    finally:
        fk.K1 = saved
        for prog in programs:
            prog._exe_cache.clear()


def k1_was_new(check, label: str, call, programs, reps: int = 20) -> dict:
    """``call()`` (a solo K1 path) on the new kernel against the same call
    on the former kernel: bit for bit, then timed in turns, was, new,
    new, was. Returns the row's fields: ``timed`` (new's :func:`time_ms`
    triple, the mean of its two runs) and the was fields."""
    got = outputs(call())
    with former_k1(programs):
        was = outputs(call())
    same = len(got) == len(was) and all(same_bits(g, w)
                                        for g, w in zip(got, was))
    check.true(f"{label}: K1's solo kernel not bit-identical to the former "
               f"kernel's", same)
    del got, was

    def timed(former: bool):
        with former_k1(programs) if former else contextlib.nullcontext():
            return time_ms(call, reps)

    w1, n1, n2, w2 = timed(True), timed(False), timed(False), timed(True)
    return {"timed": tuple((u + v) / 2 for u, v in zip(n1, n2)),
            "was_ms": (w1[0] + w2[0]) / 2, "was_wall_ms": (w1[1] + w2[1]) / 2,
            "new_ms_runs": [n1[0], n2[0]], "was_ms_runs": [w1[0], w2[0]],
            "bit_identical_to_was": same}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

A_TEMPLATES = {"c0_copy": stream_copy.COPY, "c0_scale": stream_copy.SCALE,
               "c0_add": stream_copy.ADD, "c0_triad": stream_copy.TRIAD}


def run_phase_a(dev, check, rows):
    a, b = make_inputs(SEED, [N_STREAM, N_STREAM], dev)
    n = N_STREAM
    library = {"c0_copy": lambda out=torch.empty_like(a): out.copy_(a),
               "c0_scale": lambda: torch.mul(a, SCALE),
               "c0_add": lambda: torch.add(a, b),
               "c0_triad": lambda: torch.add(a, b, alpha=TRIAD_S)}
    for case, (call, bytes_per, ops_per) in A_CASES.items():
        K1.launches = 0
        got = call(a, b, "kernel")
        launches = K1.launches
        check.true(f"A {case}: {launches} launches, want 1", launches == 1)
        plain = call(a, b, "interpret")
        ref = call(a, b, "ref")
        check.shaped(f"A {case}", got, a.shape)
        if case == "c0_triad":
            bound = fma_bound((a, TRIAD_S * b))
            check.within(f"A {case} kernel vs emulator", got, plain, bound)
            check.within(f"A {case} kernel vs ref", got, ref, bound)
        else:
            check.exact(f"A {case} kernel vs emulator", got, plain)
            check.exact(f"A {case} kernel vs ref", got, ref)
        err, err_ref = max_abs(got, plain), max_abs(got, ref)
        del got, plain, ref
        was = k1_was_new(check, f"A {case}", lambda: call(a, b, "kernel"),
                         [A_TEMPLATES[case].program()])
        rows.append(entry(
            f"A {case}", launches, err, was.pop("timed"),
            time_ms(lambda: call(a, b, "interpret")),
            bytes_per * n, ops_per * n, time_ms(library[case]),
            max_abs_err_ref=err_ref, **was))
    del a, b
    # a ragged operand: the solo kernel masks the tail where the former
    # path padded both operands by a copy first
    a, b = make_inputs(SEED + 14, [N_RAGGED_SOLO, N_RAGGED_SOLO], dev)
    n = N_RAGGED_SOLO
    K1.launches = 0
    got = ops.stream_add(a, b, mode="kernel")
    launches = K1.launches
    check.true(f"A c0_add ragged: {launches} launches, want 1",
               launches == 1)
    plain = ops.stream_add(a, b, mode="interpret")
    check.shaped("A c0_add ragged", got, a.shape)
    check.exact("A c0_add ragged kernel vs emulator", got, plain)
    check.exact("A c0_add ragged kernel vs torch.add", got, torch.add(a, b))
    del got, plain
    was = k1_was_new(check, "A c0_add ragged",
                     lambda: ops.stream_add(a, b, mode="kernel"),
                     [stream_copy.ADD.program()])
    rows.append(entry(
        f"A c0_add ragged (n = 2^26 - 1000)", launches, 0.0,
        was.pop("timed"),
        time_ms(lambda: ops.stream_add(a, b, mode="interpret")),
        12 * n, n, time_ms(lambda: torch.add(a, b)),
        was_is="the former path: both operands padded by a copy, the "
               "former kernel, the output cut to n", **was))
    del a, b


def run_phase_b(dev, check, rows):
    x, b = make_inputs(SEED + 1, [N_STREAM, N_STREAM], dev)
    n = N_STREAM
    bound = fma_bound((SCALE * x, b))
    for names in (("c0_scale", "c0_add"), ("c0_scale", "c0_add", "c0_copy")):
        fused = isa.fuse(*names)
        case = "+".join(names)
        K1.launches = 0
        got = fused(SCALE, x, b, mode="kernel")
        launches = K1.launches
        check.true(f"B {case}: {launches} launches, want 1", launches == 1)
        plain = fused(SCALE, x, b, mode="interpret")
        ref = fused(SCALE, x, b, mode="ref")
        check.shaped(f"B {case}", got, x.shape)
        check.within(f"B {case} kernel vs emulator", got, plain, bound)
        check.within(f"B {case} kernel vs ref", got, ref, bound)
        err, err_ref = max_abs(got, plain), max_abs(got, ref)
        del got, plain, ref
        was = k1_was_new(check, f"B {case}",
                         lambda: fused(SCALE, x, b, mode="kernel"),
                         [fused.program])
        rows.append(entry(
            f"B {case}", launches, err, was.pop("timed"),
            time_ms(lambda: fused(SCALE, x, b, mode="interpret")),
            12 * n, 2 * n, time_ms(lambda: torch.add(b, x, alpha=SCALE)),
            max_abs_err_ref=err_ref,
            block=list(fused.program.negotiate_geometry(n, x.dtype)[:2]),
            **was))


def run_phase_c(dev, check, rows):
    arrays = make_inputs(SEED + 2, [N_ITEM] * (2 * N_ITEMS), dev)
    xs, bs = arrays[:N_ITEMS], arrays[N_ITEMS:]
    scalars = batch_scalars(N_ITEMS)
    fused = isa.fuse("c0_scale", "c0_add")
    prog = fused.program
    K1.launches = K1.item_copies = 0
    with prog_mod.dispatch_stats_window() as w:
        got = phase_c(xs, bs, interpret=False)
        mixed = w.delta("batch_mixed")
    launches, copies = K1.launches, K1.item_copies
    check.true(f"C: {launches} launches for one batch, want 1",
               launches == 1)
    check.true(f"C: batch_mixed moved by {mixed}, want 1", mixed == 1)
    check.true(f"C: {copies} items copied, want 0", copies == 0)
    check.true("C: results share storage", len(
        {o.untyped_storage().data_ptr() for o in got}) == N_ITEMS)
    plain = phase_c(xs, bs, interpret=True)
    errs = []
    for k, (s, x, b) in enumerate(zip(scalars, xs, bs)):
        check.shaped(f"C item {k}", got[k], x.shape)
        check.exact(f"C item {k} batch vs solo kernel", got[k],
                    fused(s, x, b, mode="kernel"))
        check.within(f"C item {k} kernel vs emulator", got[k], plain[k],
                     fma_bound((s * x, b)))
        check.within(f"C item {k} kernel vs ref", got[k],
                     fused(s, x, b, mode="ref"), fma_bound((s * x, b)))
        errs.append(max_abs(got[k], plain[k]))
    del got, plain
    # one batch in the profiler: K1 once, and no copy, cat or pad kernel
    kernels = device_kernels(lambda: phase_c(xs, bs, interpret=False))
    if kernels is not None:
        names = [name for name, _ in kernels]
        check.true(f"C: the batch ran {names}, want one k1_batch_kernel",
                   len(names) == 1 and "k1_batch_kernel" in names[0])
    n = N_ITEM * N_ITEMS
    # the launch alone, on the items in place (the scalar and offset
    # tables included)
    br, bc = prog.negotiate_geometry(N_ITEM, xs[0].dtype)[:2]
    per_item = [[x, b] for x, b in zip(xs, bs)]
    launch_ms = time_ms(lambda: prog.call_items(
        [[s] for s in scalars], per_item, block_rows=br, block_cols=bc))[0]
    x2, b2 = torch.stack(xs), torch.stack(bs)
    s2 = torch.tensor(scalars, device=dev).reshape(N_ITEMS, 1)
    rows.append(entry(
        "C call_batch 16x scale+add", launches, max(errs),
        time_ms(lambda: phase_c(xs, bs, interpret=False)),
        time_ms(lambda: phase_c(xs, bs, interpret=True)),
        12 * n, 2 * n, time_ms(lambda: torch.addcmul(b2, x2, s2)),
        launch_ms=launch_ms, block=[br, bc], item_copies=copies,
        device_kernels=kernels))
    del x2, b2, arrays, xs, bs, per_item
    # a ragged batch (the tail of each item masked), one item misaligned
    # by 4 bytes (copied alone): every item as its solo launch
    arrays = make_inputs(SEED + 11, [N_RAGGED + 1] + [N_RAGGED] *
                         (2 * N_ITEMS - 1), dev)
    xs = [arrays[0][1:]] + arrays[1:N_ITEMS]          # storage offset 1
    bs = arrays[N_ITEMS:]
    K1.launches = K1.item_copies = 0
    got = phase_c(xs, bs, interpret=False)
    check.true(f"C ragged: {K1.launches} launches, want 1",
               K1.launches == 1)
    check.true(f"C ragged: {K1.item_copies} items copied, want 1 (the "
               f"misaligned one)", K1.item_copies == 1)
    for k, (s, x, b) in enumerate(zip(scalars, xs, bs)):
        check.shaped(f"C ragged item {k}", got[k], x.shape)
        check.exact(f"C ragged item {k} batch vs solo kernel", got[k],
                    fused(s, x, b, mode="kernel"))
    rows[-1]["ragged_batch"] = {"n": N_RAGGED, "items": N_ITEMS,
                                "item_copies": K1.item_copies,
                                "ms": time_ms(lambda: phase_c(
                                    xs, bs, interpret=False))[0]}


def run_phase_d(dev, check, rows):
    (x,) = make_inputs(SEED + 3, [ABSMAX_SHAPE], dev)
    register_absmax()
    K1.launches = 0
    got = phase_d(x, "kernel")
    launches = K1.launches
    check.true(f"D: {launches} launches, want 1", launches == 1)
    plain = phase_d(x, "interpret")
    ref = phase_d(x, "ref")
    check.shaped("D c7_absmax_scale", got, x.shape)
    ulp_plain, ulp_ref = max_ulp(got, plain), max_ulp(got, ref)
    check.true(f"D kernel vs emulator: {ulp_plain} ulp > 2", ulp_plain <= 2)
    check.true(f"D kernel vs ref: {ulp_ref} ulp > 2", ulp_ref <= 2)
    check.exact("D emulator vs ref", plain, ref)
    n = x.numel()
    err, err_ref = max_abs(got, plain), max_abs(got, ref)
    del got, plain, ref
    was = k1_was_new(check, "D c7_absmax_scale",
                     lambda: phase_d(x, "kernel"), [ABSMAX.program()])
    rows.append(entry(
        "D c7_absmax_scale", launches, err, was.pop("timed"),
        time_ms(lambda: phase_d(x, "interpret")),
        8 * n, 3 * n, None, max_abs_err_ref=err_ref,
        max_ulp_vs_plain=ulp_plain, max_ulp_vs_ref=ulp_ref,
        block=[ABSMAX.block_rows, ABSMAX.block_cols], **was))
    del x
    # the same program's coalesced batch: 4 ragged items, each as its
    # solo call (the carry runs along a row; only a tail is masked)
    prog = ABSMAX.program()
    items = [(t,) for t in make_inputs(SEED + 12, [CARRIED_ITEM] * 4, dev)]
    K1.launches = 0
    got = prog.call_batch(items)
    check.true(f"D batch: {K1.launches} launches, want 1",
               K1.launches == 1)
    for k, ((x,), out) in enumerate(zip(items, got)):
        check.shaped(f"D batch item {k}", out, x.shape)
        check.exact(f"D batch item {k} vs solo kernel", out, prog(x))


def run_phase_e(dev, check, rows):
    v = sort_keys(SEED + 4, N_SORT, dev)
    K5.launches = K6.launches = 0
    with Tap(sn, "K6", record=lambda args, kw, out: args[2]) as level:
        got = phase_e(v, "kernel")
    launches = {"K5": K5.launches, "K6": K6.launches}
    check.true(f"E: {launches['K5']} K5 launches, want 1",
               launches["K5"] == 1)
    check.true(f"E: {launches['K6']} K6 launches, want 9",
               launches["K6"] == 9)
    check.exact("E mergesort app vs torch.sort", got, torch.sort(v).values)
    check.true(f"E: K6 ran at widths {level.calls}, want one launch at "
               f"each of {list(MERGE_WIDTHS)}",
               level.calls == list(MERGE_WIDTHS))
    del got
    app = time_ms(lambda: phase_e(v, "kernel"), reps=10)
    lib = time_ms(lambda: torch.sort(v), reps=10)
    print(f"E sortnet mergesort (c2+c1): {app[0]:.4f} ms device, "
          f"{app[1]:.4f} ms wall; torch.sort(v): {lib[0]:.4f} ms device; "
          f"ratio {lib[0] / app[0]:.3f}x", flush=True)
    app_row = {"app_ms": app[0], "app_wall_ms": app[1],
               "app_torch_sort_ms": lib[0],
               "app_device_ms_by_kind": device_ms_by_kind(
                   lambda: phase_e(v, "kernel"), APP_KINDS)}
    # K5 at the app's shape, and at other widths (one instance each); those
    # are not on the app's path, so their launches are those of their own
    # call
    f32 = make_inputs(SEED + 5, [N_SORT], dev)[0]
    cases = [("int32 w8 (app)", v[None], 8)] + [
        (f"{dt} w{w}", f32[None] if dt == "float32"
         else f32.to(torch.bfloat16)[None], w) for dt, w in K5_WIDTHS]
    for case, x, width in cases:
        on_app = case.endswith("(app)")
        K5.launches = 0
        got = sn.sort_chunks_kernel(x, width=width)
        own = K5.launches
        plain = sn.sort_chunks_kernel(x, width=width, interpret=True)
        check.exact(f"E K5 {case} kernel vs plain", got, plain)
        check.exact(f"E K5 {case} kernel vs ref", got,
                    ref.sort_chunks(x, width))
        n = x.numel()
        rows.append(entry(
            f"E sort_chunks {case}", launches["K5"] if on_app else own,
            max_abs(got, plain),
            time_ms(lambda: sn.sort_chunks_kernel(x, width=width)),
            time_ms(lambda: sn.sort_chunks_kernel(x, width=width,
                                                  interpret=True), reps=5),
            2 * n * x.element_size(), sn.n_cas_layers(width) * n,
            time_ms(lambda: torch.sort(x.view(-1, width))), kernel="K5",
            width=width, dtype=str(x.dtype).removeprefix("torch."),
            launches_counted_in="main path" if on_app else "own call",
            **(app_row if on_app else {})))
        del got, plain
    del f32
    # K6 alone at each level of the app, on the level's own operands
    for w in MERGE_WIDTHS:
        x = torch.sort(v.view(-1, w)).values.view(-1, 2, w)
        a, b = x[:, 0], x[:, 1]
        lo, hi = sn.merge_sorted_kernel(a, b, width=w)
        plo, phi = sn.merge_sorted_kernel(a, b, width=w, interpret=True)
        rlo, rhi = ref.merge_sorted(a, b, w)
        for half, got, plain, want in (("lo", lo, plo, rlo),
                                       ("hi", hi, phi, rhi)):
            check.exact(f"E K6 w={w} {half} kernel vs plain", got, plain)
            check.exact(f"E K6 w={w} {half} kernel vs ref", got, want)
        n = x.numel()
        rows.append(entry(
            f"E merge_sorted int32 w{w}", level.calls.count(w),
            max(max_abs(lo, plo), max_abs(hi, phi)),
            time_ms(lambda: sn.merge_sorted_kernel(a, b, width=w)),
            time_ms(lambda: sn.merge_sorted_kernel(a, b, width=w,
                                                   interpret=True), reps=5),
            # a merge of 2w keys: log2(2w) layers, one compare a key
            2 * n * x.element_size(), ((2 * w).bit_length() - 1) * n,
            time_ms(lambda: torch.sort(x.view(-1, 2 * w))), kernel="K6",
            width=w, launches_counted_in="main path"))
        del x, a, b, lo, hi, plo, phi, rlo, rhi


APP_KINDS = (("K5", "k5_sort"), ("K6", "k6_merge"), ("cat", "CatArray"),
             ("torch.sort", "sort"))   # kind: what its kernels' names hold
LM_KINDS = (("K8", "k8_flash"), ("K7", "k7_topk"), ("K3", "k3_"),
            ("K4", "k4_"),
            ("matmul", "gemm"), ("matmul", "nvjet"), ("matmul", "xmma"),
            ("matmul", "cutlass"), ("index", "index"),
            ("cat", "CatArray"), ("elementwise", "elementwise"),
            ("reduce", "reduce"))


def device_events(fn, wall: list | None = None
                  ) -> list[tuple[str, float]] | None:
    """(name, device ms) of each device event (kernels, copies, fills) of
    one call of ``fn`` in a ``torch.profiler`` trace, in the order they
    started; None when the
    profiler sees no device time. The program's spans, which the profiler
    also draws on the device's timeline as user annotations, are no
    device work and are left out. The trace runs a warm-up call first and
    keeps only the second: a launch right after the trace starts can be
    missing from it (K5, the mergesort app's first kernel, was). Each
    call also sits between two spin kernels of ~5 ms, left out of the
    result: a trace of a few microseconds of device work came back empty
    on the H100 (the router's top-k, and a cat of the same size, once
    phase E's app trace had run), and the same work inside ~10 ms of
    spinning comes back whole. With ``wall``, the leading spin is waited
    out before the call, and the kept call's host-clock ms, from its
    first enqueue to the device's end, is appended to it: the wall of
    the traced run itself (the profiler's host overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    events = []

    def keep(prof):          # in the order the device ran them
        events.extend((e.name, e.device_time_total / 1e3) for e in sorted(
            (e for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and not e.is_user_annotation
             and not e.name.startswith("ProfilerStep")
             and "spin_kernel" not in e.name),
            key=lambda e: e.time_range.start))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=keep) as prof:
        for _ in range(2):
            torch.cuda._sleep(SPIN_CYCLES)
            if wall is not None:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            if wall is not None:
                torch.cuda.synchronize()
                took = (time.perf_counter() - t0) * 1e3
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            prof.step()
    if wall is not None:
        wall.append(took)
    if not any(ms for _, ms in events):
        print("torch.profiler saw no device time: breakdown not measured",
              file=sys.stderr)
        return None
    return events


def device_kernels(fn) -> list[tuple[str, float]] | None:
    """The kernels among :func:`device_events` (not a memcpy or memset)."""
    events = device_events(fn)
    if events is None:
        return None
    return [(name, ms) for name, ms in events
            if not name.startswith(("Memcpy", "Memset"))]


def device_ms_by_kind(fn, kinds) -> dict | None:
    """Device ms of one call of ``fn`` from ``torch.profiler``, summed over
    the events whose name holds each kind's word (case-insensitive; the
    first kind that matches wins; the rest is "other"); None when the
    profiler sees no device time."""
    events = device_events(fn)
    return None if events is None else ms_by_kind(events, kinds)


def top_events(events, n: int = 10, width: int = 160) -> list:
    """The ``n`` event names with the most device ms, each name cut to
    ``width`` characters: [[name, ms, count], ...]."""
    total: dict = {}
    for name, t in events:
        ms, k = total.get(name, (0.0, 0))
        total[name] = (ms + t, k + 1)
    return [[name[:width], ms, k] for name, (ms, k) in
            sorted(total.items(), key=lambda it: -it[1][0])[:n]]


def ms_by_kind(events, kinds) -> dict:
    """:func:`device_ms_by_kind` of recorded events."""
    ms = {kind: 0.0 for kind, _ in kinds} | {"other": 0.0}
    for name, t in events:
        kind = next((k for k, word in kinds if word.lower() in name.lower()),
                    "other")
        ms[kind] += t
    return ms


def run_phase_f(dev, check, rows):
    (x,) = make_inputs(SEED + 6, [N_SCAN], dev)
    K3.launches = 0
    got = phase_f(x, "kernel")
    launches = K3.launches
    check.true(f"F: {launches} K3 launches, want 1", launches == 1)
    check.shaped("F prefix_sum", got, x.shape)
    plain = phase_f(x, "interpret")
    br, bc = ps.block_shape(1, N_SCAN)
    ref64 = torch.cumsum(x.double(), 0)
    abs64 = torch.cumsum(x.abs().double(), 0)
    bad, worst = prefix_bound_misses(
        got, ref64, abs64, bc, *ps.k3_bound_constants(x.dtype, N_SCAN))
    check.true(f"F K3: {bad} elements outside the summation bound", bad == 0)
    bad_p, _ = prefix_bound_misses(plain, ref64, abs64, bc,
                                   *ps.walk_bound_constants(N_SCAN))
    check.true(f"F plain: {bad_p} elements outside the summation bound",
               bad_p == 0)
    del ref64, abs64
    err = max_abs(got, plain)
    check.true(f"F K3 vs plain: max |Δ| {err:.3e} > {K3_PLAIN_LIMIT}",
               err <= K3_PLAIN_LIMIT)
    lib = torch.cumsum(x, 0)
    rel = float((got - lib).abs().max() / (lib.abs().max() + 1e-9))
    print(f"F c3_prefixsum: rel err {rel:.3e} against torch.cumsum",
          flush=True)
    rows.append(entry(
        "F prefix_sum (1, 2^26) float32", launches, err,
        time_ms(lambda: phase_f(x, "kernel")),
        time_ms(lambda: phase_f(x, "interpret"), reps=5),
        8 * N_SCAN, N_SCAN, time_ms(lambda: torch.cumsum(x, 0)),
        kernel="K3", block=[br, bc], max_abs_err_f64=worst,
        rel_err_vs_cumsum=rel))


def materialised(a, states):
    """The operands of K4's contiguous-rows entry for the same scan: the
    decay broadcast to state rank and both moved so the chunks are the
    last axis, as (rows, chunks) copies."""
    chunks = states.shape[1]
    return (torch.movedim(a[..., None, None].expand(states.shape), 1,
                          -1).reshape(-1, chunks),
            torch.movedim(states, 1, -1).reshape(-1, chunks))


def rows_entry_statescan(a, states, reverse: bool = False):
    """The state scan through K4's contiguous-rows entry on the
    materialised operands, moved back to the states' layout."""
    ab, bb = materialised(a, states)
    out = ps.chunk_scan_kernel(ab, bb, reverse=reverse).reshape(
        torch.movedim(states, 1, -1).shape)
    return torch.movedim(out, -1, 1)


def was_new(new, was, reps: int = 20) -> tuple[tuple, tuple, dict]:
    """(new's, was's :func:`time_ms` triples, the four device readings):
    the two timed in turns, was, new, new, was, in one call on one card;
    each triple the mean of its two runs."""
    w1, n1, n2, w2 = (time_ms(was, reps), time_ms(new, reps),
                      time_ms(new, reps), time_ms(was, reps))

    def mean(x, y):
        return tuple((u + v) / 2 for u, v in zip(x, y))

    return mean(n1, n2), mean(w1, w2), {"new_ms_runs": [n1[0], n2[0]],
                                        "was_ms_runs": [w1[0], w2[0]]}


def k4_row(check, label: str, a, states, launches: int, what: str,
           counted_in: str, reverse: bool = False, **extra) -> dict:
    """K4's state-scan entry at one shape (``reverse``: the backward's
    walk from the last chunk, under the decay it is given), against:
    its plain walk bit for bit and, with it, float64 at the fold's bound
    (the reverse walk on flipped chunks); the contiguous-rows entry on
    the materialised operands bit for bit (up to 64 chunks the two
    entries fold alike); the former Gluon kernel ("was",
    ``experiments/former_kernels.py``) within the bound of its tree scan.
    Times was, new, new, was; returns the ``kernels`` row."""
    import former_kernels as former
    flip = (lambda t: t.flip(1)) if reverse else (lambda t: t)
    got = K4.state_scan(a, states, 1, reverse)
    plain = ps.chunk_scan_state_kernel(a, states, 1, interpret=True,
                                       reverse=reverse)
    worst = hold_statescan(check, f"{label} K4", flip(got), flip(plain),
                           flip(a), flip(states))
    err = max_abs(got, plain)
    del plain
    same = torch.equal(got, rows_entry_statescan(a, states, reverse))
    check.true(f"{label} K4: the state entry is not bit-identical to the "
               f"rows entry on the materialised operands", same)
    was = former.k4_state_scan(a, states, 1, reverse)
    bad_was, worst_was = statescan_bound_misses(flip(was), flip(a),
                                                flip(states), was=True)
    check.true(f"{label} K4 was: {bad_was} elements outside its bound",
               bad_was == 0)
    del got, was
    new_t, was_t, runs = was_new(
        lambda: K4.state_scan(a, states, 1, reverse),
        lambda: former.k4_state_scan(a, states, 1, reverse))
    n = states.numel()
    return entry(
        f"{label} {what} {tuple(states.shape)} float32 in place",
        launches, err, new_t,
        time_ms(lambda: ps.chunk_scan_state_kernel(
            a, states, 1, interpret=True, reverse=reverse), reps=3),
        8 * n + 4 * a.numel(), 2 * n, None, kernel="K4",
        walk=ps.state_walk(n // (states.shape[0] * states.shape[1]
                                 * states.shape[2]), states.shape[1], 4),
        max_abs_err_f64=worst, entries_bit_identical=same,
        was_ms=was_t[0], was_wall_ms=was_t[1], was_max_abs_err_f64=worst_was,
        **runs, launches_counted_in=counted_in, **extra)


#: K4's rows entry at a few long rows (off the model paths: c4_chunkscan
#: and ChunkScanFn), past 64 columns: the former Gluon kernel, kept
K4_ROWS_SHAPES = [(3, 5000), (8, 1024)]


def k4_rows_row(check, label: str, a, b, counted_in: str, **extra) -> dict:
    """K4's contiguous-rows entry on (rows, cols) operands. Up to 64
    columns (``k4_rows_kernel``, the fold): bit for bit to its plain
    walk, within the fold's bound of float64, timed against the former
    Gluon kernel ("was", ``prefix_scan.gluon_chunk_scan``, within the
    bound of its tree) in turns, was, new, new, was. Past them (the Gluon
    kernel kept): it and its plain walk within
    ``prefix_scan.k4_rows_bound_steps``, timed alone. Returns the
    ``kernels`` row."""
    n_rows, cols = a.shape
    fold = cols <= ps.K4_FOLD_COLS

    def gluon():
        return ps.gluon_chunk_scan(a, b, torch.empty_like(a))

    got = ps.chunk_scan_kernel(a, b)
    plain = ps.chunk_scan_kernel(a, b, interpret=True)
    if fold:
        check.exact(f"{label} K4 rows entry {tuple(a.shape)} vs plain", got,
                    plain)
    outs = {"K4": got, "plain": plain}
    if fold:
        outs["was"] = gluon()
    n_c = ps.block_shape(n_rows, cols)[1]
    y = torch.zeros(n_rows, dtype=torch.float64, device=a.device)
    s = torch.zeros_like(y)
    bad = {key: torch.zeros((), dtype=torch.int64, device=a.device)
           for key in outs}
    worst = {key: torch.zeros((), dtype=torch.float64, device=a.device)
             for key in outs}
    for c in range(cols):
        y = a[:, c].double() * y + b[:, c].double()
        s = s + b[:, c].double().abs()
        for key, out in outs.items():
            k = (fold_steps(c, n_c, was=True) if key == "was"
                 else ps.k4_rows_bound_steps(c, n_rows, cols))
            err = (out[:, c].double() - y).abs()
            bad[key] += (err > k * EPS * s).sum()
            worst[key] = torch.maximum(worst[key], err.max())
    for key in bad:
        check.true(f"{label} K4 rows entry {tuple(a.shape)} {key}: "
                   f"{int(bad[key])} elements outside the summation bound",
                   int(bad[key]) == 0)
    err = max_abs(got, plain)
    del got, plain, outs
    runs = {}
    if fold:
        new_t, was_t, runs = was_new(lambda: ps.chunk_scan_kernel(a, b),
                                     gluon)
        runs.update(was_ms=was_t[0], was_wall_ms=was_t[1],
                    was_max_abs_err_f64=float(worst["was"]))
    else:
        new_t = time_ms(lambda: ps.chunk_scan_kernel(a, b))
    n = a.numel()
    return entry(
        f"{label} rows entry {tuple(a.shape)} float32", 0, err, new_t,
        time_ms(lambda: ps.chunk_scan_kernel(a, b, interpret=True), reps=3),
        12 * n, 2 * n, None, kernel="K4" if fold else "K4 rows",
        rows_kernel="k4_rows_kernel" if fold else "gluon k4_chunk_scan",
        max_abs_err_f64=float(worst["K4"]),
        plain_max_abs_err_f64=float(worst["plain"]), **runs,
        launches_counted_in=counted_in, **extra)


def run_phase_g(dev, check, rows):
    a, states = ssd_inputs(SEED + 7, SSD_SHAPE, SSD_STATE, dev)
    K4.launches = 0
    got = phase_g(a, states, "kernel")
    launches = K4.launches
    check.true(f"G: {launches} K4 launches, want 1", launches == 1)
    check.shaped("G chunk_scan_state", got, states.shape)
    del got
    call = time_ms(lambda: phase_g(a, states, "kernel"))
    rows.append(k4_row(check, "G", a, states, launches,
                       "chunk_scan_state", "phase G's call",
                       call_ms=call[0], call_wall_ms=call[1]))
    # the rows entry: on G's operands materialised as (rows, chunks), and
    # on a few long rows; no model path runs it
    off = "no main path (c4_chunkscan, ChunkScanFn)"
    ab, bb = materialised(a, states)
    del states
    rows.append(k4_rows_row(check, "G", ab, bb, off))
    del ab, bb
    for i, shape in enumerate(K4_ROWS_SHAPES):
        a2, b2 = ssd_inputs(SEED + 50 + i, shape, (), dev)
        rows.append(k4_rows_row(check, "G", a2, b2, off))


def hold_attention(check, what, q, k, v, out, plain=None):
    """K8's ``out`` against its plain version and the oracle (see the
    tolerances); returns the row's error fields."""
    plain = fa.flash_attention_plain(q, k, v) if plain is None else plain
    bound = attn_bound(q, k, v)
    res = {}
    for name, want in (("plain", plain), ("oracle", oracle_attention(q, k, v))):
        bad, err, over = attn_misses(out, want, bound)
        check.true(f"{what} vs {name}: {bad} elements outside the bound",
                   bad == 0)
        res[f"max_abs_err_{name}"] = err
        res[f"over_one_bf16_ulp_{name}"] = over
        print(f"{what} vs {name}: max |Δ| {err:.3e}, {bad} outside the "
              f"bound" + ("" if over is None else
                          f", {over} beyond one bf16 ulp"), flush=True)
    return res


def hold_f64(check, what, q, k, v, out, plain, noise: float = 0.0) -> dict:
    """K8's bf16 ``out`` against the float64 result (see the tolerances):
    every element within its own bound, and no more elements beyond one
    bf16 ulp of it than ``plain`` has, give or take ``noise`` standard
    deviations of that difference (√ of the elements beyond one ulp for
    one of the two alone)."""
    res = attn_f64_misses(out, plain, q, k, v)
    got = res["over_one_bf16_ulp_f64"]
    want = res["plain_over_one_bf16_ulp_f64"]
    slack = noise * math.sqrt(res["over_alone"] + res["plain_over_alone"])
    print(f"{what}: {got} elements beyond one bf16 ulp of the float64 "
          f"result, the plain version {want} (allowed {want + slack:.1f}); "
          f"{res['outside_element_bound_f64']} outside their bound",
          flush=True)
    check.true(f"{what}: {res['outside_element_bound_f64']} elements "
               f"outside their bound against float64",
               res["outside_element_bound_f64"] == 0)
    check.true(f"{what}: {got} elements beyond one bf16 ulp of the float64 "
               f"result, more than the plain version's {want} + "
               f"{slack:.1f}", got <= want + slack)
    return res


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit (NaN included), through an integer view."""
    view = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def special_topk_rows(seed: int, shape, dtype, device) -> torch.Tensor:
    """Rows of float32 bit patterns (bfloat16: their upper half): row 0
    eight -0.0, eight +0.0, then -1.0; row 1 all NaN; row 2 all sign-bit
    NaN; the rest drawn from ±0.0, NaN of either sign, ±inf, ±1.0, 2.5."""
    rng = np.random.default_rng(seed)
    pool = np.array([0x80000000, 0x0, 0x7FC00000, 0xFFC00000, 0x7F800000,
                     0xFF800000, 0x3F800000, 0xBF800000, 0x40200000],
                    np.uint32)
    bits = rng.choice(pool, shape)
    bits[0] = 0xBF800000
    bits[0, :8], bits[0, 8:16] = 0x80000000, 0x0
    bits[1], bits[2] = 0x7FC00000, 0xFFC00000
    if dtype == torch.bfloat16:
        half = (bits >> 16).astype(np.uint16).view(np.int16)
        return torch.from_numpy(half).to(device).view(torch.bfloat16)
    return torch.from_numpy(bits.view(np.int32)).to(device).view(
        torch.float32)


def hold_topk(check, what, x, k, vals, idx, npow=None, plain=True):
    """K7's (vals, idx) of x (rows standing for rows of npow) against the
    oracle on the padded rows and, where ``plain``, the plain network."""
    xp = tk.pad_to(x, x.shape[1] if npow is None else npow)
    wants = [("oracle", ref.topk(xp, k))]
    if plain:
        wants.append(("plain", tk.topk_plain(xp, k)))
    for name, (wv, wi) in wants:
        check.true(f"{what} values vs {name}: not bit-exact",
                   same_bits(vals, wv))
        check.exact(f"{what} indices vs {name}", idx, wi)
    return max_abs(vals.float(), wants[-1][1][0].float()) if plain else 0.0


def topk_row(case, launches, err, x, k, npow, **extra):
    """One K7 row: the rows read once and k values and int32 indices
    written a row; one comparison a key."""
    return entry(
        case, launches, err, time_ms(lambda: tk.K7(x, k, npow)),
        time_ms(lambda: tk.topk_plain(tk.pad_to(x, npow), k), reps=5),
        x.numel() * x.element_size() + x.shape[0] * k * (x.element_size()
                                                         + 4),
        x.numel(), time_ms(lambda: torch.topk(x, k)), kernel="K7", k=k,
        npow=npow, **extra)


def run_phase_h(dev, check, rows):
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False
    cfg = lm_config()
    n_l = cfg.n_layers
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 8), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = serve_prompts(SEED + 9, cfg, LM_BATCH, LM_PROMPT, dev)

    # the main path: the server, with its launches counted
    with Tap(tk, "topk_kernel") as t7, Tap(fa, "K8") as t8, \
            Tap(serve, "sample") as ts:
        K3.launches = K7.launches = K8.launches = K8.aligned_copies = 0
        tokens, prefill_s, decode_s = phase_h(cfg, params, prompts, LM_GEN,
                                              "auto")
        launches = {"K3": K3.launches, "K7": K7.launches, "K8": K8.launches}
        k8_copies = K8.aligned_copies
    for name, want in (("K3", n_l * LM_GEN), ("K7", n_l * LM_GEN),
                       ("K8", n_l)):
        check.true(f"H: {launches[name]} {name} launches, want {want}",
                   launches[name] == want)
    check.true(f"H tokens: {tuple(tokens.shape)}, want ({LM_BATCH}, "
               f"{LM_GEN}) ids below {cfg.vocab}",
               tuple(tokens.shape) == (LM_BATCH, LM_GEN)
               and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()))
    logits = [args[0] for args, _, _ in ts.calls]
    check.true(f"H: {len(logits)} logits sampled, want {LM_GEN}",
               len(logits) == LM_GEN)
    for i, lg in enumerate(logits):
        check.shaped(f"H logits of step {i}", lg, (LM_BATCH, cfg.vocab))
    cold_s = (prefill_s, decode_s)       # the first run builds and loads
    again, prefill_s, decode_s = phase_h(cfg, params, prompts, LM_GEN, "auto")
    check.exact("H greedy tokens, run 2 vs run 1", again, tokens)

    # the kernels on the path's own inputs (the router's rows in place)
    (x7, k7), kw7, (v7, i7) = t7.calls[0]
    npow7 = kw7["npow"]
    check.true(f"H K7: router rows {tuple(x7.shape)} standing for "
               f"{npow7}, want {cfg.n_experts} in place",
               x7.shape[1] == cfg.n_experts and npow7 > x7.shape[1])
    err7 = hold_topk(check, "H K7 prefill", x7, k7, v7, i7, npow7)
    (xd, kd), _, (vd, idd) = t7.calls[n_l]
    errd = hold_topk(check, "H K7 decode", xd, kd, vd, idd, npow7)
    (q, kk, vv), kw8, o8 = t8.calls[0]
    plain8 = fa.flash_attention_plain(q, kk, vv, causal=kw8["causal"])
    res8 = hold_attention(check, "H K8 prefill layer 0", q, kk, vv, o8,
                          plain8)
    res8.update(hold_f64(check, "H K8 prefill layer 0", q, kk, vv, o8,
                         plain8))
    x3 = torch.nn.functional.one_hot(i7.reshape(-1).long(),
                                     cfg.n_experts).float().T.contiguous()
    got3 = ps.prefix_sum_kernel(x3)
    plain3 = ps.prefix_sum_kernel(x3, interpret=True)
    check.exact("H K3 vs plain", got3, plain3)
    check.exact("H K3 vs cumsum", got3, torch.cumsum(x3, 1))

    # the same request through the plain path (printed, not gated)
    with Tap(tk, "topk_kernel") as p7, Tap(serve, "sample") as psamp:
        plain_tokens = phase_h(cfg, params, prompts, LM_GEN, "interpret")[0]
    plain_path = {
        "max_abs_logit_diff_prefill": max_abs(logits[0],
                                              psamp.calls[0][0][0]),
        "routing_agreement_prefill": float(np.mean([
            routing_agreement(t7.calls[i][2][1], p7.calls[i][2][1])
            for i in range(n_l)])),
        "tokens_agree": bool(torch.equal(plain_tokens, tokens))}
    print(f"H plain path (not gated): {json.dumps(plain_path)}", flush=True)
    del p7, psamp, plain_tokens

    summary = {
        "phase": "H", "model": LM_ARCH, "reduced": LM_REDUCED,
        "batch": LM_BATCH, "prompt_len": LM_PROMPT, "gen": LM_GEN,
        "weight_bytes": weight_bytes(cfg), "init_s": init_s,
        "cold_prefill_wall_ms": cold_s[0] * 1e3,
        "cold_decode_wall_ms_per_token": cold_s[1] / (LM_GEN - 1) * 1e3,
        **serve_timings(cfg, params, prompts, LM_GEN,
                        [(prefill_s, decode_s)]),
        "launches": launches, "plain_path": plain_path,
        "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    print(json.dumps({"serve": summary}), flush=True)

    # kernel rows at the path's shapes: K7's launches on the path are
    # those of both shapes (one a layer in prefill and in each decode step)
    k7_rows = [topk_row(
        f"H topk {tuple(x.shape)} in place of {npow7} float32 k={k7} "
        f"(router, {case})", launches["K7"], err, x, k7, npow7,
        launches_counted_in="main path (prefill and decode)")
        for case, x, err in (("prefill", x7, err7), ("decode", xd, errd))]
    rows.extend(k7_rows)
    bh, sq, d, sk = q.shape[0] * q.shape[1], q.shape[2], q.shape[3], kk.shape[2]
    pairs = sum(min(sk, i + sk - sq + 1) for i in range(sq))   # causal
    k8_row = entry(
        f"H flash_attention {tuple(q.shape)} bfloat16 causal (prefill)",
        launches["K8"], res8["max_abs_err_plain"],
        time_ms(lambda: fa.K8(q, kk, vv)),
        time_ms(lambda: fa.flash_attention_plain(q, kk, vv), reps=5),
        4 * q.numel() * q.element_size(), 4 * bh * pairs * d,
        time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kk, vv, is_causal=True)),
        kernel="K8", peak="bf16 tensor", aligned_copies=k8_copies, **res8)
    rows.append(k8_row)
    rows.append(entry(
        f"H prefix_sum {tuple(x3.shape)} float32 (router slots, prefill)",
        launches["K3"], max_abs(got3, plain3),
        time_ms(lambda: ps.prefix_sum_kernel(x3)),
        time_ms(lambda: ps.prefix_sum_kernel(x3, interpret=True), reps=5),
        8 * x3.numel(), x3.numel(), time_ms(lambda: torch.cumsum(x3, 1)),
        kernel="K3", block=list(ps.block_shape(*x3.shape))))
    del params, t7, t8, ts, q, kk, vv, o8, plain8
    torch.cuda.empty_cache()

    # one router top-k call at the prefill's shape in a torch.profiler
    # trace (the weights freed): one K7 kernel, no padding copy
    router = device_kernels(lambda: ops.topk(x7, k7))
    names = None if router is None else [name for name, _ in router]
    check.true(f"H: a router top-k call ran {names}, want one K7 kernel "
               f"and no concatenation",
               names is not None and len(names) == 1
               and "k7_topk" in names[0])
    k7_rows[0]["device_kernels"] = router

    # off the path, at the same shapes
    rng = np.random.default_rng(SEED + 10)
    ties = torch.from_numpy(rng.integers(0, 4, x7.shape).astype(np.float32))
    ties[0] = 0.0                                  # one row of one value
    for case, x in (("float32 ties", ties.to(dev)),
                    ("bfloat16", x7.to(torch.bfloat16)),
                    ("int32", torch.from_numpy(rng.integers(
                        -10_000, 10_000, x7.shape, dtype=np.int32)).to(dev))):
        hold_topk(check, f"H K7 {case}", x, k7, *tk.K7(x, k7, npow7), npow7)
    # ±0.0 and NaN of either sign: the oracle's order (the plain network
    # compares values as floats and differs there)
    for dt in (torch.float32, torch.bfloat16):
        x = special_topk_rows(SEED + 13, tuple(x7.shape), dt, dev)
        hold_topk(check, f"H K7 ±0.0/NaN {dt}", x, k7,
                  *tk.K7(x, k7, npow7), npow7, plain=False)
    # rows above the full network's 4096 (the partial walk, k ≤ 32), and
    # the full network (k > 32) at the prefill's padded width
    wide = torch.from_numpy(rng.standard_normal(TOPK_WIDE, dtype=np.float32)
                            ).to(dev)
    full = tk.pad_to(x7, npow7)
    for case, x, k in ((f"{TOPK_WIDE} float32 k=8", wide, 8),
                       (f"{tuple(full.shape)} float32 k={TOPK_FULL_K} "
                        f"(full network)", full, TOPK_FULL_K)):
        K7.launches = 0
        vals, idx = tk.topk_kernel(x, k)
        own = K7.launches
        err = hold_topk(check, f"H K7 {case}", x, k, vals, idx)
        rows.append(topk_row(f"H topk {case}", own, err, x, k, x.shape[1],
                             launches_counted_in="own call"))
    del wide, full
    shape_q = (LM_BATCH, cfg.n_heads, LM_PROMPT, cfg.head_dim)
    for case, sq_, dt in (("causal sq < sk bfloat16", LM_PROMPT // 2,
                           torch.bfloat16),
                          ("float32", LM_PROMPT, torch.float32)):
        q, kk, vv = (torch.from_numpy(rng.standard_normal(
            s, dtype=np.float32)).to(dev, dt)
            for s in (shape_q[:2] + (sq_,) + shape_q[3:], shape_q, shape_q))
        hold_attention(check, f"H K8 {case}", q, kk, vv, fa.K8(q, kk, vv))
        del q, kk, vv
    # the prefill's shape at unit-scale logits, where softmax rows are
    # spread and p·v's roundings show (the path's ~10³ logits make rows
    # nearly one-hot)
    q, kk, vv = (torch.from_numpy(rng.standard_normal(
        shape_q, dtype=np.float32)).to(dev, torch.bfloat16) for _ in range(3))
    o8, plain8 = fa.K8(q, kk, vv), fa.flash_attention_plain(q, kk, vv)
    what = "H K8 causal bfloat16 unit-scale logits"
    k8_row["unit_scale_logits"] = hold_attention(check, what, q, kk, vv, o8,
                                                 plain8)
    k8_row["unit_scale_logits"].update(hold_f64(
        check, what, q, kk, vv, o8, plain8, noise=UNIT_SCALE_NOISE))
    del q, kk, vv, o8, plain8


def serve_timings(cfg, params, prompts, gen: int, walls) -> dict:
    """A server phase's numbers. Wall ms: the median of the readings, each
    kept: ``serve.generate``'s runs ``walls`` = [(prefill s or None,
    decode s), ...] and the mean of back-to-back calls (``time_ms``);
    device ms from CUDA events; device ms by kernel kind of one prefill
    and one decode step (one torch.profiler trace each), and each one's
    idle share: 1 − the traced kernels' sum / the traced call's own
    wall."""
    batch, prompt_len = prompts.shape
    pre = time_ms(lambda: M.prefill(cfg, params, {"tokens": prompts}),
                  reps=3, warmup=1)
    lg, cache = M.prefill(cfg, params, {"tokens": prompts})
    cache = M.grow_cache(cfg, cache, prompt_len, prompt_len + gen)
    tok = serve.sample(lg, None, 0.0)
    dec = time_ms(lambda: M.decode_step(cfg, params, cache, tok, prompt_len),
                  reps=5, warmup=1)
    traced = {"prefill": [], "decode_step": []}
    events = {
        "prefill": device_events(
            lambda: M.prefill(cfg, params, {"tokens": prompts}),
            traced["prefill"]),
        "decode_step": device_events(
            lambda: M.decode_step(cfg, params, cache, tok, prompt_len),
            traced["decode_step"])}
    by_kind = {key: None if ev is None else ms_by_kind(ev, LM_KINDS)
               for key, ev in events.items()}
    # the traced kernels' sum: a decode step enqueues more launches than
    # the launch queue holds, so the host blocks inside the spin that
    # holds the device and the event pairs above time the host too
    busy = {key: None if ms is None else sum(ms.values())
            for key, ms in by_kind.items()}
    del lg, cache
    readings = {
        "prefill": [p * 1e3 for p, _ in walls if p is not None] + [pre[1]],
        "decode": [d / (gen - 1) * 1e3 for _, d in walls] + [dec[1]]}
    prefill_ms = float(np.median(readings["prefill"]))
    step_ms = float(np.median(readings["decode"]))
    return {
        "prefill_wall_ms": prefill_ms,
        "decode_wall_ms_per_token": step_ms,
        "wall_ms_readings": readings,
        "prefill_device_ms": pre[0], "decode_device_ms_per_token": dec[0],
        "device_ms_by_kind": by_kind,
        "device_busy_ms": busy,
        "traced_wall_ms": {key: w[0] if w else None
                           for key, w in traced.items()},
        "device_idle_share": {
            key: None if busy[key] is None or not traced[key] else
            1 - busy[key] / traced[key][0] for key in busy},
        "top_kernels": {key: None if ev is None else top_events(ev)
                        for key, ev in events.items()},
        "prefill_tokens_per_s": batch * prompt_len / prefill_ms * 1e3,
        "decode_tokens_per_s": batch / step_ms * 1e3}


def scheduled_serve(arch: str, batch: int, prompt_len: int, gen: int,
                    extra=(), seed: int = SEED):
    """``serve.main`` on ``arch`` at full width on the card; returns (its
    tokens, what it printed)."""
    import contextlib
    import io
    out = io.StringIO()
    argv = ["--arch", arch.replace("_", "-"), "--batch", str(batch),
            "--prompt-len", str(prompt_len), "--gen", str(gen),
            "--seed", str(seed), *extra]
    with contextlib.redirect_stdout(out):
        tokens = serve.main(argv)
    return tokens, out.getvalue()


def ssd_chunk_inputs(seed: int, shape, dev):
    """The SSD chunk-output kernel's operands at ``shape`` = (batch,
    chunks, chunk, heads, headdim, state), ((x, C, g, cum, dt, run, D),
    B): x, C and B in bf16, g = C·Bᵀ, decays in (0.01, 0.2) a step that
    carry across chunks, states of unit scale."""
    b, nc, q, h, p, n = shape
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*dims):
        return torch.randn(dims, generator=gen, device=dev)

    s = nc * q
    x = rnd(b, s, h, p).to(torch.bfloat16)
    c, bm = rnd(b, s, n).to(torch.bfloat16), rnd(b, s, n).to(torch.bfloat16)
    g = torch.einsum("bcin,bcjn->bcij", c.float().reshape(b, nc, q, n),
                     bm.float().reshape(b, nc, q, n))
    dt = torch.nn.functional.softplus(rnd(b, s, h))
    a = -(0.01 + 0.19 * torch.rand(h, generator=gen, device=dev))
    cum = torch.cumsum((dt * a).reshape(b, nc, q, h), dim=2)
    return (x, c, g, cum, dt, rnd(b, nc, h, p, n), rnd(h)), bm


def ssd_chunk_counts(shape) -> tuple[int, int]:
    """(bytes, operations) the SSD chunk output needs: x, C, g, cum, dt,
    D and the states before chunks 1… read once, y written once in bf16;
    2 per multiply-add of the causal intra product and the inter
    product."""
    b, nc, q, h, p, n = shape
    s = nc * q
    n_bytes = (2 * b * s * h * p + 2 * b * s * n + 4 * b * nc * q * q
               + 2 * 4 * b * s * h + 4 * h + 4 * b * (nc - 1) * h * p * n
               + 2 * b * s * h * p)
    n_ops = 2 * b * nc * h * p * (q * (q + 1) // 2) + \
        2 * b * (nc - 1) * h * q * n * p
    return n_bytes, n_ops


def ssd_chunk_row(check, label: str, dev, shape, launches: int,
                  counted_in: str) -> dict:
    """The SSD chunk-output kernel alone at ``shape``: float32 output
    within ``SSD_TOL`` of max |y| of its plain version, the single-term
    control outside it, the bf16 output the float32 one rounded once;
    timed in bf16 beside its bound and its plain version."""
    ops, _ = ssd_chunk_inputs(SEED + 23, shape, dev)
    q = shape[2]
    got = SSD_CHUNK(*ops, q, torch.float32)
    control = SSD_CHUNK(*ops, q, torch.float32, pieces=1)
    plain = sc.chunk_output_plain(*ops, q, torch.float32)
    scale = float(plain.abs().max())
    err, control_err = max_abs(got, plain), max_abs(control, plain)
    check.true(f"{label} SSD chunk: {err / scale:.3e} of max |y| from its "
               f"plain version, bound {SSD_TOL}", err <= SSD_TOL * scale)
    check.true(f"{label} SSD chunk control: {control_err / scale:.3e} of "
               f"max |y|, want above {SSD_TOL}", control_err > SSD_TOL * scale)
    check.exact(f"{label} SSD chunk bf16 output",
                SSD_CHUNK(*ops, q, torch.bfloat16), got.to(torch.bfloat16))
    del got, control, plain
    n_bytes, n_ops = ssd_chunk_counts(shape)
    return entry(
        f"{label} chunk output {shape} bf16", launches, err,
        time_ms(lambda: SSD_CHUNK(*ops, q, torch.bfloat16)),
        time_ms(lambda: sc.chunk_output_plain(*ops, q, torch.bfloat16),
                reps=3),
        n_bytes, n_ops, None, kernel="SSD", peak="bf16 tensor",
        rel_err=err / scale, control_rel_err=control_err / scale,
        launches_counted_in=counted_in)


def run_phase_ssm(phase: str, dev, check, rows):
    """Serve one SSM family at every published width and all its layers
    (``SSM_SERVES[phase]``); each prefill K4 call held, as it runs,
    against float64 of its own inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False
    arch, batch, prompt_len, gen = SSM_SERVES[phase]
    cfg = get_config(arch)
    n_l = cfg.n_layers
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 20), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = serve_prompts(SEED + 21, cfg, batch, prompt_len, dev)
    chunks = prompt_len // cfg.ssm_chunk

    def hold(args, kw, out):           # K4's call checked as it runs
        a, states, axis = args
        bad, worst = statescan_bound_misses(out, a, states)
        return (tuple(states.shape), axis, bad, worst)

    # the main path: the server, with its launches counted
    with Tap(ps, "chunk_scan_state_kernel", hold) as t4, \
            Tap(M, "prefill", lambda *c: K4.launches) as tpre, \
            Tap(M, "decode_step", lambda *c: K4.launches) as tdec, \
            Tap(serve, "sample") as ts:
        K4.launches = K8.launches = K7.launches = K3.launches = 0
        SSD_CHUNK.launches = SSD_CHUNK.declined = 0
        tokens, _, decode1_s = phase_h(cfg, params, prompts, gen, "auto")
        launches = {"K4": K4.launches, "K8": K8.launches,
                    "K7": K7.launches, "K3": K3.launches,
                    "SSD": SSD_CHUNK.launches}
        declined = SSD_CHUNK.declined
    k4_calls = list(t4.calls)
    logits = [args[0] for args, _, _ in ts.calls]
    del t4, ts
    check.true(f"{phase}: {launches} launches, want K4 and SSD {n_l} and "
               f"no other kernel", launches == {"K4": n_l, "K8": 0, "K7": 0,
                                                "K3": 0, "SSD": n_l})
    check.true(f"{phase}: {declined} SSD calls declined, want 0",
               declined == 0)
    check.true(f"{phase}: K4 launches after prefill {tpre.calls}, want "
               f"[{n_l}]", tpre.calls == [n_l])
    check.true(f"{phase}: K4 launches after each decode step "
               f"{sorted(set(tdec.calls))}, want {n_l} (none a step)",
               len(tdec.calls) == gen - 1 and set(tdec.calls) == {n_l})
    want_shape = (batch, chunks, cfg.ssm_heads, cfg.ssm_headdim,
                  cfg.ssm_state)
    for i, (shape, axis, bad, _) in enumerate(k4_calls):
        check.true(f"{phase} K4 call {i}: states {shape} axis {axis}, "
                   f"want {want_shape} axis 1",
                   shape == want_shape and axis == 1)
        check.true(f"{phase} K4 call {i}: {bad} elements outside the "
                   f"summation bound", bad == 0)
    check.true(f"{phase} tokens: {tuple(tokens.shape)}, want ({batch}, "
               f"{gen}) ids below {cfg.vocab}",
               tuple(tokens.shape) == (batch, gen)
               and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()))
    check.true(f"{phase}: {len(logits)} logits sampled, want {gen}",
               len(logits) == gen)
    for i, lg in enumerate(logits):
        check.shaped(f"{phase} logits of step {i}", lg, (batch, cfg.vocab))
    del logits
    again, prefill_s, decode_s = phase_h(cfg, params, prompts, gen, "auto")
    check.exact(f"{phase} greedy tokens, run 2 vs run 1", again, tokens)
    summary = {"phase": phase, "card": CARD, "model": arch,
               "reduced": [], "n_layers": n_l, "batch": batch,
               "prompt_len": prompt_len, "gen": gen,
               "weight_bytes": weight_bytes(cfg), "init_s": init_s,
               "launches": launches,
               "k4_max_abs_err_f64": max(w for *_, w in k4_calls),
               # run 1's prefill ran under the float64 hold: not a reading
               **serve_timings(cfg, params, prompts, gen,
                               [(None, decode1_s), (prefill_s, decode_s)])}

    # K4 at the path's shape on random decays in (0, 1]: the path's own
    # decays are 0 in float32 (the reference's init), so there y = b and
    # its hold above cannot see a wrong decay index or carry
    a, states = ssd_inputs(SEED + 22, want_shape[:3], want_shape[3:], dev)
    rows.append(k4_row(check, phase, a, states, launches["K4"],
                       f"chunk_scan_state ({arch} prefill)",
                       f"phase {phase}'s server run (prefill)"))
    del a, states
    rows.append(ssd_chunk_row(check, phase, dev, SSD_CHUNK_SHAPES[phase],
                              launches["SSD"],
                              f"phase {phase}'s server run (prefill)"))

    if phase == "J":
        # the scheduled decode: the same tokens as the unscheduled server
        # at the same seed, nothing shed, its reports printed
        build = ROOT / "build" / "chip_smoke"
        build.mkdir(parents=True, exist_ok=True)
        paths = {k: str(build / f"{k}.json") for k in ("tail", "trace")}
        del params
        torch.cuda.empty_cache()
        plain_tokens, _ = scheduled_serve(arch, batch, SCHED_PROMPT, gen)
        K4.launches = 0
        sched_tokens, text = scheduled_serve(
            arch, batch, SCHED_PROMPT, gen,
            ["--sched", "--slo-shed", "--slo-ms", str(SCHED_SLO_MS),
             "--obs-tail", paths["tail"], "--obs-trace", paths["trace"]])
        sched_launches = K4.launches
        check.true(f"J scheduled: tokens {sched_tokens.shape} differ from "
                   f"the unscheduled server's",
                   np.array_equal(sched_tokens, plain_tokens))
        check.true("J scheduled: a step was shed", "slo-shed:" not in text)
        check.true(f"J scheduled: {sched_launches} K4 launches, want {n_l}",
                   sched_launches == n_l)
        reports = {k: [ln for ln in text.splitlines() if ln.startswith(k)]
                   for k in ("sched[", "slo[", "blame[", "obs tail:",
                             "obs trace")}
        for k, lines in reports.items():
            check.true(f"J scheduled: no '{k}' report printed", bool(lines))
        print("J scheduled run:\n" + text, flush=True)
        summary["scheduled"] = {"prompt_len": SCHED_PROMPT,
                                "slo_ms": SCHED_SLO_MS,
                                "tokens_equal_unscheduled": bool(
                                    np.array_equal(sched_tokens,
                                                   plain_tokens)),
                                "k4_launches": sched_launches,
                                "reports": reports}
    summary["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    print(json.dumps({"serve": summary}), flush=True)


def run_phase_j(dev, check, rows):
    run_phase_ssm("J", dev, check, rows)


def run_phase_k(dev, check, rows):
    run_phase_ssm("K", dev, check, rows)


def outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


CHUNK = 1 << 22                    # phase I: elements a chunked check holds


def hold_plan(check, what, plan, got, x, b, scalars) -> float:
    """Each output of a tenant B plan against ``plan.ref`` (the FMA bound)
    and the plain path, chunk by chunk (elementwise programs, so a chunk
    of the inputs gives that chunk of the outputs); returns max |Δ| to
    plain."""
    kind = plan.graph.name.removeprefix("c0_")
    err, bad = 0.0, [0] * len(got)
    for lo in range(0, x.numel(), CHUNK):
        xc, bc = x[lo:lo + CHUNK], b[lo:lo + CHUNK]
        refs = outputs(plan.ref(xc, bc, *scalars))
        plains = outputs(plan(xc, bc, *scalars, mode="interpret"))
        for k, (g, r, pl, t) in enumerate(zip(got, refs, plains,
                                              plan_terms(kind, xc, bc))):
            gc = g[lo:lo + CHUNK]
            bad[k] += int(((gc - r).abs() > 4 * EPS * t).sum())
            err = max(err, max_abs(gc, pl))
    for k, n in enumerate(bad):
        check.true(f"{what} output {k} vs ref: {n} elements outside the "
                   f"FMA bound", n == 0)
    return err


def batch_table(report, names) -> list[dict]:
    """Per batch of a scheduler run: lane, round, predicted and observed
    ms (the per-item shares summed: the batch's estimate and its wall
    time) and their ratio."""
    groups: dict = {}
    for p in report.placements:
        groups.setdefault(p.batch_seq, []).append(p)
    table = []
    for seq, ps in sorted(groups.items()):
        pred = sum(p.predicted_s for p in ps) * 1e3
        obs = sum(p.observed_s for p in ps) * 1e3
        table.append({"batch": names[seq], "items": len(ps),
                      "lane": ps[0].lane, "round": ps[0].round,
                      "predicted_ms": pred, "observed_ms": obs,
                      "observed_over_predicted": obs / pred})
    return table


def run_phase_i(dev, check, rows):
    t0 = time.perf_counter()
    plans = sched_plans(N_SCHED_PLAN)
    partition_s = time.perf_counter() - t0
    check.true(f"I: plans split {[p.chains() for p in plans]}, want two "
               f"parts each", all(p.n_parts == 2 for p in plans))
    def a_inputs():
        arrays = make_inputs(SEED + 12, [N_SCHED_ITEM] * (2 * N_SCHED_ITEMS),
                             dev)
        return arrays[:N_SCHED_ITEMS], arrays[N_SCHED_ITEMS:]
    xs, bs = a_inputs()
    x, b = make_inputs(SEED + 15, [N_SCHED_PLAN] * 2, dev)
    fused = isa.fuse("c0_scale", "c0_add")
    shared = CostModel(hierarchy=H100)     # runs whose estimates go unread
    marks = {}                             # peak bytes after each step

    def mark(step):
        marks[step] = [torch.cuda.memory_allocated(dev),
                       torch.cuda.max_memory_allocated(dev)]
    scalars = ((PLAN_S, PLAN_T), (SAX_A, SAX_B))

    # the main path: both tenants through the scheduler, launches counted
    # and the run recorded
    rec = TraceRecorder()
    K1.launches = K1.item_copies = 0
    t0 = time.perf_counter()
    rep, a_items, b_items = phase_i(xs, bs, x, b, plans, "auto",
                                    recorder=rec)
    cold_run_s = time.perf_counter() - t0
    launches, copies = K1.launches, K1.item_copies
    want = 1 + sum(p.n_parts for p in plans)
    check.true(f"I: {launches} K1 launches, want {want} (one for A's "
               f"batch, one per plan part)", launches == want)
    check.true(f"I: {copies} batch items copied, want 0", copies == 0)
    a_seqs = {it.seq for it in a_items}
    check.true("I: A's requests did not run as one coalesced batch",
               len({p.batch_seq for p in rep.placements
                    if p.seq in a_seqs}) == 1
               and all(p.coalesced for p in rep.placements
                       if p.seq in a_seqs))
    names = {a_items[0].seq: f"A {N_SCHED_ITEMS}x scale+add",
             b_items[0].seq: "B axpby_residual", b_items[1].seq: "B saxpby"}
    mark("main run")

    # every result against its own solo call (bit for bit), ref and plain
    errs_a = []
    for it, xa, ba in zip(a_items, xs, bs):
        got = rep.results.pop(it.seq)
        it.result = None
        check.shaped(f"I A item {it.seq}", got, xa.shape)
        check.exact(f"I A item {it.seq} vs its solo call", got,
                    fused(SCALE, xa, ba, mode="kernel"))
        bound = fma_bound((SCALE * xa, ba))
        check.within(f"I A item {it.seq} vs ref", got,
                     fused(SCALE, xa, ba, mode="ref"), bound)
        errs_a.append(max_abs(got, fused(SCALE, xa, ba, mode="interpret")))
        del got, bound
    mark("A's checks")
    a0, b0, b1 = a_items[0].seq, b_items[0].seq, b_items[1].seq
    got_b = [outputs(rep.results.pop(seq)) for seq in (b0, b1)]
    del a_items, b_items, it, xa, ba, xs, bs   # A's inputs, made anew below
    errs_b = []
    for plan, sc, got in zip(plans, scalars, got_b):
        what = f"I B {plan.graph.name}"
        for k, (g, w) in enumerate(zip(got, outputs(
                plan(x, b, *sc, mode="kernel")))):
            check.shaped(f"{what} output {k}", g, x.shape)
            check.exact(f"{what} output {k} vs its solo call", g, w)
        del g, w                       # the loop's last output and solo
        errs_b.append(hold_plan(check, what, plan, got, x, b, sc))
        mark(f"{what} checks")
    del got_b, rep, got

    # the recorded wall run replays: the same decisions, and the replay
    # replays itself exactly (placements_match)
    rec2 = TraceRecorder()
    rep_r = replay(TraceRecorder.loads(rec.dumps()), recorder=rec2)
    rep_rr = replay(TraceRecorder.loads(rec2.dumps()))

    def decisions(ps):
        return [(p.seq, p.lane, p.round, p.batch_seq, p.predicted_s)
                for p in ps]
    wall_places = rec.placements()
    xs, bs = a_inputs()
    replay_ok = {
        "decisions_match_wall_run": decisions(rep_r.placements)
        == decisions(wall_places),
        "placements_match": placements_match(rep_r.placements,
                                             rep_rr.placements)}
    check.true(f"I: replay {replay_ok}", all(replay_ok.values()))

    # one trace of the whole run: one K1 kernel for A's batch and one per
    # plan part, and nothing else on the device but the small host-to-
    # device table copies
    # (a trace that kept fewer K1 kernels than the kept call launched, by
    # K1's own count, lost events — a launch near a trace's start can be
    # dropped — and is taken again, at most twice; the gate below holds
    # whichever trace is kept to the same exact set)
    for attempt in range(3):
        K1.launches = 0
        events = device_events(lambda: phase_i(xs, bs, x, b, plans, "auto",
                                               cost=shared))
        launched = K1.launches // 2          # the warm-up call, the kept
        traced = None if events is None else sum(
            name.startswith("k1_") for name, _ in events)
        if traced is None or traced >= launched:
            break
        print(f"I: trace {attempt} kept {traced} of {launched} K1 "
              f"launches: traced again", file=sys.stderr, flush=True)
    mark("trace")
    kernels = None
    if events is not None:
        kernels = [name for name, _ in events
                   if not name.startswith(("Memcpy", "Memset"))]
        n_batch = sum("k1_batch_kernel" in k for k in kernels)
        n_part = sum("k1_kernel" in k for k in kernels)
        check.true(f"I: the run's kernels {kernels}, want one "
                   f"k1_batch_kernel and {want - 1} k1_kernel",
                   len(kernels) == want and n_batch == 1
                   and n_part == want - 1)
        dtod = [name for name, _ in events
                if name.startswith("Memcpy") and "HtoD" not in name]
        check.true(f"I: device copies {dtod}, want none", not dtod)

    # a warm run: each batch's predicted (CostModel over the H100 preset)
    # and observed ms
    t0 = time.perf_counter()
    rep2, a2, b2 = phase_i(xs, bs, x, b, plans, "auto")
    warm_run_s = time.perf_counter() - t0
    drift = batch_table(rep2, {a2[0].seq: names[a0],
                               b2[0].seq: names[b0],
                               b2[1].seq: names[b1]})
    del rep2, a2, b2
    mark("trace and warm run")

    # kernel rows: each batch's launches, timed on the run's own inputs
    # (one tenant's inputs at a time: the plain versions' temporaries)
    del x, b
    reqs = [(SCALE, xa, ba) for xa, ba in zip(xs, bs)]
    n_a = N_SCHED_ITEM * N_SCHED_ITEMS
    timed = time_ms(lambda: fused.program.call_batch(reqs))
    plain = time_ms(lambda: fused.program.call_batch(reqs, interpret=True))
    x2, b2s = torch.stack(xs), torch.stack(bs)
    rows.append(entry(
        f"I sched A: call_batch {N_SCHED_ITEMS}x scale+add, one scalar",
        1, max(errs_a), timed, plain, 12 * n_a, 2 * n_a,
        time_ms(lambda: torch.add(b2s, x2, alpha=SCALE)),
        launches_counted_in="phase I's scheduler run"))
    del x2, b2s, xs, bs, reqs
    mark("A's row")
    x, b = make_inputs(SEED + 15, [N_SCHED_PLAN] * 2, dev)
    fusion = {}
    for plan, sc, err, n_out in zip(plans, scalars, errs_b, (2, 1)):
        unfused = partition(plan.graph, model=H100, n_elems=N_SCHED_PLAN,
                            method="singletons")
        was = k1_was_new(check, f"I sched B: plan {plan.graph.name}",
                         lambda: plan(x, b, *sc, mode="kernel"),
                         [p.program for p in plan.parts
                          if p.program is not None])
        timed = was.pop("timed")
        unf = time_ms(lambda: unfused(x, b, *sc, mode="kernel"))
        name = plan.graph.name
        fusion[name] = {
            "parts": plan.n_parts, "chains": plan.chains(),
            "device_ms": timed[0], "unfused_parts": unfused.n_parts,
            "unfused_device_ms": unf[0],
            "unfused_over_fused": unf[0] / timed[0],
            "hbm_bytes": plan.modeled_hbm_bytes(),
            "unfused_hbm_bytes": unfused.modeled_hbm_bytes(),
            "predicted_ms": plan.predicted_time(overlap=False) * 1e3,
            "unfused_predicted_ms":
                unfused.predicted_time(overlap=False) * 1e3}
        rows.append(entry(
            f"I sched B: plan {name}, {plan.n_parts} parts",
            plan.n_parts, err, timed,
            time_ms(lambda: plan(x, b, *sc, mode="interpret"), reps=5),
            (2 + n_out) * 4 * N_SCHED_PLAN, plan.graph.flops(N_SCHED_PLAN),
            None,
            launches_counted_in="phase I's scheduler run",
            unfused_ms=unf[0], **was))
    del x, b
    mark("B's rows")

    # host overhead: the same mix at N = 2^12, wall per batch less device
    small = make_inputs(SEED + 13, [N_HOST] * (2 * N_SCHED_ITEMS + 2), dev)
    sx, sb = small[:N_SCHED_ITEMS], small[N_SCHED_ITEMS:-2]
    px, pb = small[-2:]
    small_plans = sched_plans(N_HOST)
    walls: dict = {}
    for _ in range(HOST_REPS):
        rep3, a3, b3 = phase_i(sx, sb, px, pb, small_plans, "auto",
                               cost=shared)
        kinds = {a3[0].seq: "A", b3[0].seq: "B axpby_residual",
                 b3[1].seq: "B saxpby"}
        for row in batch_table(rep3, kinds):
            walls.setdefault(row["batch"], []).append(row["observed_ms"])
    sreqs = [(SCALE, xa, ba) for xa, ba in zip(sx, sb)]
    device = {"A": time_ms(lambda: fused.program.call_batch(sreqs))[0],
              "B axpby_residual": time_ms(lambda: small_plans[0](
                  px, pb, PLAN_S, PLAN_T, mode="kernel"))[0],
              "B saxpby": time_ms(lambda: small_plans[1](
                  px, pb, SAX_A, SAX_B, mode="kernel"))[0]}
    host = {k: {"wall_ms_median": float(np.median(v)),
                "device_ms": device[k],
                "host_us": (float(np.median(v)) - device[k]) * 1e3}
            for k, v in walls.items()}
    del small, sx, sb, px, pb

    # H100_HBM.overhead_s by least squares: c0_copy device s against
    # bytes, t = overhead_s + bytes / peak_bw, over the sizes that fill
    # whole 8 × 1024 tiles (a smaller copy also launches a pad kernel,
    # core/stream.py flatten_to_blocks; its times are kept beside)
    tile = stream_copy.COPY.block_rows * stream_copy.COPY.block_cols
    times = {}
    for n in FIT_NS:
        (xf,) = make_inputs(SEED + 14, [n], dev)
        times[n] = time_ms(lambda: ops.stream_copy(xf, mode="kernel"))[0]
    whole = [n for n in FIT_NS if n % tile == 0]
    A = np.array([[1.0, 8.0 * n] for n in whole])
    t_s = np.array([times[n] * 1e-3 for n in whole])
    (c0, c1), *_ = np.linalg.lstsq(A, t_s, rcond=None)
    fit = {"n": whole, "bytes": [8 * n for n in whole],
           "device_s": t_s.tolist(), "overhead_s": float(c0),
           "peak_bw_bytes_per_s": float(1 / c1) if c1 > 0 else None,
           "max_rel_residual": float(np.max(np.abs(A @ [c0, c1] - t_s)
                                            / t_s)),
           "assumed_overhead_s": H100.dram.overhead_s,
           "padded_n_device_s": {str(n): times[n] * 1e-3 for n in FIT_NS
                                 if n % tile}}

    summary = {"phase": "I", "card": CARD, "policy": "wfq", "n_lanes": 2,
               "clock": "wall", "hierarchy": H100.name,
               "partition_s": partition_s, "cold_run_s": cold_run_s,
               "warm_run_s": warm_run_s, "launches": launches,
               "device_kernels": kernels, "batches": drift,
               "fusion": fusion, "host_per_dispatch_at_n": N_HOST,
               "host_per_dispatch": host, "overhead_fit": fit,
               "replay": replay_ok, "peak_bytes_after": marks,
               "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    print(json.dumps({"sched": summary}), flush=True)


# ---------------------------------------------------------------------------
# phases L and M: training on the card
# ---------------------------------------------------------------------------

def k4_by_direction(events, n_layers: int) -> dict:
    """Device ms of K4's forward and reverse launches in one traced train
    step under remat full, told apart by their order (both directions are
    one kernel): the forward's n_layers, then per layer from the last the
    recompute's forward and the backward's reverse walk (da's second
    pass, ``k4_da_kernel``, is not among them)."""
    k4 = [ms for name, ms in events if "k4_state" in name]
    if len(k4) != 3 * n_layers:
        return {"k4_events": len(k4), "forward_ms": None,
                "reverse_ms": None}
    back = k4[n_layers:]
    return {"k4_events": len(k4),
            "forward_ms": sum(k4[:n_layers]) + sum(back[0::2]),
            "reverse_ms": sum(back[1::2])}


def params_equal(a: dict, b: dict) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))


def max_moved(a: dict, b: dict) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def run_phase_l(dev, check, rows):
    """Train Mamba2-1.3B uncut (every published width, all 48 layers)
    for TRAIN_STEPS steps of 4 × 4096 tokens through api.make_train_step:
    bf16 params, AdamW with float32 moments, remat full; then K4 at the
    step's own shape and the SSD gradients against ref mode."""
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(TRAIN_ARCH)
    n_l = cfg.n_layers
    t0 = time.perf_counter()
    state = api.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 30), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data = SyntheticLMData(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, SEED)
    step_fn = api.make_train_step(cfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    states_shape = (TRAIN_BATCH, TRAIN_SEQ // cfg.ssm_chunk, cfg.ssm_heads,
                    cfg.ssm_headdim, cfg.ssm_state)

    # the main path: TRAIN_STEPS steps, each one's launches counted
    steps = []
    for i in range(TRAIN_STEPS):
        batch = to_device(data.host_batch(i), dev)
        torch.cuda.synchronize()
        with Tap(ps, "chunk_scan_state_kernel",
                 lambda args, kw, out: tuple(out.shape)) as t4:
            K4.launches = K4.reverse_launches = K4.da_launches = 0
            K7.launches = K3.launches = K8.launches = 0
            t0 = time.perf_counter()
            new_state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = {"K4 forward": K4.launches,
                        "K4 reverse": K4.reverse_launches,
                        "K4 da": K4.da_launches,
                        "K7": K7.launches, "K3": K3.launches,
                        "K8": K8.launches}
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        steps.append({"step": i, "wall_ms": wall_ms, "loss": loss,
                      "grad_norm": gnorm, "launches": launches})
        check.true(f"L step {i}: loss {loss}, grad norm {gnorm} not finite",
                   math.isfinite(loss) and math.isfinite(gnorm))
        check.true(f"L step {i}: launches {launches}, want K4 {2 * n_l} "
                   f"forward (forward and remat's recompute), {n_l} "
                   f"reverse and {n_l} da passes, no other kernel",
                   launches == {"K4 forward": 2 * n_l, "K4 reverse": n_l,
                                "K4 da": n_l, "K7": 0, "K3": 0, "K8": 0})
        check.true(f"L step {i}: K4 scanned states of {set(t4.calls)}, "
                   f"want {states_shape} only",
                   set(t4.calls) == {states_shape})
        check.true(f"L step {i}: step counter {int(new_state['step'])}",
                   int(new_state["step"]) == i + 1)
        if i == 0:      # warmup: lr 0 at step 0, so nothing moves
            check.true("L step 0 (lr 0) changed the params",
                       params_equal(state["params"], new_state["params"]))
        if i == 1:
            moved = max_moved(state["params"], new_state["params"])
            steps[-1]["max_param_change"] = moved
            check.true("L step 1: the params did not move", moved > 0)
        state = new_state
        del new_state, metrics
    step_ms = float(np.median([s["wall_ms"] for s in steps[1:]]))

    # one traced step (the state is not advanced by it)
    batch = to_device(data.host_batch(TRAIN_STEPS), dev)
    traced = []
    events = device_events(lambda: step_fn(state, batch), traced)
    by_kind = None if events is None else ms_by_kind(events, LM_KINDS)
    busy = None if by_kind is None else sum(by_kind.values())
    summary = {
        "phase": "L", "card": CARD, "model": TRAIN_ARCH, "reduced": [],
        "n_layers": n_l, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "remat": cfg.remat, "optimizer": cfg.optimizer,
        "param_dtype": cfg.param_dtype,
        "opt_state_dtype": cfg.opt_state_dtype,
        "weight_bytes": weight_bytes(cfg), "init_s": init_s,
        "steps": steps, "step_wall_ms": step_ms,
        "tokens_per_s": tokens / step_ms * 1e3,
        "device_ms_by_kind": by_kind, "device_busy_ms": busy,
        "traced_wall_ms": traced[0] if traced else None,
        "device_idle_share": (None if busy is None or not traced
                              else 1 - busy / traced[0]),
        "top_kernels": None if events is None else top_events(events),
        "k4_in_step": (None if events is None
                       else k4_by_direction(events, n_l))}
    del events, state, batch
    torch.cuda.empty_cache()
    summary["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    summary["peak_limit_bytes"] = PEAK_MEM_LIMIT["L"]
    summary["k4_at_step_shape"] = hold_train_scan(
        dev, check, rows, states_shape, steps[-1]["launches"])
    summary["grads_against_ref"] = hold_train_grads(dev, check, cfg)
    print(json.dumps({"train": summary}), flush=True)


def hold_train_scan(dev, check, rows, shape, launches, label: str = "L",
                    counted_in: str = "a phase L train step (48 layers)"
                    ) -> dict:
    """K4 at the train step's own states shape (B, C, H, P, N), on random
    decays in (0, 1] (the model's own are 0 in float32, so there λ = g):
    the forward entry and the reverse walk on the backward's operands
    (the shifted decay a[c+1]) as :func:`k4_row` holds them, the reverse
    also bit-identical to the forward on flipped copies; then
    c4_statescan's backward (StateScanFn: the shifted decay, the reverse
    walk that reduces da, da's second pass) in kernel and interpret modes
    and the former path (``former_kernels.state_scan_grad``: the former
    walk, then da as the product at the states' size and a torch sum)
    against float64 (:func:`statescan_grad_misses`): kernel and interpret
    bit for bit, the fused da within 2·b_da of the former's, the same
    bits on a second run. Adds the forward's and the reverse walk's
    ``kernels`` rows with the step's launch counts, the backward call's
    time beside the former path's."""
    import former_kernels as former
    a, s = ssd_inputs(SEED + 31, shape[:3], shape[3:], dev)
    g = ssd_inputs(SEED + 32, shape[:3], shape[3:], dev)[1]
    rows.append(k4_row(check, label, a, s, launches["K4 forward"],
                       "chunk_scan_state (the train step's forward and "
                       "recompute)", counted_in))
    shifted = ps.next_decay(a, 1)
    rev = K4.state_scan(shifted, g, 1, reverse=True)
    flipped = K4.state_scan(shifted.flip(1), g.flip(1), 1).flip(1)
    same = torch.equal(rev, flipped)
    check.true(f"{label} K4 reverse walk: not bit-identical to the forward "
               "entry on flipped copies", same)
    del rev, flipped
    rev_row = k4_row(check, label, shifted, g, launches["K4 reverse"],
                     "reverse walk (the backward of c4_statescan)",
                     counted_in, reverse=True,
                     bit_identical_to_forward_flipped=same,
                     forward_launches_in_step=launches["K4 forward"],
                     da_launches_in_step=launches.get("K4 da"))

    grads, bw = {}, {}
    for mode in ("kernel", "interpret"):
        ar, sr = a.clone().requires_grad_(), s.clone().requires_grad_()
        K4.launches = K4.reverse_launches = K4.da_launches = 0
        y = ops.chunk_scan_state(ar, sr, axis=1, mode=mode)
        grads[mode] = torch.autograd.grad(y, (ar, sr), g)
        bw[mode] = (K4.launches, K4.reverse_launches, K4.da_launches)
        del y, ar, sr
    check.true(f"{label} backward: K4 (forward, reverse, da) launches {bw}, "
               f"want (1, 1, 1) in kernel mode and none in interpret mode",
               bw == {"kernel": (1, 1, 1), "interpret": (0, 0, 0)})
    y = K4.state_scan(a, s, 1)
    grads["was"] = former.state_scan_grad(a, y, g, 1)
    for key, (i, j) in {"ds": (1, 1), "da": (0, 0)}.items():
        check.exact(f"{label} backward {key} kernel vs interpret",
                    grads["kernel"][i], grads["interpret"][j])
    again = ps.state_scan_grad(a, y, g, 1)
    check.exact(f"{label} backward da, run 2 vs run 1", again[0],
                grads["kernel"][0])
    del again
    bad, worst = statescan_grad_misses(
        {"kernel": grads["kernel"], "interpret": grads["interpret"]}, a, s,
        g)
    bad_w, worst_w = statescan_grad_misses(
        {"kernel": grads["kernel"], "was": grads["was"]}, a, s, g, was=True)
    bad.update(bad_w)
    worst.update(worst_w)
    for key, k in bad.items():
        check.true(f"{label} backward {key}: {k} elements outside the bound",
                   k == 0)
    del grads
    call_new, call_was, call_runs = was_new(
        lambda: ps.state_scan_grad(a, y, g, 1),
        lambda: former.state_scan_grad(a, y, g, 1))
    rev_row.update(backward_call_ms=call_new[0],
                   was_backward_call_ms=call_was[0],
                   backward_call_ms_runs=call_runs)
    rows.append(rev_row)
    del a, s, g, y, shifted
    return {"states": list(shape), "walk": rev_row["walk"],
            "bit_identical_to_forward_flipped": same,
            "reverse_max_abs_err_f64": rev_row["max_abs_err_f64"],
            "backward_outside_bound": bad, "backward_max_abs_err": worst,
            "backward_call_ms": call_new[0],
            "was_backward_call_ms": call_was[0]}


def hold_train_grads(dev, check, cfg) -> dict:
    """One gradient of the loss (api.make_grad_fn) at phase L's widths
    and sequence, cut to TRAIN_GRAD_LAYERS layers in float32 (so the
    modes differ only in the scans' rounding), with carrying decays
    (:func:`carrying_decays`): kernel mode (K4 forward, recompute and
    reverse walk) and interpret mode (their plain walks) against ref
    mode (the oracle differentiated by autograd), each leaf within
    TRAIN_GRAD_REL of its max |g|."""
    gcfg = dataclasses.replace(cfg, n_layers=TRAIN_GRAD_LAYERS,
                               param_dtype="float32", act_dtype="float32")
    params = M.init_params(gcfg, torch.Generator(device=dev).manual_seed(
        SEED + 33), dev)
    carrying_decays(params, gcfg.ssm_chunk, SEED + 34)
    batch = to_device(SyntheticLMData(gcfg.vocab, TRAIN_SEQ, TRAIN_BATCH,
                                      SEED + 35).host_batch(0), dev)
    grad_fn = api.make_grad_fn(gcfg)
    decays = []
    out = {}
    for mode in ("kernel", "interpret", "ref"):
        with isa.use(mode), Tap(
                ps, "chunk_scan_state_kernel",
                lambda args, kw, o: args[0].detach().flatten()) as t4:
            K4.launches = K4.reverse_launches = K4.da_launches = 0
            grads, metrics = grad_fn(params, batch)
            launches = (K4.launches, K4.reverse_launches, K4.da_launches)
        if mode == "kernel":
            decays = torch.cat(t4.calls[:TRAIN_GRAD_LAYERS])
            want = (2 * TRAIN_GRAD_LAYERS, TRAIN_GRAD_LAYERS,
                    TRAIN_GRAD_LAYERS)
        else:
            want = (0, 0, 0)
        check.true(f"L grads {mode} mode: K4 (forward, reverse, da) launches "
                   f"{launches}, want {want}", launches == want)
        out[mode] = (grads, float(metrics["loss"]))
        del grads, metrics
    quant = [float(decays.quantile(q)) for q in (0.0, 0.1, 0.5, 0.9, 1.0)]
    check.true(f"L grads: the chunks' decays {quant} do not carry (median "
               f"≤ 0.05)", quant[2] > 0.05)
    ref_grads, ref_loss = out.pop("ref")
    ratios = {}
    for mode, (grads, loss) in out.items():
        ratios[mode] = grad_ratios(grads, ref_grads)
        bad = {k: v for k, v in ratios[mode].items()
               if not v <= TRAIN_GRAD_REL}
        check.true(f"L grads {mode} mode against ref: leaves over "
                   f"{TRAIN_GRAD_REL} of their max |g|: {bad}", not bad)
        check.true(f"L grads {mode} mode: loss {loss} is not ref's "
                   f"{ref_loss} within {TRAIN_GRAD_REL}",
                   abs(loss - ref_loss) <= TRAIN_GRAD_REL * abs(ref_loss))
    del out, ref_grads, params, batch
    return {"layers": TRAIN_GRAD_LAYERS, "dtype": "float32",
            "seq": TRAIN_SEQ, "batch": TRAIN_BATCH, "bound": TRAIN_GRAD_REL,
            "decay_quantiles": quant, "loss_ref": ref_loss,
            "worst_ratio": {m: max(r.values()) for m, r in ratios.items()},
            "ratio_by_leaf": ratios}


def run_phase_m(dev, check, rows):
    """MoE training on the card at Kimi-K2's reduced config (a full-width
    MoE train step does not fit one card: Kimi-K2's experts are 16.9 B
    params a layer): a train step with K7 and K3 against the same step
    on the oracles, bit for bit; K7's gradient at H's router shape; then
    the trainer's own entry point with a checkpoint and a resume."""
    cfg = dataclasses.replace(get_config(MOE_ARCH).reduced(),
                              capacity_factor=8.0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    state = api.init_train_state(cfg, gen, dev)
    rng = np.random.default_rng(SEED + 41)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64)).astype(
        np.int32)).to(dev) for k in ("tokens", "targets")}
    step_fn = api.make_train_step(cfg)
    grads_fn = api.make_grad_fn(cfg)
    out = {}
    # deterministic scatters and gathers, so both runs sum in one order
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for mode in ("kernel", "ref"):
            with isa.use(mode):
                K7.launches = K3.launches = K4.launches = K8.launches = 0
                grads, _ = grads_fn(state["params"], batch)
                launches = {"K7": K7.launches, "K3": K3.launches,
                            "K4": K4.launches, "K8": K8.launches}
                new_state, metrics = step_fn(state, batch)
            out[mode] = (grads, new_state, metrics, launches)
    finally:
        torch.use_deterministic_algorithms(False)
    n_l = cfg.n_layers
    check.true(f"M kernel mode: launches {out['kernel'][3]}, want K7 and "
               f"K3 {2 * n_l} (forward and recompute), no K4 or K8",
               out["kernel"][3] == {"K7": 2 * n_l, "K3": 2 * n_l, "K4": 0,
                                    "K8": 0})
    check.true(f"M ref mode launched {out['ref'][3]}",
               not any(out["ref"][3].values()))
    kg, kstate, km, _ = out["kernel"]
    rg, rstate, rm, _ = out["ref"]
    grads_same = params_equal(kg, rg)
    check.true("M: kernel-mode grads are not ref-mode's bit for bit",
               grads_same)
    check.true("M: kernel-mode step (loss, grad norm, new state) is not "
               "ref-mode's bit for bit",
               torch.equal(km["loss"], rm["loss"])
               and torch.equal(km["grad_norm"], rm["grad_norm"])
               and params_equal(kstate, rstate))
    worst_grad = max(float((a - b).abs().max()) for a, b in
                     zip(tree_leaves(kg), tree_leaves(rg)))
    del out, kg, rg, kstate, rstate, state

    # K7's gradient at the router's prefill shape: the scatter of the
    # oracle's picks, exactly
    x = torch.from_numpy(np.random.default_rng(SEED + 42).standard_normal(
        ROUTER_SHAPE, dtype=np.float32)).to(dev).requires_grad_()
    gv = torch.from_numpy(np.random.default_rng(SEED + 43).standard_normal(
        (ROUTER_SHAPE[0], ROUTER_K), dtype=np.float32)).to(dev)
    K7.launches = 0
    vals, _ = ops.topk(x, ROUTER_K, mode="kernel")
    (dx,) = torch.autograd.grad(vals, x, gv)
    k7_launches = K7.launches
    _, ridx = ref.topk(tk.pad_to(x.detach(), 512), ROUTER_K)
    want = torch.zeros_like(x).scatter_(-1, ridx.long(), gv)
    check.exact("M K7 gradient at (4096, 384) k 8 against the oracle's "
                "scatter", dx, want)
    check.true(f"M K7 gradient: {k7_launches} launches, want 1",
               k7_launches == 1)
    del x, gv, vals, dx, want

    # train.main on the card: 6 steps with checkpoints, then a
    # resume to 9
    import contextlib
    import io
    import tempfile
    build = ROOT / "build"
    build.mkdir(parents=True, exist_ok=True)
    texts = []
    with tempfile.TemporaryDirectory(dir=build) as ckpt:
        for n in (6, 9):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                final = train.main(
                    ["--arch", "mamba2-1.3b", "--reduced", "--steps", str(n),
                     "--batch", "4", "--seq", "64", "--ckpt-dir", ckpt,
                     "--ckpt-every", "3", "--log-every", "3"])
            texts.append(buf.getvalue())
    print("M train.main:\n" + "".join(texts), flush=True)
    check.true("M train.main: 'resumed from step 6' not printed on the "
               "resume", "resumed from step 6" in texts[1])
    check.true(f"M train.main: final loss {final} not finite",
               math.isfinite(final))
    print(json.dumps({"train_moe": {
        "phase": "M", "card": CARD, "model": MOE_ARCH,
        "reduced": ["reduced() config (2 layers, d_model 64, 8 experts "
                    "top-2): Kimi-K2's experts are 16.9 B params a layer"],
        "grads_bit_identical_kernel_vs_ref": grads_same,
        "max_abs_grad_diff": worst_grad,
        "loss": float(km["loss"]), "grad_norm": float(km["grad_norm"]),
        "k7_grad_router_shape": list(ROUTER_SHAPE),
        "train_main_lines": [ln for t in texts for ln in t.splitlines()]}}),
        flush=True)


# ---------------------------------------------------------------------------
# phase N: the mesh on the card — ranks as processes sharing it, over gloo
# ---------------------------------------------------------------------------

N_ARCH = TRAIN_ARCH                 # N1, N3, N4: Mamba2-1.3B uncut
N1_RANKS, N1_DELTA = 4, 1e-3        # pods; rank r's params: base + r·δ
N1_BOUND = 8 / 127                  # of the mean's absmax (the reference's)
N2_RANKS, N2_ULPS = 4, 4            # MoE ranks; bf16 ulps at a row's max
N3_RANKS, N3_STEPS = 2, 2           # FSDP ranks and steps
N3_LOSS_RTOL, N3_GNORM_RTOL = 2e-4, 1e-2
N3_GRAD_REL = 2.0 ** -7  # a leaf's gradient, of its max |g| (one bf16 ulp)
N3_DU_SLOPE = 1.8        # |δu| ≤ 1.8·(|δg0| + |δg1|)/max(|g0|, |g1|)
N3_HELD_REL = 1 / 16     # params held where that slope term is ≤ 1/16
N3_UPDATE_TOL = 1 / 8    # then |δp| ≤ one bf16 ulp + lr/8 (docstring)
N4_STAGES, N4_MICRO, N4_SEQ = 4, 8, 2048
N5_RANKS = 2
N7_MESH = (1, 2)                    # (data, model): the dense layers split
N7A_BATCH, N7A_STEPS = 2, 2         # N7a: Mamba2-1.3B uncut, 2 × 4096
N7A_LOSS_RTOL = 1e-3                # each step's loss (docstring)
N7B_ARCH = "llama3_8b"              # N7b: served uncut, K8 in prefill
N7B_BATCH, N7B_PROMPT, N7B_GEN = 4, 2048, 16
N7B_F32_FACTOR = 4.0                # logits off float32, of one process's
N7B_CUT_LAYERS, N7B_CUT_REL = 2, 1e-4   # N7b's float32 cut (docstring)


def n2_config():
    """Kimi-K2's MoE at its published widths, one layer."""
    return dataclasses.replace(get_config(LM_ARCH), n_layers=1)


def moe_bytes(cfg) -> int:
    return sum(math.prod(s.shape) * DTYPES[s.dtype or cfg.param_dtype].itemsize
               for path, s in tree_items(param_specs(cfg))
               if path.startswith("layers.moe."))


def fsdp_peak_limit(cfg, batch: int, seq: int, ranks: int) -> float:
    """A rank's limit in phase N3: phase L's count of a train step at the
    rank's rows, with the params' share of it (seven copies of the bf16
    params) cut to the rank's shards, plus the embedding and one layer
    gathered whole with their full-size gradients."""
    params = weight_bytes(cfg)
    layer = params / cfg.n_layers
    embed = cfg.vocab_padded * cfg.d_model * 2
    return (train_peak_limit(cfg, batch, seq) - 7 * params * (1 - 1 / ranks)
            + 2 * (embed + layer))


def dispatch_bytes(cfg, tokens: int) -> int:
    """One (E·cap, d_model) buffer of the MoE dispatch, in bf16."""
    from repro_torch.models.moe import _capacity
    return cfg.n_experts * _capacity(cfg, tokens) * cfg.d_model * 2


def largest_leaf(cfg) -> int:
    return max(math.prod(s.shape) for _, s in tree_items(param_specs(cfg)))


def n7b_config():
    """Llama-3-8B at every published width and depth, attention on K8."""
    return dataclasses.replace(get_config(N7B_ARCH), attn_impl="kernel")


def n7b_cut_config():
    """N7b's float32 cut: N7B_CUT_LAYERS layers, every width published,
    attention on K8 (its float32 path)."""
    return dataclasses.replace(n7b_config(), n_layers=N7B_CUT_LAYERS,
                               param_dtype="float32", act_dtype="float32")


def rank_shapes(cfg, mesh_shape) -> dict:
    """Each param leaf's shape on one rank of a (data, model) mesh of
    ``mesh_shape`` (the shards the rules give)."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.params import abstract_params, logical_axes
    mesh = AbstractMesh(mesh_shape, ("data", "model"))
    specs = dict(tree_items(sharding.tree_specs(
        logical_axes(cfg), abstract_params(cfg), mesh)))
    return {path: sharding.local_shape(s.shape, specs[path], mesh)
            for path, s in tree_items(param_specs(cfg))}


def rank_weight_bytes(cfg, mesh_shape) -> int:
    item = DTYPES[cfg.param_dtype].itemsize
    return sum(math.prod(v) * item
               for v in rank_shapes(cfg, mesh_shape).values())


def tp_train_peak_limit(cfg, batch: int, seq: int, m: int) -> float:
    """A rank's limit in N7a: train_peak_limit's count with the dense
    layers split over ``m`` model peers under SP — the rank's params
    (its heads, ``d_inner`` block and vocabulary block; the whole leaves
    whole) in its seven copies; its saved layer inputs, its sequence
    block; one layer's recompute and backward on the gathered sequence
    and its heads (eight (B, C, Q, Q, H/m) float32 tensors, 24 float32
    (B, S, d_inner/m) activations, four more float32 (B, S, D) for the
    gathered input and its gradient); the logits of its vocabulary
    block (four (B·S, V/m) float32); the update's eleven param copies
    and six float32 copies of its largest leaf."""
    params = rank_weight_bytes(cfg, (1, m))
    q = min(cfg.ssm_chunk, seq)
    quad = batch * seq * q * (cfg.ssm_heads // m) * 4
    act = batch * seq * (cfg.d_inner // m) * 4
    gathered = batch * seq * cfg.d_model * 4
    logits = batch * seq * (cfg.vocab_padded // m) * 4
    saved = cfg.n_layers * batch * (seq // m) * cfg.d_model * 2
    largest = max(math.prod(v) for v in rank_shapes(cfg, (1, m)).values())
    forward_backward = (7 * params + saved + 8 * quad + 24 * act
                        + 4 * gathered + 4 * logits)
    update = 11 * params + 6 * 4 * largest
    return max(forward_backward, update)


def tp_serve_peak_limit(cfg, batch: int, prompt: int, gen: int,
                        m: int) -> float:
    """A rank's limit in N7b: its weights; the KV cache of its heads
    twice (the layers' caches and their stack) at prompt + gen
    positions; prefill's largest intermediates on the gathered sequence:
    ten (B, S, D) bf16 activations, three (B, S, d_ff/m) bf16 and one
    float32 for the MLP, and the rank's q, k, v and output of K8
    (B, H/m, S, hd) bf16 with their repeated KV heads; two (B, V)
    float32 logits."""
    kv = (cfg.n_kv_heads // m if cfg.n_kv_heads % m == 0
          else cfg.n_kv_heads)
    cache = 2 * cfg.n_layers * batch * (prompt + gen) * kv * cfg.head_dim * 2
    act = batch * prompt * cfg.d_model * 2
    ffn = batch * prompt * (cfg.d_ff // m) * 2
    heads = batch * (cfg.n_heads // m) * prompt * cfg.head_dim * 2
    logits = batch * cfg.vocab_padded * 4
    return (rank_weight_bytes(cfg, (1, m)) + 2 * cache + 10 * act
            + 5 * ffn + 6 * heads + 2 * logits)


#: each rank's device-memory limit, by case (see PERF.md, phase N): N1
#: the base params, the rank's shifted copy and the synced ones, and six
#: float32 copies of the largest leaf while the ring syncs it (its
#: float32 copy, the padded chunks, the output before the slice, the
#: slice, the division, the hops' int8 and dequantised chunks); N2 the rank's experts and twelve (E·cap, d)
#: bf16 dispatch buffers (the dispatch keeps its locals to its end: the
#: repeated tokens, the send buffer, each all-to-all's output and
#: transposed copy, the FFN's output, the padded copy, the gathered rows
#: and their two float32 copies at twice the size)
N_RANK_PEAK = {
    "N1": 3 * weight_bytes(get_config(N_ARCH))
    + 6 * 4 * largest_leaf(get_config(N_ARCH)) + 1e9,
    "N2": moe_bytes(n2_config()) / N2_RANKS
    + 12 * dispatch_bytes(n2_config(), LM_BATCH * LM_PROMPT),
    "N3": fsdp_peak_limit(get_config(N_ARCH), TRAIN_BATCH // N3_RANKS,
                          TRAIN_SEQ, N3_RANKS),
    "N4": weight_bytes(get_config(N_ARCH)) + 3e9,
    "N5": 3e9, "N6": 3e9,
    "N7a": tp_train_peak_limit(get_config(N_ARCH), N7A_BATCH, TRAIN_SEQ,
                               N7_MESH[1]),
    "N7b": tp_serve_peak_limit(n7b_config(), N7B_BATCH, N7B_PROMPT,
                               N7B_GEN, N7_MESH[1])}
PEAK_MEM_LIMIT["N"] = max(PEAK_MEM_LIMIT["L"], moe_bytes(n2_config()) + 8e9)


def _rank_main(rank: int, world: int, store: str, out_dir: str, case: str,
               args) -> None:
    """One rank of a phase N case: a gloo process group over a file
    store, the card shared by every rank; its result pickled for the
    parent. An exception fails the spawn."""
    import datetime
    import pickle
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=900))
    try:
        torch.cuda.reset_peak_memory_stats()
        res = RANK_CASES[case](rank, *args)
        torch.cuda.synchronize()
        res["peak_bytes"] = max(res.get("peak_bytes", 0),
                                torch.cuda.max_memory_allocated())
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def spawn_ranks(case: str, world: int, *args) -> list[dict]:
    """``RANK_CASES[case](rank, *args)`` on ``world`` processes (start
    method spawn, gloo over loopback); their results in rank order, each
    with the spawn's seconds."""
    import pickle
    import tempfile
    import torch.multiprocessing as mp
    build = ROOT / "build"
    build.mkdir(parents=True, exist_ok=True)
    prev = os.environ.get("GLOO_SOCKET_IFNAME")
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    try:
        with tempfile.TemporaryDirectory(dir=build) as d:
            t0 = time.perf_counter()
            mp.start_processes(_rank_main, args=(world, os.path.join(
                d, "store"), d, case, args), nprocs=world,
                start_method="spawn")
            spawn_s = time.perf_counter() - t0
            out = []
            for r in range(world):
                with open(os.path.join(d, f"{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
    finally:
        if prev is None:
            os.environ.pop("GLOO_SOCKET_IFNAME", None)
        else:
            os.environ["GLOO_SOCKET_IFNAME"] = prev
    for o in out:
        o["spawn_s"] = spawn_s
    return out


def _collectives():
    from repro_torch.distributed import collectives as C
    return C


def _timed(fn):
    """(fn's result, its wall seconds, the seconds in collectives, the
    bytes staged through host) — counters reset before."""
    C = _collectives()
    C.STAGED_BYTES, C.SECONDS = 0, 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, C.SECONDS, C.STAGED_BYTES


def n1_shifted(leaf: torch.Tensor, rank: int) -> torch.Tensor:
    """Rank ``rank``'s copy of a base param leaf in N1: base + rank·δ."""
    return (leaf.float() + rank * N1_DELTA).to(leaf.dtype)


def leaf_digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes (its bits, whatever its dtype)."""
    import hashlib
    return hashlib.sha256(t.detach().contiguous().cpu().reshape(-1).view(
        torch.uint8).numpy()).hexdigest()


def n1_rank(rank: int) -> dict:
    """make_pod_sync on a (pod 4, data 1, model 1) mesh over Mamba2-1.3B's
    whole param tree; each synced leaf's bits as a SHA-256, for the
    parent to hold against the ring's one-process replay."""
    from repro_torch.launch.mesh import Mesh
    dev = torch.device("cuda", 0)
    cfg = get_config(N_ARCH)
    mesh = Mesh((N1_RANKS, 1, 1), ("pod", "data", "model"))
    base = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 50), dev)
    params = {p: n1_shifted(b, rank) for p, b in tree_items(base)}
    sync = train.make_pod_sync(mesh)
    out, secs, coll, staged = _timed(lambda: sync(params))
    return {"seconds": secs, "collective_s": coll, "staged_bytes": staged,
            "digests": {p: leaf_digest(t) for p, t in out.items()},
            "param_bytes": weight_bytes(cfg)}


def n2_tokens(rank: int, cfg, dev) -> torch.Tensor:
    """Rank r's (4, 1024, d_model) MoE inputs (H's prefill shape) in the
    activation dtype (bf16)."""
    rng = np.random.default_rng(SEED + 52 + rank)
    return torch.from_numpy(rng.standard_normal(
        (LM_BATCH, LM_PROMPT, cfg.d_model), dtype=np.float32)).to(dev).to(
        DTYPES[cfg.act_dtype])


def n2_moe_layer(cfg, dev, mesh=None, specs=None) -> dict:
    """The MoE leaves of N2's one layer as init_params draws them (with a
    mesh, this rank's shards), drawn leaf by leaf."""
    from repro_torch.models.params import draw_leaf
    shards = dict(tree_items(specs)) if specs else {}
    return {path.rsplit(".", 1)[1]: draw_leaf(
                cfg, path, SEED + 51, dev, shards.get(path), mesh)[0]
            for path, _ in tree_items(param_specs(cfg))
            if path.startswith("layers.moe.")}


def n2_rank(rank: int) -> dict:
    """One MoE layer at Kimi-K2's widths on this rank's 4096 tokens: EP on
    a (data 4, model 1) mesh (96 experts a rank, each rank its own rows),
    then TP on (1, 4) (each expert's FFN split in 4 over the model peers,
    which share rank 0's rows); the experts drawn as this rank's
    shards."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe
    from repro_torch.models.params import abstract_params, logical_axes
    dev = torch.device("cuda", 0)
    cfg = n2_config()
    out = {}
    for kind, shape in (("ep", (N2_RANKS, 1)), ("tp", (1, N2_RANKS))):
        mesh = Mesh(shape, ("data", "model"))
        specs = sharding.tree_specs(logical_axes(cfg), abstract_params(cfg),
                                    mesh)
        layer = n2_moe_layer(cfg, dev, mesh, specs)
        held = sum(t.numel() * t.element_size() for t in layer.values())
        # the batch's rows follow the data coordinate: TP's model peers
        # share theirs
        x = n2_tokens(mesh.axis_index("data"), cfg, dev)
        torch.cuda.reset_peak_memory_stats()
        with sharding.use(mesh, specs), Tap(
                moe, "_slots", lambda a, kw, o: (a[1].cpu(), o.cpu())) as tap:
            K7.launches = K3.launches = 0
            (y, _), secs, coll, staged = _timed(
                lambda: moe.moe_layer(cfg, layer, x))
            launches = {"K7": K7.launches, "K3": K3.launches}
        out[kind] = {"mesh": list(shape), "y": y.cpu(),
                     "rows_of": mesh.axis_index("data"),
                     "ids": tap.calls[0][0], "dst": tap.calls[0][1],
                     "launches": launches, "seconds": secs,
                     "collective_s": coll, "staged_bytes": staged,
                     "expert_bytes": held,
                     "peak_bytes": torch.cuda.max_memory_allocated()}
        del layer, x, y
        torch.cuda.empty_cache()
    out["peak_bytes"] = max(out[k]["peak_bytes"] for k in ("ep", "tp"))
    return out


def n3_rank(rank: int, batches: list, ref_path: str) -> dict:
    """FSDP training of Mamba2-1.3B uncut on a (data 2, model 1) mesh:
    each rank draws its shards and trains on its rows of the global
    batch. Each step's reduced gradient shards (what ``reduce_grads``
    returns inside the step) are held leaf by leaf against the
    one-process gradient of the same step over the same row blocks;
    after the last step the params are held where the gradients are
    well above their error (:func:`n3_hold_params`)."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.params import init_params
    torch.backends.cuda.matmul.allow_tf32 = False   # as the reference step
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_config(N_ARCH)
    mesh = Mesh((N3_RANKS, 1), ("data", "model"))
    specs = api.state_specs(cfg, mesh)
    pspecs = dict(tree_items(specs["params"]))
    state = api.make_train_state(cfg, init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 30), dev, mesh,
        specs["params"]))
    step_fn = api.make_train_step(cfg, mesh=mesh, specs=specs)
    ref = torch.load(ref_path, mmap=True)
    per = TRAIN_BATCH // N3_RANKS
    lo = mesh.axis_index("data") * per
    steps, grads = [], []
    for i, b in enumerate(batches):
        rows = {k: torch.from_numpy(v[lo:lo + per]).to(dev)
                for k, v in b.items()}
        K4.launches = K4.reverse_launches = K4.da_launches = 0
        K7.launches = K3.launches = 0
        with Tap(api, "reduce_grads", lambda a, kw, o: o) as tap:
            (state, metrics), secs, coll, staged = _timed(
                lambda: step_fn(state, rows))
        got = dict(tree_items(tap.calls[0]))
        del tap
        err, ratio = n3_grad_errors(got, ref["grads"][i], ref["gmax"][i],
                                    pspecs, mesh, dev)
        grads.append({p: g.cpu() for p, g in got.items()})
        del got
        steps.append({"step": i, "seconds": secs, "collective_s": coll,
                      "compute_s": secs - coll, "staged_bytes": staged,
                      "loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"]),
                      "grad_ratio_by_leaf": ratio,
                      "grad_err_by_leaf": err,
                      "launches": {"K4 forward": K4.launches,
                                   "K4 reverse": K4.reverse_launches,
                                   "K4 da": K4.da_launches,
                                   "K7": K7.launches, "K3": K3.launches}})
    lr = float(api._optimizer(cfg).lr(len(batches) - 1))
    held = n3_hold_params(state["params"], grads, ref, pspecs, mesh, lr, dev)
    return {"steps": steps, "lr_last_step": lr, **held,
            "shard_bytes": sum(t.numel() * t.element_size()
                               for t in tree_leaves(state))}


def n3_grad_errors(got: dict, ref_grads: dict, ref_gmax: dict, pspecs,
                   mesh, dev) -> tuple[dict, dict]:
    """Each leaf's max |got − ref| on this rank's shard ``got``, and that
    over the one-process gradient's max |g| (of the whole leaf)."""
    from repro_torch.distributed import sharding
    err, ratio = {}, {}
    for path, g in got.items():
        want = sharding.local_shard(ref_grads[path], pspecs[path],
                                    mesh).to(dev)
        err[path] = float((g.float() - want.float()).abs().max())
        ratio[path] = err[path] / (ref_gmax[path] or 1.0)
    return err, ratio


def n3_hold_params(params, grads, ref, pspecs, mesh, lr, dev) -> dict:
    """The params after N3's two steps against the one-process run's.
    lr(0) = 0, so step 0 leaves the params as they are and step 1 moves
    them by lr·(u + wd·p), with AdamW's u = m̂/√v̂ of both steps' clipped
    gradients. For β = (0.9, 0.95), |∂u/∂g_k| ≤ 1.8/max(|g0|, |g1|), so
    where N3_DU_SLOPE·(|δg0| + |δg1|) (this rank's gradients against the
    reference's, element by element) is at most N3_HELD_REL of
    max(|g0|, |g1|), |δu| ≤ 1/16 + 0.028 (the clipped gradients'
    bf16 roundings, one ulp each) + 0.003 (the two clip scales, the
    gradient norms ≤ 1e-3 apart) < N3_UPDATE_TOL, and the params are
    then within one bf16 ulp + N3_UPDATE_TOL·lr; a gradient of the wrong
    sign moves a param up to 2·lr away. Every param must be finite."""
    from repro_torch.distributed import sharding
    held = outside = total = beyond = 0
    finite = True
    worst = 0.0
    for path, got in tree_items(params):
        spec = pspecs[path]

        def shard(t):
            return sharding.local_shard(t, spec, mesh).to(dev).float()
        want = shard(ref["params"][path])
        g0r, g1r = (shard(ref["grads"][i][path]) for i in (0, 1))
        dg = ((grads[0][path].to(dev).float() - g0r).abs()
              + (grads[1][path].to(dev).float() - g1r).abs())
        mask = N3_DU_SLOPE * dg <= N3_HELD_REL * torch.maximum(g0r.abs(),
                                                               g1r.abs())
        got = got.float()
        finite = finite and bool(torch.isfinite(got).all())
        diff = (got - want).abs()
        excess = diff - bf16_ulp(torch.maximum(got.abs(), want.abs()))
        beyond += int((~(excess <= 0)).sum())
        outside += int((~(excess <= N3_UPDATE_TOL * lr) & mask).sum())
        if mask.any():
            worst = max(worst, float(excess[mask].max()) / lr)
        held += int(mask.sum())
        total += got.numel()
    return {"params_finite": finite, "params_held": held,
            "params_total": total, "params_beyond_1ulp": beyond,
            "params_outside_bound": outside,
            "worst_beyond_ulp_over_lr": worst}


def n4_rank(rank: int, tokens: np.ndarray) -> dict:
    """Mamba2-1.3B's forward in 4 stages of 12 layers at full width
    (gpipe_forward), 8 microbatches of (1, 2048) tokens; the last stage
    returns its outputs."""
    from repro_torch.distributed.pipeline import gpipe_forward
    from repro_torch.launch.mesh import Mesh
    dev = torch.device("cuda", 0)
    cfg = get_config(N_ARCH)
    mesh = Mesh((N4_STAGES,), ("stage",))
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 53), dev)
    per = cfg.n_layers // N4_STAGES
    lo = rank * per
    mine = tree_map(lambda a: a[lo:lo + per].clone(), params["layers"])
    with torch.no_grad():
        mbs = torch.stack([M._embed(cfg, params, {"tokens": torch.from_numpy(
            t).to(dev)}) for t in tokens])
    del params
    torch.cuda.empty_cache()
    positions = torch.arange(N4_SEQ, dtype=torch.int32, device=dev)
    active = []

    def stage(lp, x):
        active.append(1)
        for i in range(per):
            x, _ = M.block(cfg, M._layer(lp, i), x, positions)
        return x
    K4.launches = 0
    with torch.no_grad():
        outs, secs, coll, staged = _timed(lambda: gpipe_forward(
            stage, mine, mbs, mesh.group("stage"), N4_STAGES))
    ticks = N4_MICRO + N4_STAGES - 1
    return {"K4": K4.launches, "active_ticks": len(active), "ticks": ticks,
            "idle_ticks": ticks - len(active), "seconds": secs,
            "collective_s": coll, "staged_bytes": staged,
            "outs": outs.cpu() if rank == N4_STAGES - 1 else None}


def n5_rank(rank: int) -> dict:
    """I's tenant A through Scheduler(mesh=, mesh_axis="parts") on 2
    ranks: 16 fuse(c0_scale, c0_add) requests of 2²² float32, one
    coalesced batch, each rank's chunk one call_batch (one
    k1_batch_kernel); every result held against its solo K1 launch."""
    from repro_torch.launch.mesh import Mesh
    dev = torch.device("cuda", 0)
    mesh = Mesh((N5_RANKS,), ("parts",))
    arrays = make_inputs(SEED + 56, [N_SCHED_ITEM] * (2 * N_SCHED_ITEMS),
                         dev)
    xs, bs = arrays[:N_SCHED_ITEMS], arrays[N_SCHED_ITEMS:]
    fused = isa.fuse("c0_scale", "c0_add")
    q = RequestQueue()
    items = [q.submit(fused, (SCALE, x, b), tenant="A")
             for x, b in zip(xs, bs)]
    sched = Scheduler(q, cost=CostModel(hierarchy=H100), policy="wfq",
                      clock="wall", mesh=mesh, mesh_axis="parts",
                      mode="kernel")
    K1.launches = 0
    rep, secs, coll, staged = _timed(sched.drain)
    launches = K1.launches
    exact = all(torch.equal(rep.results[it.seq],
                            fused(SCALE, x, b, mode="kernel"))
                for it, x, b in zip(items, xs, bs))
    return {"K1": launches, "bit_exact_vs_solo": exact, "seconds": secs,
            "collective_s": coll, "staged_bytes": staged,
            "n_lanes": sched.n_lanes,
            "placements": [(p.seq, p.lane, p.round, p.batch_seq,
                            p.coalesced, p.channel) for p in rep.placements]}


def _captured(fn, argv):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(argv)
    return buf.getvalue(), ret


def n6_rank(rank: int, runs: list) -> dict:
    """The entry points on this world: ("train" | "serve", argv) each."""
    out = []
    for kind, argv in runs:
        text, ret = _captured(train.main if kind == "train" else serve.main,
                              argv)
        out.append({"text": text, "tokens": None if kind == "train"
                    else np.asarray(ret)})
    return {"runs": out}


def n7a_grad_config(cfg):
    """N7a's gradient cut: TRAIN_GRAD_LAYERS layers in float32, every
    width published (as phase L's)."""
    return dataclasses.replace(cfg, n_layers=TRAIN_GRAD_LAYERS,
                               param_dtype="float32", act_dtype="float32")


def n7a_rank(rank: int, batches: list, ref_path: str) -> dict:
    """Mamba2-1.3B trained uncut with its dense layers split over
    ``model`` on a (data 1, model 2) mesh under SP: each rank draws its
    shards (its 32 of 64 SSM heads, its half of the vocabulary) and
    trains on the whole batch, each layer's scans on its heads. Then the
    2-layer float32 gradient cut of the parent's saved params and batch,
    its reduced shards held against the parent's one-process gradient
    leaf by leaf."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.params import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_config(N_ARCH)
    mesh = Mesh(N7_MESH, ("data", "model"))
    specs = api.state_specs(cfg, mesh)
    state = api.make_train_state(cfg, init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 70), dev, mesh,
        specs["params"]))
    step_fn = api.make_train_step(cfg, mesh=mesh, specs=specs)
    steps = []
    for i, b in enumerate(batches):
        rows = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        K4.launches = K4.reverse_launches = K4.da_launches = 0
        K7.launches = K3.launches = K8.launches = 0
        with Tap(ps, "chunk_scan_state_kernel",
                 lambda a, kw, o: tuple(o.shape)) as t4:
            (state, metrics), secs, coll, staged = _timed(
                lambda: step_fn(state, rows))
        steps.append({"step": i, "seconds": secs, "collective_s": coll,
                      "compute_s": secs - coll, "staged_bytes": staged,
                      "loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"]),
                      "k4_shapes": sorted(set(t4.calls)),
                      "launches": {"K4 forward": K4.launches,
                                   "K4 reverse": K4.reverse_launches,
                                   "K4 da": K4.da_launches,
                                   "K7": K7.launches, "K3": K3.launches,
                                   "K8": K8.launches}})
        del metrics
    peak = torch.cuda.max_memory_allocated()
    del state, step_fn
    torch.cuda.empty_cache()
    # the gradient cut
    ref = torch.load(ref_path, mmap=True)
    gcfg = n7a_grad_config(cfg)
    gspecs = api.state_specs(gcfg, mesh)["params"]
    flat = dict(tree_items(gspecs))
    params = {}
    for path, spec in flat.items():
        node = params
        *parents, leaf = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = sharding.local_shard(ref["params"][path], spec,
                                          mesh).contiguous().to(dev)
    batch = {k: v.to(dev) for k, v in ref["batch"].items()}
    with sharding.use(mesh, gspecs):
        grads, metrics = api.make_grad_fn(gcfg)(params, batch)
    grads = api.reduce_grads(grads, gspecs, mesh)
    ratio = {}
    for path, g in tree_items(grads):
        want = sharding.local_shard(ref["grads"][path], flat[path],
                                    mesh).to(dev)
        ratio[path] = (float((g.double() - want.double()).abs().max())
                       / max(ref["gmax"][path], 1e-30))
    return {"steps": steps, "peak_bytes": peak, "grad_ratio_by_leaf": ratio,
            "grad_loss": float(metrics["loss"])}


def n7b_rank(rank: int, prompts: np.ndarray) -> dict:
    """Llama-3-8B served uncut with its dense layers split over
    ``model`` on a (data 1, model 2) mesh (serve.generate inside
    sharding.use, as serve.main runs it): each rank draws its 8.0 GB of
    shards and prefills the 4 × 2048 prompts (SP: each layer's residual
    the rank's 1024 positions, K8 on its 16 of 32 heads), then 16 greedy
    tokens. Returns prefill's gathered last-position logits, the tokens
    and K8's launches."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.params import (abstract_params, init_params,
                                           logical_axes)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = n7b_config()
    mesh = Mesh(N7_MESH, ("data", "model"))
    specs = sharding.tree_specs(logical_axes(cfg), abstract_params(cfg),
                                mesh)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 72), dev, mesh, specs)
    held = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    prompts = torch.from_numpy(prompts).to(dev)
    with torch.no_grad(), sharding.use(mesh, specs), \
            Tap(serve, "sample") as ts, Tap(fa, "K8",
                                             lambda a, kw, o: tuple(
                                                 a[0].shape)) as t8:
        K8.launches = K4.launches = K7.launches = K3.launches = 0
        (tokens, prefill_s, decode_s), secs, coll, staged = _timed(
            lambda: serve.generate(cfg, params, prompts, N7B_GEN))
        launches = {"K8": K8.launches, "K4": K4.launches,
                    "K7": K7.launches, "K3": K3.launches}
    logits = ts.calls[0][0][0].float().cpu()
    del params, ts
    torch.cuda.empty_cache()
    # the float32 cut: the rank's shards of its own draw, prefill alone
    ccfg = n7b_cut_config()
    cspecs = sharding.tree_specs(logical_axes(ccfg), abstract_params(ccfg),
                                 mesh)
    cut = init_params(ccfg, torch.Generator(device=dev).manual_seed(
        SEED + 77), dev, mesh, cspecs)
    with torch.no_grad(), sharding.use(mesh, cspecs):
        K8.launches = 0
        cut_logits = M.prefill(ccfg, cut, {"tokens": prompts})[0].cpu()
        cut_k8 = K8.launches
    return {"logits": logits, "cut_logits": cut_logits, "cut_k8": cut_k8,
            "tokens": tokens.cpu().numpy(), "launches": launches,
            "k8_shapes": sorted(set(t8.calls)), "seconds": secs,
            "prefill_s": prefill_s, "decode_s": decode_s,
            "collective_s": coll, "compute_s": secs - coll,
            "staged_bytes": staged, "weight_bytes": held}


RANK_CASES = {"N1": n1_rank, "N2": n2_rank, "N3": n3_rank, "N4": n4_rank,
              "N5": n5_rank, "N6": n6_rank, "N7a": n7a_rank,
              "N7b": n7b_rank}


def _rank_peaks(check, case: str, ranks: list[dict]) -> list[int]:
    peaks = [r["peak_bytes"] for r in ranks]
    check.true(f"{case}: rank peaks {peaks} B, limit "
               f"{N_RANK_PEAK[case]:.0f} B",
               max(peaks) < N_RANK_PEAK[case])
    return peaks


def run_n1(dev, check, rows) -> dict:
    """N1's ranks, then, on the parent, each leaf's ring replayed for the
    four ranks at once (``ring_allreduce_plain``): every rank's synced
    leaf bit for bit its replay (their SHA-256s equal), and the replay
    within N1_BOUND of the float64 mean's absmax."""
    C = _collectives()
    ranks = spawn_ranks("N1", N1_RANKS)
    cfg = get_config(N_ARCH)
    base = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 50), dev)
    exact, worst = [True] * N1_RANKS, [0.0] * N1_RANKS
    t0 = time.perf_counter()
    for path, b in tree_items(base):
        stacked = torch.stack([n1_shifted(b, r).float()
                               for r in range(N1_RANKS)])
        mean = stacked[0].double()
        for r in range(1, N1_RANKS):
            mean.add_(stacked[r])           # float64, no temporary
        mean /= N1_RANKS
        scale = float(mean.abs().max()) or 1.0
        want = C.ring_allreduce_plain(stacked).div_(N1_RANKS)
        del stacked
        for r, res in enumerate(ranks):
            w = want[r].to(b.dtype)
            exact[r] = exact[r] and leaf_digest(w) == res["digests"][path]
            worst[r] = max(worst[r], float((w.double() - mean).abs().max())
                           / scale)
        del want, mean, w
    replay_s = time.perf_counter() - t0
    del base
    for r in range(N1_RANKS):
        check.true(f"N1 rank {r}: the pod sync is not bit for bit the "
                   f"ring's plain replay", exact[r])
        check.true(f"N1 rank {r}: {worst[r]} of the mean's absmax, bound "
                   f"{N1_BOUND}", worst[r] < N1_BOUND)
    return {"mesh": [N1_RANKS, 1, 1], "model": N_ARCH, "reduced": [],
            "delta": N1_DELTA, "param_bytes": ranks[0]["param_bytes"],
            "leaves": len(ranks[0]["digests"]),
            "seconds": [r["seconds"] for r in ranks],
            "collective_s": [r["collective_s"] for r in ranks],
            "staged_bytes": [r["staged_bytes"] for r in ranks],
            "bit_exact_vs_plain": exact, "worst_err_over_absmax": worst,
            "replay_s": replay_s,
            "rank_peak_bytes": _rank_peaks(check, "N1", ranks),
            "spawn_s": ranks[0]["spawn_s"]}


def run_n2(dev, check, rows) -> dict:
    from repro_torch.models import moe
    cfg = n2_config()
    d = cfg.d_model
    # the reference: every expert on one process, each rank's tokens
    layer = n2_moe_layer(cfg, dev)
    refs = []
    for r in range(N2_RANKS):
        x = n2_tokens(r, cfg, dev)
        with Tap(moe, "_slots", lambda a, kw, o: (a[1].cpu(), o.cpu())) as t:
            y, _ = moe._dispatch_combine(cfg, x.reshape(-1, d), layer)
        refs.append((y.reshape(x.shape).cpu(), *t.calls[0]))
        del x, y
    ref_peak = torch.cuda.max_memory_allocated(dev)
    del layer
    torch.cuda.empty_cache()
    ranks = spawn_ranks("N2", N2_RANKS)
    out = {"model": LM_ARCH, "reduced": ["n_layers 61 → 1: one MoE layer"],
           "tokens_per_rank": LM_BATCH * LM_PROMPT,
           "reference_peak_bytes": ref_peak, "tolerance_bf16_ulps": N2_ULPS}
    for kind in ("ep", "tp"):
        worst, info = 0.0, []
        for r, res in enumerate(ranks):
            got = res[kind]
            want, ids, dst = refs[got["rows_of"]]
            check.true(f"N2 {kind} rank {r}: routing ids differ",
                       torch.equal(got["ids"], ids))
            check.true(f"N2 {kind} rank {r}: dispatch slots differ",
                       torch.equal(got["dst"], dst))
            check.true(f"N2 {kind} rank {r}: launches {got['launches']}, "
                       f"want K7 and K3 once", got["launches"] ==
                       {"K7": 1, "K3": 1})
            g, w = got["y"].float(), want.float()
            row = w.abs().amax(dim=-1, keepdim=True)
            ratio = float(((g - w).abs() / (row * 2.0 ** -8)).max())
            worst = max(worst, ratio)
            info.append({k: got[k] for k in ("launches", "seconds",
                                              "collective_s", "staged_bytes",
                                              "expert_bytes", "peak_bytes")})
        check.true(f"N2 {kind}: outputs {worst} bf16 ulps (at each row's "
                   f"max) from the one-process layer, bound {N2_ULPS}",
                   worst <= N2_ULPS)
        out[kind] = {"mesh": ranks[0][kind]["mesh"], "worst_ulps": worst,
                     "ranks": info}
    out["rank_peak_bytes"] = _rank_peaks(check, "N2", ranks)
    out["spawn_s"] = ranks[0]["spawn_s"]
    # K7 and K3 at the path's shapes (router logits, slot scan)
    x = torch.from_numpy(np.random.default_rng(SEED + 57).standard_normal(
        ROUTER_SHAPE, dtype=np.float32)).to(dev)
    vals, _ = tk.K7(x, ROUTER_K, 512)
    pv, _ = tk.topk_plain(tk.pad_to(x, 512), ROUTER_K)
    rows.append(topk_row(
        f"N2 topk {ROUTER_SHAPE} in place of 512 float32 k={ROUTER_K} "
        f"(router on each rank's tokens, EP and TP)",
        ranks[0]["ep"]["launches"]["K7"] + ranks[0]["tp"]["launches"]["K7"],
        max_abs(vals, pv), x, ROUTER_K, 512,
        launches_counted_in="phase N2, one rank (EP and TP calls)"))
    e, tk_ = ROUTER_SHAPE[1], ROUTER_SHAPE[0] * ROUTER_K
    ids = torch.randint(0, e, (tk_,), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            SEED + 58))
    x3 = torch.nn.functional.one_hot(ids.long(), e).float().T.contiguous()
    got3 = ps.prefix_sum_kernel(x3)
    plain3 = ps.prefix_sum_kernel(x3, interpret=True)
    rows.append(entry(
        f"N2 prefix_sum {tuple(x3.shape)} float32 (router slots on each "
        f"rank's tokens)",
        ranks[0]["ep"]["launches"]["K3"] + ranks[0]["tp"]["launches"]["K3"],
        max_abs(got3, plain3),
        time_ms(lambda: ps.prefix_sum_kernel(x3)),
        time_ms(lambda: ps.prefix_sum_kernel(x3, interpret=True), reps=5),
        8 * x3.numel(), x3.numel(), time_ms(lambda: torch.cumsum(x3, 1)),
        kernel="K3", block=list(ps.block_shape(*x3.shape)),
        launches_counted_in="phase N2, one rank (EP and TP calls)"))
    del x, vals, pv, x3, got3, plain3
    return out


def run_n3(dev, check, rows) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(N_ARCH)
    data = SyntheticLMData(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, SEED + 55)
    batches = [data.host_batch(i) for i in range(N3_STEPS)]
    # the reference, on one process: the same two steps with the batch
    # in the ranks' row blocks (grad_accum = N3_RANKS: microbatch r is
    # rank r's rows, their gradients summed in float32), each step's
    # gradient as it enters the clip; and, for the record, each step's
    # gradient of the whole batch at once (phase L's path), at the init
    # params, which step 1 sees too (lr(0) = 0)
    state = api.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 30), dev)
    whole = []
    for b in batches:
        g, m = api.make_grad_fn(cfg)(state["params"], to_device(b, dev))
        whole.append(({p: t.cpu() for p, t in tree_items(g)},
                      float(m["loss"])))
        del g, m
    step_fn = api.make_train_step(cfg, grad_accum=N3_RANKS)
    ref_steps, ref_grads, ref_gmax = [], [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        with Tap(api, "clip_by_global_norm", lambda a, kw, o: a[0]) as tap:
            state, metrics = step_fn(state, to_device(b, dev))
        torch.cuda.synchronize()
        split = dict(tree_items(tap.calls[0]))
        del tap
        gmax = {p: float(g.abs().max()) for p, g in split.items()}
        ref_steps.append({
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "seconds": time.perf_counter() - t0,
            "whole_batch_loss": whole[i][1],
            "whole_batch_vs_split_ratio_by_leaf": {
                p: float((whole[i][0][p].to(dev).float() - g).abs().max())
                / (gmax[p] or 1.0) for p, g in split.items()}})
        ref_grads.append({p: g.cpu() for p, g in split.items()})
        ref_gmax.append(gmax)
        del split
    del whole
    ref_path = ROOT / "build" / "n3_reference.pt"
    torch.save({"params": {path: t.cpu() for path, t in
                           tree_items(state["params"])},
                "grads": ref_grads, "gmax": ref_gmax}, ref_path)
    ref_peak = torch.cuda.max_memory_allocated(dev)
    del state, metrics, ref_grads
    torch.cuda.empty_cache()
    try:
        ranks = spawn_ranks("N3", N3_RANKS, batches, str(ref_path))
    finally:
        ref_path.unlink(missing_ok=True)
    n_l = cfg.n_layers
    for r, res in enumerate(ranks):
        s0 = res["steps"][0]
        check.true(f"N3 rank {r} step 0: loss {s0['loss']} vs "
                   f"{ref_steps[0]['loss']}, rtol {N3_LOSS_RTOL}",
                   abs(s0["loss"] - ref_steps[0]["loss"])
                   <= N3_LOSS_RTOL * abs(ref_steps[0]["loss"]))
        for i, st in enumerate(res["steps"]):
            check.true(f"N3 rank {r} step {i}: grad norm {st['grad_norm']} "
                       f"vs {ref_steps[i]['grad_norm']}, rtol "
                       f"{N3_GNORM_RTOL}",
                       abs(st["grad_norm"] - ref_steps[i]["grad_norm"])
                       <= N3_GNORM_RTOL * ref_steps[i]["grad_norm"])
            check.true(f"N3 rank {r} step {i}: launches {st['launches']}, "
                       f"want K4 {2 * n_l} forward, {n_l} reverse and "
                       f"{n_l} da passes",
                       st["launches"] == {"K4 forward": 2 * n_l,
                                          "K4 reverse": n_l, "K4 da": n_l,
                                          "K7": 0, "K3": 0})
            bad = {k: v for k, v in st["grad_ratio_by_leaf"].items()
                   if not v <= N3_GRAD_REL}
            check.true(f"N3 rank {r} step {i}: reduced gradient leaves over "
                       f"{N3_GRAD_REL} of the one-process gradient's max "
                       f"|g|: {bad}", not bad)
        check.true(f"N3 rank {r}: a param is not finite after step "
                   f"{N3_STEPS - 1}", res["params_finite"])
        check.true(f"N3 rank {r}: {res['params_outside_bound']} of "
                   f"{res['params_held']} held params beyond one bf16 ulp "
                   f"plus {N3_UPDATE_TOL}·lr of the one-process run's after "
                   f"step {N3_STEPS - 1}", res["params_outside_bound"] == 0)
        check.true(f"N3 rank {r}: {res['params_held']} of "
                   f"{res['params_total']} params held, want at least half",
                   res["params_held"] >= res["params_total"] / 2)
    out = {"mesh": [N3_RANKS, 1], "model": N_ARCH, "reduced": [],
           "global_batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "reference_steps": ref_steps, "reference_peak_bytes": ref_peak,
           "grad_bound_of_max": N3_GRAD_REL,
           "update_tol_lr": N3_UPDATE_TOL,
           "ranks": [{"steps": res["steps"],
                      "worst_grad_ratio": [max(st["grad_ratio_by_leaf"]
                                               .values())
                                           for st in res["steps"]],
                      "params_held": res["params_held"],
                      "params_held_share": res["params_held"]
                      / res["params_total"],
                      "params_outside_bound": res["params_outside_bound"],
                      "params_share_beyond_1ulp": res["params_beyond_1ulp"]
                      / res["params_total"],
                      "worst_beyond_ulp_over_lr":
                          res["worst_beyond_ulp_over_lr"],
                      "lr_last_step": res["lr_last_step"],
                      "shard_bytes": res["shard_bytes"]} for res in ranks],
           "rank_peak_bytes": _rank_peaks(check, "N3", ranks),
           "rank_peak_limit_bytes": N_RANK_PEAK["N3"],
           "spawn_s": ranks[0]["spawn_s"]}
    shape = (TRAIN_BATCH // N3_RANKS, TRAIN_SEQ // cfg.ssm_chunk,
             cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
    out["k4_at_rank_shape"] = hold_train_scan(
        dev, check, rows, shape, ranks[0]["steps"][-1]["launches"],
        label="N3", counted_in="a phase N3 FSDP step on one rank (48 layers)")
    return out


def run_n4(dev, check, rows) -> dict:
    from repro_torch.distributed.pipeline import bubble_fraction
    cfg = get_config(N_ARCH)
    rng = np.random.default_rng(SEED + 59)
    tokens = rng.integers(0, cfg.vocab, (N4_MICRO, 1, N4_SEQ)).astype(
        np.int64)
    # the reference: each microbatch through the 48 layers on one process
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 53), dev)
    positions = torch.arange(N4_SEQ, dtype=torch.int32, device=dev)
    refs = []
    with torch.no_grad():
        for t in tokens:
            x = M._embed(cfg, params, {"tokens": torch.from_numpy(t).to(dev)})
            for i in range(cfg.n_layers):
                x, _ = M.block(cfg, M._layer(params["layers"], i), x,
                               positions)
            refs.append(x.cpu())
    del params, x
    torch.cuda.empty_cache()
    ranks = spawn_ranks("N4", N4_STAGES, tokens)
    last = ranks[-1]["outs"]
    same = torch.equal(last, torch.stack(refs))
    check.true("N4: the last stage's outputs are not bit-identical to the "
               "one-process forward", same)
    per = cfg.n_layers // N4_STAGES
    for r, res in enumerate(ranks):
        check.true(f"N4 stage {r}: K4 {res['K4']} launches over "
                   f"{res['active_ticks']} active ticks, want {per} each of "
                   f"{N4_MICRO}", res["K4"] == per * N4_MICRO
                   and res["active_ticks"] == N4_MICRO)
    # K4 at a stage's shape
    shape = (1, N4_SEQ // cfg.ssm_chunk, cfg.ssm_heads, cfg.ssm_headdim,
             cfg.ssm_state)
    a, s = ssd_inputs(SEED + 60, shape[:3], shape[3:], dev)
    rows.append(k4_row(check, "N4", a, s, ranks[0]["K4"],
                       "chunk_scan_state (a GPipe stage's layer)",
                       "phase N4, one stage (12 layers × 8 ticks)"))
    del a, s
    return {"stages": N4_STAGES, "microbatches": N4_MICRO,
            "tokens_per_microbatch": N4_SEQ, "model": N_ARCH, "reduced": [],
            "bit_identical_to_one_process": same,
            "bubble_fraction": bubble_fraction(N4_STAGES, N4_MICRO),
            "ticks": ranks[0]["ticks"],
            "idle_ticks": [r["idle_ticks"] for r in ranks],
            "measured_idle_share": [r["idle_ticks"] / r["ticks"]
                                    for r in ranks],
            "K4_launches": [r["K4"] for r in ranks],
            "seconds": [r["seconds"] for r in ranks],
            "collective_s": [r["collective_s"] for r in ranks],
            "staged_bytes": [r["staged_bytes"] for r in ranks],
            "rank_peak_bytes": _rank_peaks(check, "N4", ranks),
            "spawn_s": ranks[0]["spawn_s"]}


def run_n5(dev, check, rows) -> dict:
    ranks = spawn_ranks("N5", N5_RANKS)
    for r, res in enumerate(ranks):
        check.true(f"N5 rank {r}: results not bit-exact against their solo "
                   f"K1 launches", res["bit_exact_vs_solo"])
        check.true(f"N5 rank {r}: {res['K1']} K1 launches, want one "
                   f"k1_batch_kernel", res["K1"] == 1)
        check.true(f"N5 rank {r}: {res['n_lanes']} lanes, want "
                   f"{N5_RANKS}", res["n_lanes"] == N5_RANKS)
    check.true("N5: the ranks' placements differ",
               all(r["placements"] == ranks[0]["placements"]
                   for r in ranks))
    # K1 at a rank's chunk: half the requests in one call_batch
    arrays = make_inputs(SEED + 56, [N_SCHED_ITEM] * (2 * N_SCHED_ITEMS), dev)
    half = N_SCHED_ITEMS // N5_RANKS
    reqs = [(SCALE, x, b) for x, b in zip(arrays[:half],
                                         arrays[N_SCHED_ITEMS:][:half])]
    prog = isa.fuse("c0_scale", "c0_add").program
    got = prog.call_batch(reqs)
    plain = prog.call_batch(reqs, interpret=True)
    x2 = torch.stack([r[1] for r in reqs])
    b2 = torch.stack([r[2] for r in reqs])
    n = N_SCHED_ITEM * half
    rows.append(entry(
        f"N5 sched lanes: call_batch {half}x scale+add on one rank",
        ranks[0]["K1"], max(max_abs(g, p) for g, p in zip(got, plain)),
        time_ms(lambda: prog.call_batch(reqs)),
        time_ms(lambda: prog.call_batch(reqs, interpret=True)),
        12 * n, 2 * n, time_ms(lambda: torch.add(b2, x2, alpha=SCALE)),
        launches_counted_in="phase N5, one rank's scheduler run"))
    del arrays, reqs, got, plain, x2, b2
    return {"mesh": [N5_RANKS], "axis": "parts",
            "requests": N_SCHED_ITEMS, "elements": N_SCHED_ITEM,
            "K1_launches": [r["K1"] for r in ranks],
            "placements": ranks[0]["placements"],
            "seconds": [r["seconds"] for r in ranks],
            "collective_s": [r["collective_s"] for r in ranks],
            "staged_bytes": [r["staged_bytes"] for r in ranks],
            "rank_peak_bytes": _rank_peaks(check, "N5", ranks),
            "spawn_s": ranks[0]["spawn_s"]}


def run_n6(dev, check, rows) -> dict:
    import tempfile
    build = ROOT / "build"
    small = ["--reduced", "--batch", "4", "--seq", "64", "--log-every", "2"]
    serves = [["--arch", "kimi-k2-1t", "--reduced", "--model-parallel", "2",
               "--gen", "8", "--prompt-len", "32"],
              ["--arch", "mamba2-1.3b", "--reduced", "--gen", "8",
               "--prompt-len", "32"]]
    # --sched --slo-shed on 2 ranks (2x1): a per-token target every step
    # misses, so rank 0's monitor sheds, and every rank sheds with it
    shed_run = ["--arch", "mamba2-1.3b", "--reduced", "--gen", "8",
                "--prompt-len", "32", "--sched", "--slo-shed", "--slo-ms",
                str(N6_SLO_MS)]
    alone = [_captured(serve.main, argv) for argv in serves]
    with tempfile.TemporaryDirectory(dir=build) as d:
        four = spawn_ranks("N6", 4, [
            ("train", ["--arch", arch, "--steps", "4", "--model-parallel",
                       "2", "--ckpt-dir", os.path.join(d, arch),
                       "--ckpt-every", "2", *small])
            for arch in ("mamba2-1.3b", "kimi-k2-1t")] + [
            ("train", ["--arch", "mamba2-1.3b", "--steps", "2",
                       "--model-parallel", "2", "--pod-sync-every", "2",
                       *small])])
        two = spawn_ranks("N6", 2, [
            ("train", ["--arch", arch, "--steps", "6", "--model-parallel",
                       "1", "--ckpt-dir", os.path.join(d, arch),
                       "--ckpt-every", "2", *small])
            for arch in ("mamba2-1.3b", "kimi-k2-1t")] + [
            ("serve", argv) for argv in serves + [shed_run]])
    texts = [r["text"] for r in four[0]["runs"]]
    for t in texts:
        check.true("N6 train.main on 4 ranks: no 2x2 mesh or no end",
                   "mesh 2x2" in t and "done: final loss" in t)
    for t in (r["text"] for r in two[0]["runs"][:2]):
        check.true("N6 resume on 2 ranks: 'resumed from step 4' on a 2x1 "
                   "mesh not printed", "resumed from step 4 on mesh 2x1" in t)
    for i, ((_, want), mesh) in enumerate(zip(alone, ("1x2", "2x1"))):
        for r, res in enumerate(two):
            run = res["runs"][2 + i]
            check.true(f"N6 serve {serves[i][1]} rank {r}: mesh {mesh} not "
                       f"printed", f"mesh {mesh}" in run["text"])
            check.true(f"N6 serve {serves[i][1]} rank {r}: greedy tokens "
                       f"differ from one process's",
                       np.array_equal(run["tokens"], np.asarray(want)))
    shed = [n6_shed_steps(r["runs"][2 + len(serves)]["text"]) for r in two]
    check.true(f"N6 serve --slo-shed on 2 ranks: shed steps {shed}, want "
               f"the same on every rank and at least one",
               shed[0] and all(x == shed[0] for x in shed))
    check.true("N6 serve --slo-shed on 2 ranks: tokens differ between "
               "ranks", all(np.array_equal(r["runs"][-1]["tokens"],
                                           two[0]["runs"][-1]["tokens"])
                            for r in two))
    return {"train_4_ranks": texts,
            "resume_2_ranks": [r["text"] for r in two[0]["runs"][:2]],
            "serve_2_ranks": [r["text"] for r in two[0]["runs"][2:]],
            "slo_shed_steps": shed,
            "rank_peak_bytes": _rank_peaks(check, "N6", four + two),
            "spawn_s": [four[0]["spawn_s"], two[0]["spawn_s"]]}


def run_n7a(dev, check, rows) -> dict:
    """N7a: the one-process references on the parent — each step's loss
    at the init params (lr 0 at step 0, so step 1 sees them too) and
    the 2-layer float32 gradient cut with carrying decays — then the
    ranks, then K4 at a rank's (2, 16, 32, 64, 128) as phase L holds
    it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(N_ARCH)
    n_l = cfg.n_layers
    data = SyntheticLMData(cfg.vocab, TRAIN_SEQ, N7A_BATCH, SEED + 71)
    batches = [data.host_batch(i) for i in range(N7A_STEPS)]
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 70), dev)
    ref_losses = []
    with torch.no_grad():
        for b in batches:
            loss, _ = M.loss_fn(cfg, params, to_device(b, dev))
            ref_losses.append(float(loss))
    del params
    torch.cuda.empty_cache()
    gcfg = n7a_grad_config(cfg)
    gparams = M.init_params(gcfg, torch.Generator(device=dev).manual_seed(
        SEED + 73), dev)
    carrying_decays(gparams, gcfg.ssm_chunk, SEED + 74)
    gbatch = to_device(batches[0], dev)
    grads, metrics = api.make_grad_fn(gcfg)(gparams, gbatch)
    ref_path = ROOT / "build" / "n7a_reference.pt"
    torch.save({"params": {p: t.cpu() for p, t in tree_items(gparams)},
                "grads": {p: g.cpu() for p, g in tree_items(grads)},
                "gmax": {p: float(g.abs().max())
                         for p, g in tree_items(grads)},
                "batch": {k: v.cpu() for k, v in gbatch.items()}}, ref_path)
    grad_loss = float(metrics["loss"])
    ref_peak = torch.cuda.max_memory_allocated(dev)
    del gparams, grads, metrics, gbatch
    torch.cuda.empty_cache()
    try:
        ranks = spawn_ranks("N7a", N7_MESH[1], batches, str(ref_path))
    finally:
        ref_path.unlink(missing_ok=True)
    shape = (N7A_BATCH, TRAIN_SEQ // cfg.ssm_chunk,
             cfg.ssm_heads // N7_MESH[1], cfg.ssm_headdim, cfg.ssm_state)
    want_launches = {"K4 forward": 2 * n_l, "K4 reverse": n_l,
                     "K4 da": n_l, "K7": 0, "K3": 0, "K8": 0}
    for r, res in enumerate(ranks):
        for i, st in enumerate(res["steps"]):
            check.true(f"N7a rank {r} step {i}: loss {st['loss']} vs one "
                       f"process's {ref_losses[i]}, rtol {N7A_LOSS_RTOL}",
                       abs(st["loss"] - ref_losses[i])
                       <= N7A_LOSS_RTOL * abs(ref_losses[i]))
            check.true(f"N7a rank {r} step {i}: launches {st['launches']}, "
                       f"want {want_launches}",
                       st["launches"] == want_launches)
            check.true(f"N7a rank {r} step {i}: K4 scanned {st['k4_shapes']}"
                       f", want {shape} only",
                       st["k4_shapes"] == [shape])
        bad = {k: v for k, v in res["grad_ratio_by_leaf"].items()
               if not v <= TRAIN_GRAD_REL}
        check.true(f"N7a rank {r}: gradient cut leaves over {TRAIN_GRAD_REL}"
                   f" of one process's max |g|: {bad}", not bad)
        check.true(f"N7a rank {r}: gradient cut loss {res['grad_loss']} vs "
                   f"{grad_loss}", abs(res["grad_loss"] - grad_loss)
                   <= TRAIN_GRAD_REL * abs(grad_loss))
    out = {"mesh": list(N7_MESH), "model": N_ARCH, "reduced": [],
           "batch": N7A_BATCH, "seq": TRAIN_SEQ, "sp": cfg.sp,
           "one_process_losses": ref_losses, "loss_rtol": N7A_LOSS_RTOL,
           "reference_peak_bytes": ref_peak,
           "grad_cut": {"layers": TRAIN_GRAD_LAYERS, "dtype": "float32",
                        "bound": TRAIN_GRAD_REL, "loss_one_process":
                        grad_loss},
           "ranks": [{"steps": res["steps"],
                      "grad_cut_worst_ratio": max(
                          res["grad_ratio_by_leaf"].values()),
                      "grad_cut_ratio_by_leaf": res["grad_ratio_by_leaf"]}
                     for res in ranks],
           "rank_peak_bytes": _rank_peaks(check, "N7a", ranks),
           "rank_peak_limit_bytes": N_RANK_PEAK["N7a"],
           "spawn_s": ranks[0]["spawn_s"]}
    out["k4_at_rank_shape"] = hold_train_scan(
        dev, check, rows, shape, ranks[0]["steps"][-1]["launches"],
        label="N7a", counted_in="a phase N7a step on one rank (48 layers, "
        "its 32 of 64 heads)")
    return out


def to_float32_(tree: dict) -> None:
    """Every leaf of ``tree`` replaced by its float32 copy, one at a time
    (each bf16 leaf freed as its copy is made)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            to_float32_(v)
        else:
            tree[k] = v.float()


def run_n7b(dev, check, rows) -> dict:
    """N7b: one process serves the same prompts with the same weights
    (bf16, its tokens and prefill logits), then the float32 forward of
    those weights (chunked attention, no TF32) gives the logits both are
    held against, and one process prefills the float32 cut; then the
    ranks; then K8 at a rank's (4, 16, 2048, 128)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = n7b_config()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 72), dev)
    prompts = serve_prompts(SEED + 75, cfg, N7B_BATCH, N7B_PROMPT, dev)
    with torch.no_grad(), Tap(serve, "sample") as ts:
        K8.launches = 0
        t0 = time.perf_counter()
        tokens, prefill_s, decode_s = serve.generate(cfg, params, prompts,
                                                     N7B_GEN)
        one_s = time.perf_counter() - t0
        one_k8 = K8.launches
    one = ts.calls[0][0][0].float()
    del ts
    to_float32_(params)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                act_dtype="float32", attn_impl="chunked")
    with torch.no_grad():
        f32, cache = M.prefill(cfg32, params, {"tokens": prompts})
    del params, cache
    ccfg = n7b_cut_config()
    cut = M.init_params(ccfg, torch.Generator(device=dev).manual_seed(
        SEED + 77), dev)
    with torch.no_grad():
        cut_one = M.prefill(ccfg, cut, {"tokens": prompts})[0]
    del cut
    ref_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()
    ranks = spawn_ranks("N7b", N7_MESH[1], prompts.cpu().numpy())
    n_l = cfg.n_layers
    err_one = max_abs(one, f32)
    shape = (N7B_BATCH, cfg.n_heads // N7_MESH[1], N7B_PROMPT, cfg.head_dim)
    info = []
    for r, res in enumerate(ranks):
        got = res["logits"].to(dev)
        check.shaped(f"N7b rank {r} prefill logits", got,
                     (N7B_BATCH, cfg.vocab))
        check.true(f"N7b rank {r}: prefill logits not finite",
                   bool(torch.isfinite(got).all()))
        err = max_abs(got, f32)
        check.true(f"N7b rank {r}: prefill logits {err} from the float32 "
                   f"forward, over {N7B_F32_FACTOR} × one process's "
                   f"{err_one}", err <= N7B_F32_FACTOR * err_one)
        check.true(f"N7b rank {r}: launches {res['launches']}, want K8 "
                   f"{n_l} and no other",
                   res["launches"] == {"K8": n_l, "K4": 0, "K7": 0, "K3": 0})
        check.true(f"N7b rank {r}: K8 ran on {res['k8_shapes']}, want "
                   f"{shape}", res["k8_shapes"] == [shape])
        check.true(f"N7b rank {r}: logits differ from rank 0's",
                   torch.equal(res["logits"], ranks[0]["logits"]))
        cut_err = max_abs(res["cut_logits"].to(dev), cut_one) / float(
            cut_one.abs().max())
        check.true(f"N7b rank {r}: the float32 {N7B_CUT_LAYERS}-layer cut's "
                   f"logits {cut_err} of their max from one process's, "
                   f"bound {N7B_CUT_REL}", cut_err <= N7B_CUT_REL)
        check.true(f"N7b rank {r}: the cut launched K8 {res['cut_k8']} "
                   f"times, want {N7B_CUT_LAYERS}",
                   res["cut_k8"] == N7B_CUT_LAYERS)
        agree = float(np.mean(res["tokens"] == tokens.cpu().numpy()))
        info.append({"err_vs_float32": err,
                     "cut_err_over_max": cut_err,
                     "err_vs_one_process": max_abs(got, one),
                     "token_agreement_with_one_process": agree,
                     **{k: res[k] for k in (
                         "seconds", "prefill_s", "decode_s", "collective_s",
                         "compute_s", "staged_bytes", "launches",
                         "weight_bytes")}})
        del got
    print(f"N7b token agreement with one process (not gated): "
          f"{[i['token_agreement_with_one_process'] for i in info]}",
          flush=True)
    out = {"mesh": list(N7_MESH), "model": N7B_ARCH, "reduced": [],
           "attn_impl": cfg.attn_impl, "batch": N7B_BATCH,
           "prompt_len": N7B_PROMPT, "gen": N7B_GEN,
           "weight_bytes": weight_bytes(cfg),
           "one_process": {"seconds": one_s, "prefill_s": prefill_s,
                           "decode_s": decode_s, "K8": one_k8,
                           "err_vs_float32": err_one,
                           "float32_logit_absmax": float(f32.abs().max())},
           "cut": {"layers": N7B_CUT_LAYERS, "dtype": "float32",
                   "bound_of_max": N7B_CUT_REL,
                   "logit_absmax": float(cut_one.abs().max())},
           "f32_factor": N7B_F32_FACTOR, "reference_peak_bytes": ref_peak,
           "ranks": info,
           "rank_peak_bytes": _rank_peaks(check, "N7b", ranks),
           "rank_peak_limit_bytes": N_RANK_PEAK["N7b"],
           "spawn_s": ranks[0]["spawn_s"]}
    del one, f32, cut_one
    # K8 at a rank's shape, off the path: seeded inputs at the path's scale
    g = torch.Generator(device=dev).manual_seed(SEED + 76)
    q, kk, vv = (torch.randn(shape, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3))
    o8 = fa.K8(q, kk, vv)
    plain8 = fa.flash_attention_plain(q, kk, vv)
    res8 = hold_attention(check, "N7b K8 at a rank's heads", q, kk, vv, o8,
                          plain8)
    res8.update(hold_f64(check, "N7b K8 at a rank's heads", q, kk, vv, o8,
                         plain8, UNIT_SCALE_NOISE))
    bh, sq, d = shape[0] * shape[1], shape[2], shape[3]
    pairs = sq * (sq + 1) // 2
    rows.append(entry(
        f"N7b flash_attention {shape} bfloat16 causal (prefill on a rank's "
        f"heads)", ranks[0]["launches"]["K8"], res8["max_abs_err_plain"],
        time_ms(lambda: fa.K8(q, kk, vv)),
        time_ms(lambda: fa.flash_attention_plain(q, kk, vv), reps=5),
        4 * q.numel() * q.element_size(), 4 * bh * pairs * d,
        time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kk, vv, is_causal=True)),
        kernel="K8", peak="bf16 tensor",
        launches_counted_in="phase N7b, one rank's prefill (32 layers)",
        **res8))
    del q, kk, vv, o8, plain8
    return out


def n6_shed_steps(text: str) -> list[int]:
    """The decode steps a ``serve.main --slo-shed`` run printed as shed."""
    import re
    m = re.search(r"slo-shed: \d+ decode steps shed at admission: "
                  r"\[([\d, ]*)\]", text)
    return [] if m is None else [int(v) for v in m.group(1).split(",")]


def run_phase_n(dev, check, rows):
    """The device mesh on the one card: ranks are processes that share
    it, joined by gloo through pinned host buffers (every collective's
    time here is host-staged, not NVLink's). N1 pod sync, N2 MoE EP and
    TP at Kimi-K2's widths, N3 FSDP training of Mamba2-1.3B, N4 GPipe,
    N5 sharded scheduler lanes, N6 the entry points; each case's ranks
    run together, the cases one after another. A rank that raises fails
    the spawn and the phase."""
    out = {"card": CARD, "transport": "gloo over loopback, CUDA tensors "
           "staged through pinned host buffers; every rank on cuda:0"}
    for name, fn in (("N1", run_n1), ("N2", run_n2), ("N3", run_n3),
                     ("N4", run_n4), ("N5", run_n5), ("N6", run_n6),
                     ("N7a", run_n7a), ("N7b", run_n7b)):
        t0 = time.perf_counter()
        out[name] = fn(dev, check, rows)
        out[name]["case_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        print(f"phase {name}: {out[name]['case_s']:.1f} s", file=sys.stderr,
              flush=True)
    print(json.dumps({"distributed": out}, default=str), flush=True)


def run_phase_n7(dev, check, rows):
    """N7 alone (``experiments/smoke_phases.py --phases n7``): the dense
    layers split over ``model``, training (N7a) and serving (N7b)."""
    out = {"card": CARD}
    for name, fn in (("N7a", run_n7a), ("N7b", run_n7b)):
        t0 = time.perf_counter()
        out[name] = fn(dev, check, rows)
        out[name]["case_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        print(f"phase {name}: {out[name]['case_s']:.1f} s", file=sys.stderr,
              flush=True)
    print(json.dumps({"distributed": out}, default=str), flush=True)


def run_phase_o1(dev, check, rows):
    """The two shape-changing instructions, defined with isa.define and
    given their kernels with isa.bind_kernel, launched once each on K1
    at O1_SHAPE: bit for bit against the emulator, the oracle and the one
    PyTorch call, one K1 launch each, timed beside their byte bound."""
    define_o1()
    (x,) = make_inputs(SEED + 13, [O1_SHAPE], dev)
    n = x.numel()
    for name, (_, plain_call) in O1_TEMPLATES.items():
        K1.launches = 0
        got = isa.call(name, x, mode="kernel")
        launches = K1.launches
        check.true(f"O1 {name}: {launches} K1 launches, want 1",
                   launches == 1)
        interp = isa.call(name, x, mode="interpret")
        ref = isa.call(name, x, mode="ref")
        library = plain_call(x)
        check.shaped(f"O1 {name}", got, library.shape)
        for what, want in (("the emulator", interp), ("ref", ref),
                           ("the PyTorch call", library)):
            check.true(f"O1 {name}: kernel vs {what} not bit for bit",
                       same_bits(got, want))
        err = max_abs(got.float(), interp.float())
        out_bytes = got.numel() * got.element_size()
        out_shape, out_dtype = list(got.shape), str(got.dtype)
        del got, interp, ref, library
        was = k1_was_new(check, f"O1 {name}",
                         lambda: isa.call(name, x, mode="kernel"),
                         [O1_TEMPLATES[name][0].program()])
        rows.append(entry(
            f"O1 {name}", launches, err, was.pop("timed"),
            time_ms(lambda: isa.call(name, x, mode="interpret"), reps=5),
            n * x.element_size() + out_bytes,
            n // 2 if name == "pairsum" else 0,
            time_ms(lambda: plain_call(x)),
            out_shape=out_shape, out_dtype=out_dtype, **was))


def run_phase_o2(dev, check, rows):
    """The dry run of phase L's cell (Mamba2-1.3B uncut, train, 4 × 4096,
    a mesh of one) against one real step of it on the card: FLOPs equal
    (FlopCounterMode over both), the predicted peak within O2_PEAK_RATIO
    of torch.cuda.max_memory_allocated, and the roofline lower bound
    beside the measured step seconds (not gated)."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_config(TRAIN_ARCH)
    shape = ShapeConfig("train_L", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    rep = dryrun.count_cell(cfg, shape, DryMesh((1, 1), ("data", "model")),
                            arch=TRAIN_ARCH)
    dry_s = time.perf_counter() - t0
    print(rep.to_json(), flush=True)
    state = api.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 30), dev)
    batch = to_device(SyntheticLMData(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH,
                                      SEED).host_batch(0), dev)
    step_fn = api.make_train_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with FlopCounterMode(display=False) as fc:
        out = step_fn(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    flops = float(fc.get_total_flops())
    del out
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del out
    predicted = rep.memory["peak_gib"] * 2**30
    ratio = predicted / peak
    check.true(f"O2: dry-run FLOPs {rep.flops_per_chip} != the card's "
               f"{flops}", rep.flops_per_chip == flops)
    check.true(f"O2: predicted peak {predicted:.0f} B / measured {peak} B "
               f"= {ratio:.4f} outside {O2_PEAK_RATIO}",
               O2_PEAK_RATIO[0] <= ratio <= O2_PEAK_RATIO[1])
    print(json.dumps({"dryrun": {
        "phase": "O2", "card": CARD, "model": TRAIN_ARCH,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "dry_walk_s": dry_s,
        "flops_dry": rep.flops_per_chip, "flops_card": flops,
        "hbm_bytes_dry": rep.hbm_bytes_per_chip,
        "predicted_peak_bytes": predicted, "measured_peak_bytes": peak,
        "peak_ratio": ratio, "peak_ratio_limit": O2_PEAK_RATIO,
        "lower_bound_s": rep.terms["step_time_lower_bound_s"],
        "dominant": rep.terms["dominant"], "step_wall_s": walls}}),
        flush=True)
    del state, batch


# ---------------------------------------------------------------------------
# phase P: the four user-facing examples, through their twins in
# repro_torch.examples
# ---------------------------------------------------------------------------

COUNTERS = {"K1": (K1, "launches"), "K3": (K3, "launches"),
            "K4": (K4, "launches"), "K4 reverse": (K4, "reverse_launches"),
            "K4 da": (K4, "da_launches"),
            "K5": (K5, "launches"), "K6": (K6, "launches"),
            "K7": (K7, "launches"), "K8": (K8, "launches"),
            "SSD": (SSD_CHUNK, "launches")}


def zero_counts() -> None:
    for obj, attr in COUNTERS.values():
        setattr(obj, attr, 0)


def read_counts() -> dict:
    return {name: getattr(obj, attr) for name, (obj, attr) in
            COUNTERS.items()}


def run_example(name: str, argv) -> tuple[str, object, dict, float]:
    """One example twin's ``main(argv)`` with every count set to 0 just
    before it: (what it printed, its result, the counts just after, wall
    seconds ending in a synchronize on the card). Its printout is
    echoed."""
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    zero_counts()
    t0 = time.perf_counter()
    text, ret = _captured(mod.main, argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"--- {name} {' '.join(argv)}\n{text}", end="", flush=True)
    return text, ret, counts, wall


def launches_want(counts: dict, **want) -> bool:
    """Every count equals ``want``'s (K4 reverse as ``K4_reverse``), 0
    where it names none."""
    return all(counts[k] == want.get(k.replace(" ", "_"), 0) for k in counts)


def example_line(name: str, argv, wall: float, counts: dict, **extra):
    print(json.dumps({"example": {
        "name": name, "argv": list(argv), "card": CARD, "wall_s": wall,
        "launches": counts, **extra}}), flush=True)


def logged_losses(text: str) -> list[float]:
    """The losses of the train driver's ``step N loss L …`` lines."""
    return [float(ln.split()[3]) for ln in text.splitlines()
            if ln.startswith("step ")]


def losses_fall(losses: list[float], k: int = TRAIN_LM_WINDOW) -> bool:
    """The mean of the last ``k`` logged losses below that of the first
    ``k`` by more than ``TRAIN_LM_FALL``."""
    return (len(losses) >= 2 * k and
            float(np.mean(losses[-k:])) < float(np.mean(losses[:k]))
            - TRAIN_LM_FALL)


def run_phase_p(dev, check, rows):
    """The four example twins on the card at the reference scripts' own
    sizes, each with every count set to 0 just before it and read just
    after, each output held against its plain version or oracle. On a
    CPU ``dev`` the twins run their kernels' plain versions (a rehearsal:
    every launch count then fails)."""
    from repro_torch.examples import kernel_mode
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    argv = ["--device", dev.type]
    mode = kernel_mode(dev)

    # quickstart: c7 validated and inside a program (two K1 launches), the
    # two tenants coalesced into one k1_batch_kernel launch
    with Tap(K1, "launch_items") as tb:
        _, out, counts, wall = run_example("quickstart", argv)
    check.true(f"P quickstart: launches {counts}, want K1 3 and no other "
               f"kernel", launches_want(counts, K1=3))
    check.true(f"P quickstart: {len(tb.calls)} k1_batch_kernel launches, "
               f"want 1", len(tb.calls) == 1)
    x, ker = out["x"], out["kernel"]
    ulp_ref = max_ulp(ker, out["oracle"])
    ulp_plain = max_ulp(ker, quickstart.TEMPLATE(x, interpret=True))
    check.true(f"P c7 kernel vs ref: {ulp_ref} ulp > 2", ulp_ref <= 2)
    check.true(f"P c7 kernel vs emulator: {ulp_plain} ulp > 2",
               ulp_plain <= 2)
    check.true(f"P program {out['program']} != the validated launch's sum",
               out["program"] == float(ker.sum()))
    rep = out["report"]
    fused = out["registry"].fuse("c0_scale", "c0_add")
    y, b = out["y"], out["b"]
    check.true("P tenants: not one coalesced batch",
               len({p.batch_seq for p in rep.placements}) == 1
               and all(p.coalesced for p in rep.placements))
    for seq, (u, v) in enumerate(((y, b), (b, y))):
        got = rep.results[seq]
        check.shaped(f"P tenant {seq}", got, u.shape)
        check.exact(f"P tenant {seq} vs its solo launch", got,
                    fused(2.0, u, v, mode=mode))
        check.within(f"P tenant {seq} vs ref", got,
                     fused(2.0, u, v, mode="ref"), fma_bound((2.0 * u, v)))
        check.exact(f"P tenant {seq} vs interpret", got,
                    fused(2.0, u, v, mode="interpret"))
    example_line("quickstart", argv, wall, counts,
                 k1_batch_launches=len(tb.calls),
                 c7_max_ulp_vs_ref=ulp_ref, c7_max_ulp_vs_plain=ulp_plain)
    del out, rep

    # sort_prefix_apps at its default size: each step a warm-up and a
    # timed call; the plan's two parts on K1
    _, out, counts, wall = run_example("sort_prefix_apps", argv)
    keys, x = out["keys"], out["x"]
    n = keys.numel()
    levels = sum(1 for w in MERGE_WIDTHS if w < n and 2 * w <= 4096)
    parts = out["plan"].n_parts
    check.true(f"P sort_prefix_apps: launches {counts}, want K5 2, K6 "
               f"{2 * levels}, K3 2, K1 {parts}",
               launches_want(counts, K5=2, K6=2 * levels, K3=2, K1=parts))
    check.exact("P sort vs torch.sort", out["sorted"], out["library_sorted"])
    check.exact("P sort vs the plain network", out["sorted"],
                ops.sortnet_mergesort(keys[None], max_kernel_width=4096,
                                      mode="interpret")[0])
    bc = ps.block_shape(1, n)[1]
    ref64 = torch.cumsum(x.double(), 0)
    abs64 = torch.cumsum(x.abs().double(), 0)
    bad, worst = prefix_bound_misses(out["prefix"], ref64, abs64, bc,
                                     *ps.k3_bound_constants(x.dtype, n))
    check.true(f"P prefix sum: {bad} elements outside the summation bound",
               bad == 0)
    xa, ba = out["plan_inputs"]
    plan_err = hold_plan(check, "P plan", out["plan"], out["plan_outputs"],
                         xa, ba, (2.0, 0.5))
    example_line("sort_prefix_apps", argv, wall, counts, keys=n,
                 prefix_max_abs_err_f64=worst, prefix_rel_err=out["rel_err"],
                 plan_max_abs_err_vs_plain=plan_err)
    del out, keys, x, ref64, abs64, xa, ba

    # serve_decode: reduced Hymba, K4 once a layer in prefill, each call
    # held against float64 as it runs; a second run gives the same tokens
    cfg = get_config("hymba_1p5b").reduced()

    def hold(args, kw, got):
        a, states, _ = args
        return statescan_bound_misses(got, a, states)

    with Tap(ps, "chunk_scan_state_kernel", hold) as t4:
        _, tokens, counts, wall = run_example("serve_decode", argv)
    check.true(f"P serve_decode: launches {counts}, want K4 "
               f"{cfg.n_layers} and no other kernel",
               launches_want(counts, K4=cfg.n_layers))
    for i, (bad, _) in enumerate(t4.calls):
        check.true(f"P serve_decode K4 call {i}: {bad} elements outside "
                   f"the summation bound", bad == 0)
    check.true(f"P serve_decode tokens {tokens.shape}, want (4, 32) ids "
               f"below {cfg.vocab}", tokens.shape == (4, 32)
               and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()))
    _, again, _, _ = run_example("serve_decode", argv)
    check.true("P serve_decode: run 2's tokens differ from run 1's",
               np.array_equal(again, tokens))
    with isa.use("interpret"):
        _, plain_tokens, plain_counts, _ = run_example("serve_decode", argv)
    check.true(f"P serve_decode plain run: launches {plain_counts}, want "
               f"none", launches_want(plain_counts))
    example_line("serve_decode", argv, wall, counts,
                 k4_max_abs_err_f64=max((w for _, w in t4.calls),
                                        default=None),
                 tokens_equal_plain_path=float(
                     np.mean(plain_tokens == tokens)))

    # train_lm --tiny: the dense chunked path launches none of K1–K8
    ckpt = ROOT / "build" / "chip_smoke" / "train_lm"
    if ckpt.exists():
        import shutil
        shutil.rmtree(ckpt)
    argv = ["--tiny", "--steps", str(TRAIN_LM_STEPS), "--device", dev.type,
            "--ckpt-dir", str(ckpt)]
    text, final, counts, wall = run_example("train_lm", argv)
    losses = logged_losses(text)
    check.true(f"P train_lm: launches {counts}, want none (a dense model "
               f"with chunked attention)", launches_want(counts))
    check.true(f"P train_lm: final loss {final} not finite",
               math.isfinite(final))
    check.true(f"P train_lm: losses {losses} do not fall by "
               f"{TRAIN_LM_FALL}", losses_fall(losses))
    check.true("P train_lm: no checkpoint written",
               any(ckpt.iterdir()) if ckpt.exists() else False)
    example_line("train_lm", argv, wall, counts, losses=losses,
                 steps_per_s=TRAIN_LM_STEPS / wall)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    global CARD
    CARD = smi
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    check, rows = Check(), []
    failed = []
    peaks = {}
    t_start = time.perf_counter()
    _cuda.build_all()           # every CUDA source, one nvcc each, at once
    print(f"nvcc: {time.perf_counter() - t_start:.1f} s", file=sys.stderr,
          flush=True)
    cuda_report()
    for name, phase in (("A", run_phase_a), ("B", run_phase_b),
                        ("C", run_phase_c), ("D", run_phase_d),
                        ("E", run_phase_e), ("F", run_phase_f),
                        ("G", run_phase_g), ("H", run_phase_h),
                        ("I", run_phase_i), ("J", run_phase_j),
                        ("K", run_phase_k), ("L", run_phase_l),
                        ("M", run_phase_m), ("N", run_phase_n),
                        ("O1", run_phase_o1), ("O2", run_phase_o2),
                        ("P", run_phase_p)):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            phase(dev, check, rows)
            torch.cuda.synchronize()
        except Exception:                 # noqa: BLE001 — report, go on
            traceback.print_exc()
            failed.append(f"phase {name} raised")
        peaks[name] = torch.cuda.max_memory_allocated(dev)
        check.true(f"phase {name}: peak device memory {peaks[name]} B >= "
                   f"{PEAK_MEM_LIMIT[name]:.0f} B",
                   peaks[name] < PEAK_MEM_LIMIT[name])
        torch.cuda.empty_cache()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s, peak "
              f"{peaks[name] / 1e9:.3f} GB", file=sys.stderr, flush=True)
    failed += check.failures
    if failed:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failed),
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows, "cuda_sources": CUDA_REPORT,
                      "peak_bytes": max(peaks.values()),
                      "peak_bytes_by_phase": peaks,
                      "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
