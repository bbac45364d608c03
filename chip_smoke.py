#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (so the exit code is non-zero):

1. Card: the GPU's name and power limit, as ``nvidia-smi`` reports them.
2. Build: every ``kernels/csrc/*.cu`` with ``nvcc`` for ``sm_90a``, one
   compile per source in parallel, linked into one library.
3. Kernels: ``gram``, ``weiszfeld`` and ``wsum``, then ``krum_score``,
   ``trimmed_mean``, ``gossip_reduce`` and ``neighbor_reduce`` (each mode)
   and ``flash_attention`` against their plain PyTorch versions on the
   card, at the main path's shapes and large inputs (``gram``, ``wsum``:
   three large stacks, ``LARGE_SHAPES``); every kernel is rerun for
   bit-identity, ``gram`` must be exactly symmetric, ``weiszfeld`` must
   match its plain version bit for bit, one integer-grid input per cw
   kernel must match its plain version bit for bit, ``weiszfeld`` and
   ``krum_score`` must at every stack height on the edges of their
   instances (``K_EDGES``, with NaN and infinite entries in G), and
   flash attention must also take strided (B, S, H, hd) tensors, sliced
   out of one fused projection, with the folded launch's bits. Two
   times per kernel and per library yardstick (``torch.bmm``, ``torch.sort``
   plus a slice mean or sum, SDPA; timed only, never called by the port),
   taken in turns (kernel, library, library, kernel), medians of
   ``ROUNDS``: the issue-bound time (``ms``: a Python loop of calls, the
   host's cost of issuing one call for a small kernel) and the device
   time (``device_ms``: the same calls replayed from one CUDA graph), the
   latter at every headline input and every shape of the first three.
3b. Training through attention: the chunked route
   (``chunked_causal_attention``) equals the flash kernel's forward at
   Llama-3.2-1B's layer shape and the CPU's float64 route in output and
   gradients, and the flash op's backward raises; then Llama-3.2-1B at
   full width and depth on a ``TokenPipeline`` batch of 2 x 1025 tokens:
   the no-grad forward's flash launches against the plain version on
   their own inputs, the chunked route's logits against the flash
   route's, ``lm_loss`` against the flash forward's cross-entropy, finite
   gradients with no flash launch under autograd, three Adam steps that
   lower the loss, the forward+backward time and peak memory.
4. Main path: ``run_decbyzpg`` at full width, five runs (``main_runs()``):
   the paper's CartPole configuration (K=13, n_byz=3
   ``large_noise(sigma=10)``, bucketing ∘ RFA, MDA κ=6, horizon 200,
   d=386) for 8 iterations, LunarLander with a (64, 64) tanh policy
   (d=4868) for 3, CartPole with Krum and cwtm, CartPole with the trimmed
   mean and cwmed under per-receiver equivocation, and LunarLander with
   Krum and cwmean. Each run's launches per iteration must equal its
   row, and every kernel must launch on at least one run. Small
   configurations (RFA/MDA, Krum/cwtm, trimmed mean/cwmed per receiver)
   then run on the card and, with the same draws, on the CPU through the
   plain versions, and the two must agree.
5. Serving (``serving_runs()``): the port's continuous-batching engine
   serves Llama-3.2-1B at full width and depth (24 requests, prompts up to
   512 tokens), Qwen2.5-3B at full width cut to 4 layers, the default
   transformer policy through ``serve()``, the MoE and MLA families
   at full width: Grok-1 cut to 1 layer, DeepSeek-V2-Lite to 4 and
   MiniCPM3-4B whole, and the recurrent families at full width and
   depth: Hymba-1.5B (GQA + Mamba) and xLSTM-350M (12 mLSTM/sLSTM
   pairs), prefilled at exact prompt lengths (8 requests each, prompts
   up to 256 tokens); each run must launch flash attention exactly once
   per GQA layer per prefill (warmup included; MLA layers take the
   chunked route and xLSTM has no attention) and give every request
   exactly its budget of in-range tokens; Grok-1's and Hymba's flash
   launches (G = 6 and G = 5) are held against the plain version on
   their own inputs, each run logs its peak memory and its decode
   tick's weight-read bound (and the recurrent states' bytes), and one
   256-token prefill of DeepSeek-V2-Lite, Hymba and xLSTM must each
   repeat bit for bit, logits and every cache leaf. Then Llama-3.2-1B's
   width at 2 layers serves the same requests with the same weights on
   the card and on the CPU: prefill logits must agree, and greedy
   streams wherever the top-1 margin exceeds the tolerance; the same at
   DeepSeek-V2-Lite's width at 1 layer, with the logits held relative to
   their largest entry and the smallest routing margin reported, and at
   Hymba-1.5B's width at 2 layers and xLSTM-350M's at 1 pair (exact-
   length prefills, logits relative to their largest entry).
   Every registered kernel must launch on some run of phases 4 and 5.
6. ByzPG (paper Algorithm 1, ``byzpg_runs()``) at its defaults (K=13,
   N=50, B=4, MLP (16, 16) relu): CartPole under ``large_noise`` with
   bucketing ∘ RFA and with Krum for 8 iterations, LunarLander with the
   trimmed mean for 3, each after a warm iteration with exact launches
   per iteration; then small runs on the card against the CPU's plain
   path (bucketed RFA, Krum, trimmed mean).
6b. The transformer policy (``transformer_runs()``: reduced Qwen2.5-3B,
   d=1,378,560, on ``cartpole(horizon=25)``, K=13, n_byz=3, N=20, B=4):
   DecByzPG with bucketing ∘ RFA and MDA, DecByzPG with Krum and cwtm,
   ByzPG with the trimmed mean, each with exact launches per iteration
   (the policy's passes take the chunked route: no flash launch), the
   aggregation kernels held against their plain versions on the run's
   own inputs, finite outputs and a bit-equal repeat; the reference's
   tiny transformer on the card against the CPU; the first run's honest
   mean θ served through ``policy_params(theta=)`` (flash per layer and
   request, held against its plain version on its own inputs).
7. ``Experiment(...).run()``, the front door of the paper's figures
   (``experiment_cells()``): the reference's fig5 cell (ByzPG, attack ×
   aggregator, 3 seeds, T=15) and fig1's DecByzPG K axis with its κ
   override, run as lane groups (the default) with exact launches from
   the group structure (a group launches per iteration one run's
   kernels), each scenario's final return ± CI, the wall per iteration,
   and each seed's row in the first scenario within the lane tolerances
   of its single run (bit-equal rows counted).
7b. Sweeps (``repro_torch.sweep``): the fig5 cell through
   ``SweepRunner(windows=3)``, preempted after 5 windows and resumed from
   its manifest, bit-equal to phase 7's result with exactly its launches
   (a second resume runs nothing); ``python -m repro_torch.launch.sweep``
   in fresh processes on a DecByzPG Krum/trimmed-mean × consistent/
   per-receiver cwtm grid (``cli_grid_args()``), stopped and resumed, two
   processes in ``shard`` mode and in ``span`` mode resumed by one
   ``local`` process, each against an in-process ``run_grid`` with
   exact launches read from the processes' run manifests; a sweep
   started on the CPU refused on the card. Prints the walls and the
   window commits' times.
7c. Lane batching at full width (``phase_lanes``, ``LANE_*``): the paper's
   Fig. 3 ladder (DecByzPG, K=13, n_byz=3, d=386, horizon 200,
   ``large_noise`` over five sigmas × {bucketed RFA + MDA κ=5, mean κ=0},
   3 seeds, T=3) through ``run_grid`` with ``lanes=True`` (two groups of
   15 rows) and ``lanes=False``, each with exact launches from the group
   structure; every row's returns, samples, Δ₂ and θ within the
   reference's lane tolerances of ``lanes=False`` (largest gaps and
   bit-equal rows printed) and both walls; the lane run's ``gram``,
   ``weiszfeld`` and ``wsum`` launches against their plain versions on
   their own inputs; an ``rfa(nu=...)`` sweep as one group, its per-row
   ``nu`` weiszfeld bit-equal; the grid through ``SweepRunner(windows=3)``
   preempted and resumed, bit-equal to the lane run with its launches.
8. Telemetry: three of the runs above at T=4 with ``telemetry=True``
   under an ``obs.MemorySink``: returns, coins, Δ₂ and θ bit-identical
   to the run without it, one tap per iteration, the rejection mask's
   launches counted. Then a checkpoint round trip: ``byzpg_cartpole``'s
   parameters saved and restored onto the card bit for bit, and one
   request served through ``policy_params(checkpoint=)``.
   Phases 3b, 6–8 (6b, 7b and 7c included), 10 (10c included), 11, 12,
   13 and 14 are driven with the launch counts set to 0 just before each
   run and read just after; their launches join the totals.
10. Federated LLM training (``phase_fed``, run after phase 3b):
   Llama-3.2-1B at full width cut to 2 layers, K = 4 agents (D =
   384,313,344 each), n_byz = 1 ``large_noise(sigma=10)``, κ = 3, Adam:
   the tree trainer's ``fed_train_window`` over 5 steps (both coins,
   finite, the t = 0 honest loss against ``lm_loss_labeled`` at θ₀, no
   kernel launch, peak memory, ms per step and per phase), then the
   same steps through ``make_fed_step`` on a one-rank ("data", "model")
   = (1, 1) mesh (the placed state, not copied): coins, parameters,
   losses and diameters bit-equal, the window's peak to the byte, ms
   per step beside the window's; the flat trainer with
   bucketed RFA, Krum and the trimmed mean for 3 steps each with exact
   launches, every launch of its last step
   held against the plain version at that D (per-entry scales, the
   ragged ``gram`` chunk included) and timed beside its bound; the two
   trainers against each other (mean, no attack); the reduced model on
   the card against the CPU; ``python -m repro_torch.launch.train`` in
   fresh processes, windowed and ``--no-fused`` started at once, each
   checkpoint against the same run in this process; at its end the
   tree trainer's card-vs-CPU check once more, both readings printed.
10c. The D-sharded flat trainer (``fed_train_step_flat(sharded=True)``):
   (a) after each full-width flat run of phase 10, the same 3 steps with
   ``sharded=True`` on one process (the sharded flat layer with one
   shard), bit-equal in every state field, loss and diameter (the first
   run's state kept in one set of pinned host buffers, compared field by
   field on the card), with the same launches per step, its ms per
   step, phases and peak; (b) the
   reduced model over two gloo ranks on the one card (``chip_smoke.py
   --fed-rank``, fresh processes; NCCL refuses two ranks on one GPU, so
   ``init_distributed`` picks gloo there), D
   split in two over a ("data", "model") = (1, 2) mesh, RFA without the
   attack and Krum and the trimmed mean with it, 2 steps: every launch of
   each rank and of the one-process run against the kernel's plain
   version on its own input (the rank's local columns for ``gram``,
   ``wsum`` and ``trimmed_mean``, the combined Gram matrix for
   ``weiszfeld`` and ``krum_score``), θ against the
   one-process route within ``FED_RANK_TOL``, Krum's margins, each rank's
   launches per step the one-process run's, and each rank's peak across
   the aggregate call below its whole stack. Their launches join the
   totals.
10d. The tree trainer under a mesh (``make_fed_step``): the reduced
   models over four gloo ranks on the one card (``chip_smoke.py
   --fed-tree-rank``, fresh processes, one process group), a ("data",
   "model") = (2, 2) mesh: Llama-3.2-1B with ``fed_axis="data"`` (K = 2
   over "data", each agent's loss and gradient on the rank's "model"
   blocks) with mean and RFA, and ``fed_axis="all"`` (K = 4, one agent a
   rank, the plain loss) with Krum and the trimmed mean under
   ``large_noise(sigma=10)``; Grok-1 with its ``fed_axis="pod"`` (K = 1,
   the rows and the layer stack over "data", the experts over "model");
   2 steps each (coin 1, then 0), the coin-1 step on "all", each step
   from the one-process chain's state (``_fed_chain``), against the
   one-process tree step on the card from the same state and draws: on
   the rows and blocks v within ``FED_BLOCK_V_TOL`` of max|v| and θ by
   ``_fed_step_gaps``' Adam-aware rule, on "all" θ within
   ``FED_RANK_TOL``; the losses within ``FED_LOSS_TOL``, Krum's margins,
   no kernel launch, each rank's allocation across a step within
   ``_tree_rank_bound`` (its blocks and, on the rows and blocks, the dry
   run's reckoning of its estimate and the one-process activations; a
   bound one agent's whole leaves tighter than the whole-leaf route's,
   or that one gathered field of the stack would cross), the ranks'
   wall.
10e. The tree trainer's step on each rank's blocks at Llama-3.2-1B's
   full width cut to 2 layers (D = 384,313,344, f32) over two gloo ranks
   on the one card (``chip_smoke.py --fed-block-rank``), (data, model) =
   (1, 2), K = 1: every leaf a column, row or vocabulary block, none
   gathered; 2 × 128 tokens, coin 1 then coin 0, each step from the
   one-process chain's state, against the one-process step on the card:
   the same tolerances as 10d, the two ranks' losses bit-identical, each
   rank's allocation across the estimate within its reckoning (its
   direction blocks, ``train_gathered_bytes`` and the one-process
   activations), which lies one agent's whole leaves below the
   whole-leaf route's estimate term; each rank's
   ``max_memory_allocated`` logged beside the card's name and limit.
10f. 10e's run at MiniCPM3-4B's full width cut to 2 layers (D =
   501,404,160, f32; its ``fed_axis`` "pod", so K = 1 on (1, 2)): MLA on
   20 of the 40 heads a rank through ``w_dq`` (whole) -> ``w_uq``,
   3200 of the 6400 ``d_ff`` columns and 36,724 vocabulary rows a rank,
   no leaf gathered whole; 10e's checks and tolerances.
   ``[time]`` lines give phase 10's tree runs, its flat runs with 10c
   (a), 10c (b), 10d, 10e and 10f.
11. Serving under a mesh (``make_serve_fns``, after phase 5): (a)
   Llama-3.2-1B at full width and depth on a one-rank ("data", "model")
   = (1, 1) mesh in a gloo group of this process, 4 prompts of 512
   tokens and 8 greedy decode steps: logits, tokens and every cache
   leaf bit-equal to ``model.prefill`` and ``decode_step`` on the same
   tensors, the prefill's flash launches (held against the plain version
   on their own inputs) the plain route's, and the dry run's
   ``argument_bytes`` for this (config, batch, length, (1, 1)) equal to
   the bytes the weights and prompts hold, logged with its
   ``peak_per_device_gb`` beside the measured peak; (b) its width cut to
   2 layers over two gloo ranks on the one card (``chip_smoke.py
   --serve-rank``, fresh processes), on (1, 2) and (2, 1) meshes, 3
   greedy steps: each rank's logit rows and cache blocks after the
   prefill and after the last step within ``SERVE_RANK_TOL`` of the
   route on the whole batch; on (2, 1) (rows only) bit-equal to the
   one-process route on its own rows, tokens included; on (1, 2) (each
   rank on its head, column, row and vocabulary blocks) the greedy
   tokens equal wherever the route's top-1 margin exceeds twice the
   tolerance and the two ranks bit-identical; (c) Grok-1 at full width
   cut to 1 layer over two gloo ranks on the one card (``chip_smoke.py
   --serve-tp-rank``), (data, model) = (1, 2): expert-, head- (24/4
   heads of hd 128, G = 6) and vocab-parallel, each rank drawing only
   its blocks (``_serve_tp_params``), 2 prompts of 128 tokens and 8
   greedy steps against the one-process route on the card: logits
   within ``SERVE_RANK_TOL`` of max|logit| while the streams agree, the
   streams equal under the margin rule, the ranks bit-identical, the
   smallest routing margin, each rank's flash launch held against the
   plain version on its own input, and each rank's
   ``max_memory_allocated`` printed beside the dry run's reckoning for
   its blocks and the whole layer's bytes, held within the reckoning
   plus the route's activations and under the whole layer; (d) (c)'s
   run of DeepSeek-V2-Lite (``SERVE_TP_ARCHS``) at full width cut to 1
   layer: MLA on 8 of the 16 heads a rank through ``wq``, 32 of the 64
   experts, the shared experts' ``d_ff`` columns and 51,200 vocabulary
   rows a rank, absorbed decode, no leaf gathered whole and no flash
   launch (MLA is chunked), held as (c) is.
   ``[serve-mesh]`` and ``[serve-tp]`` lines and ``[time]`` lines; the
   launches join the totals.
12. The analysis suite (``repro_torch.analysis``) on the card:
   keycheck's entry points on the CUDA generator ((seed, offset) states),
   retrace's config audit and its swept grid's build-once, the donation
   sites at their small sizes and, at full width where the state already
   exists, phase 5's Llama-3.2-1B engine (insert and tick, in place),
   phase 10's tree state (one ``make_fed_step`` step: no input written,
   every leaf's checksum summed on the card unchanged) and one more
   decode step on phase 11 (a)'s kept cache after its comparisons (in
   place), each site's allocated bytes
   against its bound; one memcheck contract (``MEMCHECK_CARD``) over two
   gloo ranks on the card; and build-once over the whole script (one
   ``nvcc``, one load of the library). A finding raises; ``[analysis]``
   lines and a ``[time]`` line.
13. The examples (``EXAMPLES``): the seven scripts of ``examples_torch/``
   through their ``main`` in this process on the card, each at its own
   widths with only its depth cut (``--iters 3 --seeds 1`` for the five
   ``Experiment`` examples, ``--sigmas 10,200`` for the sweep,
   ``serve_decode.py`` at its defaults realtime and ``--offline``,
   ``federated_llm.py --steps 4`` flat and ``--steps 2 --tree``): each
   report printed with an ``[examples]`` prefix and its wall, every
   returned number finite, every served request given its budget, and
   ``gram``, ``weiszfeld``, ``wsum`` and ``flash_attention`` each
   launched inside the phase; a ``[time]`` line. Its launches join the
   totals.
14. One rank per card over NCCL (``phase_nccl``, ``[nccl]`` lines, after
   phase 13): (a) a one-rank group joined in this process through
   ``init_distributed`` (NCCL on cuda:0, both printed), a ("data",
   "model") = (1, 1) mesh on it: ``columns.gather_over`` on each mesh
   dimension bit-equal to its input with no copy to the host (a dispatch
   mode watches), one more from a backward hook on autograd's device
   thread, and ``gather_rows`` and the sweep's ``broadcast_object`` over
   the gloo group beside the NCCL world; (b) on that group, 10c (b)'s
   flat RFA steps (``gram``, ``weiszfeld`` and ``wsum`` counted),
   ``make_fed_step`` (reduced Llama-3.2-1B, K = 4, from the one-process
   chain's state) and ``make_serve_fns`` (Llama-3.2-1B at full width, 2
   layers), each bit-equal to the one-process route; (c) with two cards
   or more, 10c (b), 10e and 11 (c) with one rank a card, over gloo and
   over NCCL: every rank bit-equal between the two, both held against
   the one-process route by the phases' own checks, the ranks' ms beside
   the one process's; on one card one line says (c) did not run. Every
   spawned rank of phases 10c–11 joins through ``init_distributed`` too
   (``_join_rank``): on one card their groups are gloo, as before.
9. The kernel table as one JSON line (``device_ms`` and
   ``library_device_ms`` beside the issue-bound ``ms`` and
   ``library_ms``), then
   ``{"ok": true, "device": {...}}`` as the last line.

It imports nothing of JAX or of the JAX package ``repro``. Without a CUDA
device, or outside a checkout that holds ``src/repro_torch`` and
``examples_torch/``, it exits 2 and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the FP32 rate outside the
# tensor cores (the kernels use FP32 FMA; TF32 is off)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

MAIN_SHAPES = [(13, 13, 386), (13, 7, 386), (13, 13, 4868), (13, 7, 4868)]
# large stacks: one model-size stack of 13 agents, 32 agents, and a batch
# of 13 stacks (MDA's receivers) of 2^20 coordinates
LARGE_SHAPES = [(1, 13, 1 << 24), (1, 32, 1 << 22), (13, 13, 1 << 20)]
# the large input of each cw kernel, a few hundred MB: Krum's scoring over
# 2^20 Gram matrices of 13 agents, the trimmed mean of 13 stacks of 2^24,
# the gossip reduces of 13 agents' messages of 2^22 and 2^20 coordinates
LARGE_CW = {"krum_bt": 1 << 20, "trimmed_d": 1 << 24, "gossip_d": 1 << 22,
            "neighbor_d": 1 << 20}
SOURCE = "src/repro_torch/kernels/csrc/aggregation.cu"
SOURCES = {"flash_attention": "src/repro_torch/kernels/csrc/attention.cu",
           **dict.fromkeys(("krum_score", "trimmed_mean", "gossip_reduce",
                            "neighbor_reduce"),
                           "src/repro_torch/kernels/csrc/cw_reduce.cu")}
# the slot counts at the edges of the cw rank network's instances (exact 5;
# padded heights 8, 16 and 32), held bit for bit on an integer grid
CW_EDGES = (5, 8, 9, 16, 17, 32)
# the stack heights at the edges of the weiszfeld instances (8, 16, 32)
# and of krum_score's rank network (exact 5 and 13; padded 8, 16, 32),
# held bit for bit
K_EDGES = (1, 4, 5, 7, 8, 9, 13, 16, 17, 24, 32)
# the TPU kernel each replaces: the line of the function that holds the
# kernel's body (its pallas_call is a few lines below it, PERF.md §6)
REPLACES = {
    "gram": "src/repro/kernels/pairwise_dist/pairwise_dist.py:30",
    "weiszfeld": "src/repro/kernels/rfa/rfa.py:33",
    "wsum": "src/repro/kernels/rfa/rfa.py:55",
    "krum_score": "src/repro/kernels/krum_score/krum_score.py:24",
    "trimmed_mean": "src/repro/kernels/trimmed_mean/trimmed_mean.py:29",
    "gossip_reduce": "src/repro/kernels/gossip_reduce/gossip_reduce.py:50",
    "neighbor_reduce":
        "src/repro/kernels/gossip_reduce/gossip_reduce.py:80",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:68",
}
# the input each kernel sees most on the main path: gram from MDA's rounds
# and weiszfeld and wsum on the 7 bucket means (CartPole, n_byz=3); the
# Krum, trimmed-mean and cw* kernels at the CartPole runs of main_runs()
HEADLINE = {"gram": (13, 13, 386), "weiszfeld": (13, 7, 386),
            "wsum": (13, 7, 386),
            "krum_score": "x (1, 13, 386) n_near=8",
            "trimmed_mean": "(1, 13, 386) n_trim=3",
            "gossip_reduce": "(13, 386) P=13 trimmed n_trim=3",
            "neighbor_reduce": "(13, 13, 386) median",
            "flash_attention": "q (32, 512, 64) kv (8, 512, 64)"}
# flash inputs (B, H, Hkv, S, hd, window): Llama-3.2-1B's 512-token
# prefill (G = 4) with and without windows, Qwen2.5-3B's (hd 128, G = 8),
# the policy's 9-position prefill (hd 32, G = 1), ragged grouped ones, the
# 16- and 128-token buckets that Llama's serving prefills most, and
# Grok-1's served buckets of 16, 128 and 256 tokens (48 heads over 8: G =
# 6, not a power of two; hd 128), and Hymba-1.5B's exact prompt lengths
# of 16, 77, 128 and 256 tokens (25 heads over 5: G = 5, odd; hd 64)
FLASH_CASES = [(1, 32, 8, 512, 64, None), (1, 32, 8, 512, 64, 1),
               (1, 32, 8, 512, 64, 7), (1, 32, 8, 512, 64, 128),
               (1, 16, 2, 256, 128, None), (1, 2, 2, 9, 32, None),
               (1, 4, 1, 9, 32, None), (1, 4, 1, 100, 64, None),
               (2, 4, 2, 130, 32, None), (1, 32, 8, 16, 64, None),
               (1, 32, 8, 128, 64, None), (1, 48, 8, 16, 128, None),
               (1, 48, 8, 128, 128, None), (1, 48, 8, 256, 128, None),
               (1, 25, 5, 16, 64, None), (1, 25, 5, 77, 64, None),
               (1, 25, 5, 128, 64, None), (1, 25, 5, 256, 64, None)]
#: the flash inputs also timed on the device (CUDA-graph replay): the
#: headline and Grok-1's, Hymba-1.5B's, DeepSeek-V2-Lite's and
#: MiniCPM3-4B's longest served prefills
FLASH_DEVICE = (HEADLINE["flash_attention"],
                "q (48, 256, 128) kv (8, 256, 128)",
                "q (25, 256, 64) kv (5, 256, 64)",
                "q (16, 256, 192) kv (16, 256, 192) v 128",
                "q (40, 256, 96) kv (40, 256, 96) v 64")
FLASH_LARGE = (1, 32, 8, 8192, 64, None)
# the wide instances and v's own head dim, (B, H, Hkv, S, hd, window,
# hd_v): DeepSeek-V2-Lite's MLA prefill (16 heads, q/k 192, v 128: the
# hd-192 instance) at 256 and 1024 tokens, with a window; hd 256 (G = 4)
# at 256 and 1024 tokens, with a window; MiniCPM3-4B's MLA prefill (40
# heads, q/k 96 padded to 128, v 64: the (128, 64) instance)
FLASH_WIDE = [(1, 16, 16, 256, 192, None, 128),
              (1, 16, 16, 1024, 192, None, 128),
              (1, 16, 16, 1024, 192, 256, 128),
              (1, 16, 4, 256, 256, None, 256),
              (1, 16, 4, 1024, 256, None, 256),
              (1, 16, 4, 1024, 256, 100, 256),
              (1, 40, 40, 256, 96, None, 64)]
# head dims the kernel is not compiled for (run zero-padded to 64, 128 and
# 192): a transformer policy's (d_model 96, 2 heads), a 96-wide head and a
# 160-wide one at 256 and 1024 tokens (window 300)
FLASH_PADDED = [(1, 2, 2, 9, 48, None), (2, 4, 2, 130, 48, 100),
                (1, 8, 2, 256, 96, None), (1, 8, 2, 256, 160, None),
                (1, 8, 2, 1024, 160, 300)]
#: the card against the CPU at DeepSeek-V2-Lite's width: prefill logits
#: within this share of their largest entry (f32 sums in other orders over
#: d 2048, 64 experts of width 1408 and a residual stream of O(100); an
#: H100 run measured 2.4e-6)
MOE_REL_TOL = 1e-5
#: the card against the CPU at Hymba-1.5B's and xLSTM-350M's widths:
#: prefill logits within this share of their largest entry (f32 sums in
#: other orders, carried through every step of the scans; an H100 run
#: measured 2.5e-6 and 2.8e-6 over prompts of up to 128 tokens)
REC_REL_TOL = 1e-5
N_ITER, NU = 32, 1e-6
F32_EPS = 2.0 ** -23


def log(msg: str) -> None:
    print(msg, flush=True)


ROUNDS = 5            # repetitions of every paired timing; medians kept


def time_ms(fn, reps: int, warm: int = 3) -> float:
    """Issue-bound time: mean ms per call of a Python loop of ``reps``
    calls, by CUDA events. For a small kernel this is the host's cost of
    issuing one call."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


class GraphTimer:
    """Device time: ``reps`` calls of ``fn`` captured once in a CUDA graph;
    :meth:`ms` replays it and returns ms per call by CUDA events, without
    the host's cost of issuing the calls."""

    def __init__(self, fn, reps: int):
        import torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(reps):
                fn()
        self.reps = reps
        self.graph.replay()
        torch.cuda.synchronize()

    def ms(self) -> float:
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / self.reps


def paired_ms(fn, lib, reps: int, device: bool = True) -> dict:
    """The kernel and its library call timed in turns (kernel, library,
    library, kernel), ``ROUNDS`` times, medians: the issue-bound time
    (``ms``, ``library_ms``) and, when ``device``, the device time by
    graph replay (``device_ms``, ``library_device_ms``). ``lib`` may be
    None; absent numbers are None."""
    out = dict(ms=None, library_ms=None, device_ms=None,
               library_device_ms=None)
    issue = {"k": [], "l": []}
    for _ in range(ROUNDS):
        for who in ("k", "l", "l", "k"):
            if who == "k" or lib is not None:
                issue[who].append(time_ms(fn if who == "k" else lib, reps))
    out["ms"] = _median(issue["k"])
    if lib is not None:
        out["library_ms"] = _median(issue["l"])
    if device:
        timers = {"k": GraphTimer(fn, reps)}
        if lib is not None:
            timers["l"] = GraphTimer(lib, reps)
        dev = {"k": [], "l": []}
        for _ in range(ROUNDS):
            for who in ("k", "l", "l", "k"):
                if who in timers:
                    dev[who].append(timers[who].ms())
        out["device_ms"] = _median(dev["k"])
        if lib is not None:
            out["library_device_ms"] = _median(dev["l"])
        del timers
    return out


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_card():
    out = card()
    log(out)
    return out


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build()
    info = _build.BUILD_INFO
    log(f"[build] sources {[p.name for p in _build.sources()]}")
    log(f"[build] {_build.library_path().name} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s)")
    for line in info["ptxas"].splitlines():
        log(f"[build] {line}")


def phase_kernels(dev):
    """gram, weiszfeld and wsum against their plain versions at the main
    path's shapes and the large stacks, with issue-bound and device times
    beside ``torch.bmm``'s, measured the same way in turns."""
    import torch
    from repro_torch.kernels.pairwise_dist import gram, gram_plain
    from repro_torch.kernels.rfa import (weighted_sum, weighted_sum_plain,
                                         weiszfeld_plain, weiszfeld_weights)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = {}
    for shape in MAIN_SHAPES + LARGE_SHAPES:
        bt, k, d = shape
        large = shape in LARGE_SHAPES
        reps = 5 if large else 200
        x = torch.randn(shape, generator=gen, device=dev) + 1.5

        # gram: the kernel sums each chunk's products per thread, then
        # over threads and chunks in fixed orders; the plain version sums
        # each chunk with PyTorch's reduction: f32 error relative to max|G|
        g = gram(x)
        g_plain = gram_plain(x)
        scale = g_plain.abs().max().item()
        err = (g - g_plain).abs().max().item()
        tol = 2e-5 * scale
        if not torch.equal(g, gram(x)):
            raise AssertionError(f"gram {shape}: rerun is not bit-identical")
        if not torch.equal(g, g.transpose(1, 2)):
            raise AssertionError(f"gram {shape}: G is not exactly "
                                 f"symmetric")
        if not err <= tol:
            raise AssertionError(f"gram {shape}: max abs err {err} > {tol}")
        b = bound(4 * (bt * k * d + bt * k * k), 2 * bt * k * k * d)
        xt = x.transpose(1, 2)
        rows[("gram", shape)] = dict(
            err=err, rel=err / scale, tol=tol, large=large,
            **paired_ms(lambda: gram(x), lambda: torch.bmm(x, xt), reps),
            plain_ms=time_ms(lambda: gram_plain(x), max(reps // 10, 2), 1),
            bound_ms=b[0], bound_by=b[1])

        # weiszfeld on the kernel's Gram matrices: the plain version is the
        # kernel's order of IEEE operations, so the bits must be equal
        w = weiszfeld_weights(g, NU, N_ITER)
        w_plain = weiszfeld_plain(g, NU, N_ITER)
        err = (w - w_plain).abs().max().item()
        tol = 0.0
        if not torch.equal(w, weiszfeld_weights(g, NU, N_ITER)):
            raise AssertionError(f"weiszfeld {shape}: rerun is not "
                                 f"bit-identical")
        if not torch.equal(w, w_plain):
            raise AssertionError(f"weiszfeld {shape}: max abs err {err} > "
                                 f"{tol}")
        b = bound(4 * (bt * k * k + bt * k), N_ITER * bt * (2 * k * k + 8 * k))
        rows[("weiszfeld", shape)] = dict(
            err=err, rel=err, tol=tol, large=large,
            **paired_ms(lambda: weiszfeld_weights(g, NU, N_ITER), None,
                        reps),
            plain_ms=time_ms(lambda: weiszfeld_plain(g, NU, N_ITER),
                             max(reps // 10, 2), 1),
            bound_ms=b[0], bound_by=b[1])

        # wsum: one fused multiply-add chain per coordinate
        z = weighted_sum(x, w)
        z_plain = weighted_sum_plain(x, w)
        scale = x.abs().max().item()
        err = (z - z_plain).abs().max().item()
        tol = 1e-5 * scale
        if not torch.equal(z, weighted_sum(x, w)):
            raise AssertionError(f"wsum {shape}: rerun is not bit-identical")
        if not err <= tol:
            raise AssertionError(f"wsum {shape}: max abs err {err} > {tol}")
        b = bound(4 * (bt * k * d + bt * k + bt * d), 2 * bt * k * d)
        wv = w[:, None, :]
        rows[("wsum", shape)] = dict(
            err=err, rel=err / scale, tol=tol, large=large,
            **paired_ms(lambda: weighted_sum(x, w), lambda: torch.bmm(wv, x),
                        reps),
            plain_ms=time_ms(lambda: weighted_sum_plain(x, w),
                             max(reps // 10, 2), 1),
            bound_ms=b[0], bound_by=b[1])
        del x, xt, g, g_plain, z, z_plain
        torch.cuda.empty_cache()
    return rows


def _library_reduce(recv, mode: str, n_trim: int):
    """The nearest library path to a cw reduce of recv (K, P, d) over P:
    ``torch.sort`` and a slice mean (the plain mean for ``mean``)."""
    import torch
    p = recv.shape[1]
    if mode == "mean":
        return recv.mean(1)
    s = torch.sort(recv, dim=1).values
    lo, hi = ((p - 1) // 2, p // 2 + 1) if mode == "median" \
        else (n_trim, p - n_trim)
    return s[:, lo:hi].mean(1)


def _library_krum(g, n_near: int):
    """Krum scores by ``torch.sort`` of D² and a slice sum."""
    import torch
    sq = torch.diagonal(g, dim1=-2, dim2=-1)
    d2 = torch.clamp_min(sq[..., :, None] + sq[..., None, :] - 2.0 * g, 0.0)
    return torch.sort(d2, dim=-1).values[..., 1:n_near + 1].sum(-1)


def phase_cw_kernels(dev):
    """Krum scores, the trimmed mean and the gossip reduces against their
    plain versions. The plain versions sum in the kernels' order, so the
    expected difference is 0; the stated tolerance, P·eps·max|x| for the
    reduces (K·eps·max|score| for Krum), is what another summation order
    could cost. Integer-grid inputs make every sum exact and must match
    bit for bit, which checks the selection and the tie rule exactly."""
    import torch
    from repro_torch.kernels.gossip_reduce import (
        gossip_reduce, gossip_reduce_plain, neighbor_reduce,
        neighbor_reduce_plain)
    from repro_torch.kernels.krum_score import krum_score, krum_score_plain
    from repro_torch.kernels.pairwise_dist import gram
    from repro_torch.kernels.trimmed_mean import (trimmed_mean,
                                                  trimmed_mean_plain)
    from repro_torch.topology import resolve_topology

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def draw(shape, grid=False):
        if grid:
            return torch.randint(-4, 5, shape, generator=gen,
                                 device=dev).float()
        return torch.randn(shape, generator=gen, device=dev)

    def nbr_of(topology):
        return torch.as_tensor(resolve_topology(topology, 13).nbr_idx,
                               dtype=torch.int64, device=dev)

    rows = {}

    def check(name, label, fn, plain, library, args, *, scale, p, grid,
              large, nbytes, ops):
        out = fn(*args)
        ref = plain(*args)
        if not torch.equal(out, fn(*args)):
            raise AssertionError(f"{name} {label}: rerun is not "
                                 f"bit-identical")
        err = (out - ref).abs().max().item()
        tol = 0.0 if grid else p * F32_EPS * scale
        if not err <= tol:
            raise AssertionError(f"{name} {label}: max abs err {err} > "
                                 f"{tol}")
        lib_err = (library(*args) - out).abs().max().item()
        reps = 5 if large else 200
        b = bound(nbytes, ops)
        rows[(name, label)] = dict(
            err=err, rel=err / max(scale, 1e-30), tol=tol, large=large,
            lib_err=lib_err,
            **paired_ms(lambda: fn(*args), lambda: library(*args), reps,
                        device=large or label == HEADLINE[name]),
            plain_ms=time_ms(lambda: plain(*args), max(reps // 10, 2), 1),
            bound_ms=b[0], bound_by=b[1])

    # krum_score on the Gram matrices of the main path's stacks: CartPole
    # Krum (n_byz=3, n_near=8), LunarLander Krum (n_byz=0 counts as 1,
    # n_near=10), Krum's buckets at n_byz=1 (5 bucket means per receiver,
    # n_near=2), an integer grid, and 2^20 Gram matrices of 13 agents
    for (bt, k, d), n_near, grid in [((1, 13, 386), 8, False),
                                     ((1, 13, 4868), 10, False),
                                     ((13, 5, 386), 2, False),
                                     ((1, 13, 386), 8, True)]:
        g = gram(draw((bt, k, d), grid))
        scale = krum_score_plain(g, n_near).abs().max().item()
        check("krum_score", f"x {(bt, k, d)} n_near={n_near}"
              + (" grid" if grid else ""), krum_score, krum_score_plain,
              _library_krum, (g, n_near), scale=scale, p=k, grid=grid,
              large=False, nbytes=4 * (bt * k * k + bt * k),
              ops=bt * k * k * k)
    bt, k = LARGE_CW["krum_bt"], 13
    x = draw((bt, k, 16))
    g = torch.matmul(x, x.transpose(1, 2))       # input only, not timed
    del x
    scale = krum_score_plain(g, 8).abs().max().item()
    check("krum_score", f"G {(bt, k, k)} n_near=8", krum_score,
          krum_score_plain, _library_krum, (g, 8), scale=scale, p=k,
          grid=False, large=True, nbytes=4 * (bt * k * k + bt * k),
          ops=bt * k * k * k)
    del g

    # trimmed_mean over the 13 agents' messages (n_byz=3)
    for (bt, k, d), n_trim, grid, large in [
            ((1, 13, 386), 3, False, False), ((1, 13, 4868), 3, False, False),
            ((1, 13, 386), 3, True, False),
            ((1, 13, LARGE_CW["trimmed_d"]), 3, False, True)]:
        x = draw((bt, k, d), grid)
        check("trimmed_mean", f"{(bt, k, d)} n_trim={n_trim}"
              + (" grid" if grid else ""), trimmed_mean, trimmed_mean_plain,
              lambda x, nt: _library_reduce(x, "trimmed", nt), (x, n_trim),
              scale=x.abs().max().item(), p=k, grid=grid, large=large,
              nbytes=4 * (bt * k * d + bt * d), ops=bt * d * k * k)
        del x

    # the gossip reduces on the complete graph (P=13) and ring(k=4) (P=5)
    modes = {13: [("mean", 0), ("median", 0), ("trimmed", 3)],
             5: [("mean", 0), ("median", 0), ("trimmed", 2)]}
    cases = [("complete", 386, False, False), ("ring(k=4)", 386, False, False),
             ("complete", 4868, False, False), ("complete", 386, True, False)]
    for topology, d, grid, large in cases + [
            ("complete", LARGE_CW["gossip_d"], False, True)]:
        nbr = nbr_of(topology)
        k, p = nbr.shape
        msgs = draw((k, d), grid)
        for mode, n_trim in modes[p]:
            if large and mode != "trimmed":
                continue
            ops = k * d * (p if mode == "mean" else p * p)
            tag = (f"P={p} {mode}" + (f" n_trim={n_trim}" if n_trim else "")
                   + (" grid" if grid else ""))
            check("gossip_reduce", f"{(k, d)} {tag}", gossip_reduce,
                  gossip_reduce_plain,
                  lambda m, nb, md, nt: _library_reduce(m[nb], md, nt),
                  (msgs, nbr, mode, n_trim), scale=msgs.abs().max().item(),
                  p=p, grid=grid, large=large,
                  nbytes=4 * 2 * k * d + 8 * k * p, ops=ops)
        del msgs
    for topology, d, grid, large in cases + [
            ("complete", LARGE_CW["neighbor_d"], False, True)]:
        k, p = nbr_of(topology).shape
        recv = draw((k, p, d), grid)
        for mode, n_trim in modes[p]:
            if large and mode != "median":
                continue
            ops = k * d * (p if mode == "mean" else p * p)
            tag = (f"{mode}" + (f" n_trim={n_trim}" if n_trim else "")
                   + (" grid" if grid else ""))
            check("neighbor_reduce", f"{(k, p, d)} {tag}", neighbor_reduce,
                  neighbor_reduce_plain, _library_reduce,
                  (recv, mode, n_trim), scale=recv.abs().max().item(),
                  p=p, grid=grid, large=large,
                  nbytes=4 * (k * p * d + k * d), ops=ops)
        del recv
        torch.cuda.empty_cache()
    phase_cw_edges(dev, draw)
    phase_k_edges(dev)
    for (name, label), r in rows.items():
        if r["large"]:
            log(f"[large] {name} {label}: device {r['device_ms']:.6f} ms, "
                f"issue {r['ms']:.6f} ms, bound {r['bound_ms']:.6f} ms "
                f"({r['bound_by']}, one operation per compare), "
                f"{r['bound_ms'] / r['device_ms']:.1%} of the bound; "
                f"library device {r['library_device_ms']:.6f} ms")
    return rows


def phase_cw_edges(dev, draw):
    """The cw kernels at the slot counts on the edges of their rank
    networks' instances (``CW_EDGES``), on an integer grid with a NaN, a
    +inf and a -inf slot in some coordinates: bit for bit against the
    plain versions (NaN in the same places) in every mode, reruns
    bit-identical. ``gossip_reduce`` gathers from a random (13, P) table,
    ``neighbor_reduce`` reduces (13, P, 386), ``trimmed_mean`` (1, P, 386)
    over P agents."""
    import torch
    from repro_torch.kernels.gossip_reduce import (
        cw_reduce, gossip_reduce, gossip_reduce_plain, neighbor_reduce,
        neighbor_reduce_plain)
    from repro_torch.kernels.trimmed_mean import (trimmed_mean,
                                                  trimmed_mean_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)

    def specials(x):
        x[..., 0, 1] = float("nan")
        x[..., -1, 2] = float("inf")
        x[..., 0, 3] = float("-inf")
        return x

    def same(name, fn, plain, *args):
        out = fn(*args)
        for other in (fn(*args), plain(*args)):
            torch.testing.assert_close(out, other, rtol=0, atol=0,
                                       equal_nan=True, msg=lambda m: (
                                           f"{name} P={p}: {m}"))

    d = 386
    for p in CW_EDGES:
        nbr = torch.randint(0, 13, (13, p), generator=gen, device=dev)
        msgs = specials(draw((13, d), True))
        recv = specials(draw((13, p, d), True))
        for mode, n_trim in (("mean", 0), ("median", 0),
                             ("trimmed", (p - 1) // 2)):
            same("gossip_reduce", gossip_reduce, gossip_reduce_plain, msgs,
                 nbr, mode, n_trim)
            same("neighbor_reduce", neighbor_reduce, neighbor_reduce_plain,
                 recv, mode, n_trim)
        same("trimmed_mean", trimmed_mean, trimmed_mean_plain,
             specials(draw((1, p, d), True)), (p - 1) // 4)
        log(f"[cw] P={p} (rank network height {cw_reduce.cw_instance(p)}): "
            f"gossip_reduce, neighbor_reduce (mean, median, trimmed) and "
            f"trimmed_mean bit-equal to their plain versions on an integer "
            f"grid with NaN and infinite slots, reruns bit-identical")


def phase_k_edges(dev):
    """``weiszfeld`` and ``krum_score`` at the stack heights on the edges of
    their instances (``K_EDGES``), on the Gram matrices of 13 stacks of
    (K, 386): normal rows, a duplicated row, an outlier row, and NaN and
    infinite entries in G. Bit for bit against the plain versions (NaN in
    the same places), weiszfeld at 0, 1 and 32 steps with one ``nu`` and
    with another ``nu`` in every batch element, and krum_score at three
    n_near; reruns bit-identical."""
    import torch
    from repro_torch.kernels.gossip_reduce import cw_reduce
    from repro_torch.kernels.krum_score import krum_score, krum_score_plain
    from repro_torch.kernels.pairwise_dist import gram
    from repro_torch.kernels.rfa import (weiszfeld_instance, weiszfeld_plain,
                                         weiszfeld_weights)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)

    def same(name, fn, plain, *args):
        out = fn(*args)
        for other in (fn(*args), plain(*args)):
            torch.testing.assert_close(out, other, rtol=0, atol=0,
                                       equal_nan=True, msg=lambda m: (
                                           f"{name} K={k} {args[1:]}: {m}"))

    for k in K_EDGES:
        x = torch.randn((13, k, 386), generator=gen, device=dev) + 1.0
        x[1, k - 1] = x[1, 0]                           # a duplicated row
        x[2, k // 2] += 100.0                           # an outlier row
        g = gram(x)
        specials = g.clone()
        specials[3, 0, k - 1] = float("nan")
        specials[4, k - 1, k // 2] = float("inf")
        specials[5, k // 2, k // 2] = float("inf")
        specials[6, 0, k - 1] = specials[6, k - 1, 0] = float("-inf")
        # a lane group sweeping rfa(nu=...): another nu in every row
        nus = NU * torch.logspace(0, 6, 13, device=dev)
        for gg in (g, specials):
            for n_iter in (0, 1, N_ITER):
                same("weiszfeld", weiszfeld_weights, weiszfeld_plain, gg, NU,
                     n_iter)
                same("weiszfeld", weiszfeld_weights, weiszfeld_plain, gg,
                     nus, n_iter)
            for n_near in sorted({1, max(k // 2, 1), max(k - 1, 1)}):
                same("krum_score", krum_score, krum_score_plain, gg, n_near)
        log(f"[edges] K={k} (weiszfeld height {weiszfeld_instance(k)}, "
            f"krum_score rank network height {cw_reduce.cw_instance(k)}): "
            f"both bit-equal to their plain versions on normal, duplicated "
            f"and outlier rows and on G with NaN and infinite entries "
            f"(weiszfeld with one nu and with a nu per row), reruns "
            f"bit-identical")


def _flash_pairs(S: int, window) -> int:
    """Unmasked (query, key) pairs of one head's causal attention."""
    if window is None:
        return S * (S + 1) // 2
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def phase_flash(dev):
    """The flash-attention kernel against its plain version. Both sum in
    f32 in other orders (FMA chains against matmul blockings), so the
    stated tolerance is 2e-5·max|v|, the reference's own for its f32
    kernel tests; reruns must be bit-identical. SDPA (f32, GQA, causal,
    a boolean mask for the windows) is timed as the yardstick and its
    distance from the kernel reported; the port never calls it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention.flash_attention import (
        KERNEL_INSTANCES, kernel_shared_bytes)
    log(f"[flash] dynamic shared memory per block, by (q/k, v) head dim: "
        f"{ {i: kernel_shared_bytes(*i) for i in KERNEL_INSTANCES} } "
        f"bytes (registers and spills: the build's ptxas lines)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    rows = {}
    for case in FLASH_CASES + FLASH_WIDE + [FLASH_LARGE]:
        B, H, Hkv, S, hd, window = case[:6]
        hd_v = case[6] if len(case) > 6 else hd
        large = case == FLASH_LARGE
        q = torch.randn((B * H, S, hd), generator=gen, device=dev)
        k = torch.randn((B * Hkv, S, hd), generator=gen, device=dev)
        v = torch.randn((B * Hkv, S, hd_v), generator=gen, device=dev)
        out = flash_attention_kernel(q, k, v, H, window)
        if not torch.equal(out, flash_attention_kernel(q, k, v, H, window)):
            raise AssertionError(f"flash_attention {case}: rerun is not "
                                 f"bit-identical")
        ref = flash_attention_plain(q, k, v, H, window)
        scale = v.abs().max().item()
        err = (out - ref).abs().max().item()
        tol = 2e-5 * scale
        if not err <= tol:
            raise AssertionError(f"flash_attention {case}: max abs err "
                                 f"{err} > {tol}")
        q4 = q.reshape(B, H, S, hd)
        k4 = k.reshape(B, Hkv, S, hd)
        v4 = v.reshape(B, Hkv, S, hd_v)
        if window is None:
            def sdpa():
                return F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True, enable_gqa=True)
        else:
            pos = torch.arange(S, device=dev)
            mask = (pos[None, :] <= pos[:, None]) \
                & ((pos[:, None] - pos[None, :]) < window)

            def sdpa():
                return F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask, enable_gqa=True)
        lib_err = (sdpa().reshape(B * H, S, hd_v) - out).abs().max().item()
        pairs = B * H * _flash_pairs(S, window)
        # q and k read at hd, v read and o written at hd_v; Q K^T and P V
        b = bound(4 * (B * H * S + B * Hkv * S) * (hd + hd_v),
                  2 * (hd + hd_v) * pairs)
        # 1024 tokens and more: fewer calls per timing (each takes 0.1-1
        # ms, and the plain version's tile loop about 100)
        reps = 5 if large else 20 if S >= 1024 else 100
        label = f"q {tuple(q.shape)} kv {tuple(k.shape)}" + (
            f" v {hd_v}" if hd_v != hd else "") + (
            f" window={window}" if window is not None else "")
        rows[("flash_attention", label)] = dict(
            err=err, rel=err / scale, tol=tol, large=large, lib_err=lib_err,
            **paired_ms(lambda: flash_attention_kernel(q, k, v, H, window),
                        sdpa, reps, device=label in FLASH_DEVICE),
            plain_ms=time_ms(lambda: flash_attention_plain(q, k, v, H,
                                                           window),
                             2 if S >= 1024 else 10, 1),
            bound_ms=b[0], bound_by=b[1])
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    phase_flash_layout(dev)
    phase_flash_padded(dev)
    return rows


#: the training route at Llama-3.2-1B's layer shape (B, S, H, Hkv, hd)
TRAIN_ATTN = (1, 512, 32, 8, 64)


def phase_train_attention(dev):
    """The training route, ``chunked_causal_attention``, on the card: at
    Llama-3.2-1B's layer shape (:data:`TRAIN_ATTN`, chunk 128) it equals
    the flash kernel's forward within 1e-5 abs, with and without a window
    of 128 (both f32, summed in other orders); at (1, 96, 4, 64) over 2
    KV heads (chunk 32, positions offset by 7), its output and dq, dk, dv
    equal the same computation on the CPU in float64 within 1e-4 of each
    tensor's largest entry; a backward through the flash op raises. These
    launches compare routes and join no total."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.attention import chunked_causal_attention
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    B, S, H, Hkv, hd = TRAIN_ATTN
    q = torch.randn((B, S, H, hd), generator=gen, device=dev)
    k = torch.randn((B, S, Hkv, hd), generator=gen, device=dev)
    v = torch.randn((B, S, Hkv, hd), generator=gen, device=dev)
    pos = torch.arange(S, device=dev)
    with torch.no_grad():
        for window in (None, 128):
            got = chunked_causal_attention(q, k, v, pos, pos, window=window,
                                           chunk=128)
            err = (got - flash_attention(q, k, v, window)).abs().max().item()
            if not err <= 1e-5:
                raise AssertionError(f"chunked vs flash {TRAIN_ATTN} window "
                                     f"{window}: max abs err {err} > 1e-5")
            log(f"[train] chunked route vs the flash kernel, q "
                f"{tuple(q.shape)} kv {tuple(k.shape)} chunk 128 window "
                f"{window}: max abs err {err:.3e} (tol 1e-5)")
    cpu = torch.Generator()
    cpu.manual_seed(7)
    qkv = [torch.randn(shape, generator=cpu, dtype=torch.float64)
           for shape in ((1, 96, 4, 64), (1, 96, 2, 64), (1, 96, 2, 64))]
    ct = torch.randn((1, 96, 4, 64), generator=cpu, dtype=torch.float64)
    res = {}
    for d, dt in ((dev, torch.float32), (torch.device("cpu"),
                                         torch.float64)):
        ts = [x.to(d, dt).requires_grad_(True) for x in qkv]
        p = torch.arange(96, device=d) + 7
        out = chunked_causal_attention(*ts, p, p, chunk=32)
        (out * ct.to(d, dt)).sum().backward()
        res[d.type] = [out.detach()] + [t.grad for t in ts]
    errs = []
    for name, a, b in zip(("out", "dq", "dk", "dv"), res[dev.type],
                          res["cpu"]):
        err = (a.cpu().double() - b).abs().max().item()
        errs.append(f"{name} {err:.3e}")
        if not err <= 1e-4 * b.abs().max().item():
            raise AssertionError(f"chunked route on the card vs float64 on "
                                 f"the CPU, {name}: {err} > 1e-4 * max")
    qg = q[:, :8].clone().requires_grad_(True)
    try:
        flash_attention(qg, k[:, :8], v[:, :8]).sum().backward()
    except NotImplementedError:
        pass
    else:
        raise AssertionError("a backward through the flash op did not raise")
    log(f"[train] chunked route (1, 96, 4, 64) over 2 KV heads, chunk 32, "
        f"positions 7..102, card f32 vs CPU float64: max abs err "
        f"{', '.join(errs)} (tol 1e-4 of each max); the flash op's "
        f"backward raises NotImplementedError")


def phase_lm_loss_full_width(dev):
    """Llama-3.2-1B at full width and depth (random init, seed 0) on a
    ``TokenPipeline`` batch of 2 x 1025 tokens: the no-grad forward's
    flash launches equal the plain version on their own inputs
    (:class:`_PathInputs`), the chunked route's logits equal the flash
    route's within 1e-5 of max|logits|, ``lm_loss`` (the chunked route,
    ``remat=True``) equals the cross-entropy of the flash route's no-grad
    forward within 1e-5 (ten times the gap measured on the H100), its
    backward gives finite
    gradients on every leaf and launches no flash kernel, and three steps
    of the port's Adam (lr 1e-4) lower the loss at every step. Returns
    the launches of the no-grad forward (16 flash)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_paths
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import dispatch
    from repro_torch.models.model import (_cross_entropy, forward,
                                          init_params, lm_loss)
    from repro_torch.optim.optimizers import adam
    cfg = get_config("llama3.2-1b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    toks = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=1025,
                                    per_agent_batch=2, seed=0),
                         device=dev).batch(0)["tokens"][0]
    torch.cuda.synchronize()
    dispatch.reset_launches()
    with torch.no_grad(), _PathInputs() as path:
        logits, _, _ = forward(cfg, params, toks[:, :-1])
        want = _cross_entropy(logits, toks[:, 1:]).item()
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    _check_launches("llama3.2-1b no-grad forward", counts,
                    {"flash_attention": cfg.n_layers})
    path.check("llama3.2-1b no-grad forward")
    with torch.no_grad():
        chunked, _, _ = forward(cfg, params, toks[:, :-1],
                                attention="chunked")
    logit_scale = logits.abs().max().item()
    logit_err = (chunked - logits).abs().max().item()
    if not logit_err <= 1e-5 * logit_scale:
        raise AssertionError(f"llama3.2-1b logits, chunked vs flash route: "
                             f"max abs err {logit_err} > 1e-5 * "
                             f"{logit_scale}")
    del logits, chunked
    leaves = [t for _, t in tree_paths(params)]
    for t in leaves:
        t.requires_grad_(True)

    def loss_and_grad():
        for t in leaves:
            t.grad = None
        loss = lm_loss(cfg, params, toks)
        loss.backward()
        return loss.item()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    loss = loss_and_grad()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    _check_launches("llama3.2-1b lm_loss backward", dispatch.launch_counts(),
                    {})
    if not abs(loss - want) <= 1e-5:
        raise AssertionError(f"lm_loss {loss} vs the flash forward's "
                             f"cross-entropy {want}: |diff| > 1e-5")
    bad = [p for p, t in tree_paths(params)
           if t.grad is None or not bool(torch.isfinite(t.grad).all())]
    if bad:
        raise AssertionError(f"lm_loss: no or non-finite gradient at {bad}")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_and_grad()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    opt = adam(1e-4, maximize=False)
    state = [opt.init(t.detach()) for t in leaves]
    losses = [loss]
    for step in range(3):
        with torch.no_grad():
            for i, t in enumerate(leaves):
                new, state[i] = opt.update(t.grad, state[i], t)
                t.copy_(new)
            if step == 2:                   # the last loss needs no grad
                losses.append(lm_loss(cfg, params, toks).item())
        if step < 2:
            losses.append(loss_and_grad())
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"Adam did not lower the loss: {losses}")
    log(f"[lm] {card()}: llama3.2-1b full width ({cfg.n_layers} L, d "
        f"{cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {sum(t.numel() for t in leaves)} "
        f"parameters), batch 2 x 1025 tokens: logits of the chunked route "
        f"vs the flash route max abs err {logit_err:.3e} (tol 1e-5 x max "
        f"{logit_scale:.6f}); lm_loss {loss:.6f} vs the flash forward's "
        f"{want:.6f} (|diff| {abs(loss - want):.3e}, tol 1e-5); gradients "
        f"finite on {len(leaves)} leaves, 0 "
        f"flash launches under autograd; forward+backward median "
        f"{_median(walls):.3f} ms of {[round(w, 3) for w in walls]}; peak "
        f"memory {peak} bytes; no-grad forward flash launches "
        f"{counts['flash_attention']}; Adam lr 1e-4 losses "
        f"{[round(x, 6) for x in losses]}")
    del params, leaves, state
    torch.cuda.empty_cache()
    return counts


def phase_flash_padded(dev):
    """Head dims the kernel is not compiled for (``FLASH_PADDED``) and the
    wide instances with v's own head dim (``FLASH_WIDE``): the wrapper
    zero-pads q and k to the instance's q/k head dim and v to its v head
    dim where they fall short, and passes the true scale. Each must launch
    the kernel (never the plain version), agree with the plain version at
    the true head dims (2e-5·max|v|), rerun bit-identically, and give the
    folded launch's bits through the model layout."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_kernel,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention.flash_attention import (
        kernel_instance)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for case in FLASH_PADDED + FLASH_WIDE:
        B, H, Hkv, S, hd, window = case[:6]
        hd_v = case[6] if len(case) > 6 else hd
        q = torch.randn((B * H, S, hd), generator=gen, device=dev)
        k = torch.randn((B * Hkv, S, hd), generator=gen, device=dev)
        v = torch.randn((B * Hkv, S, hd_v), generator=gen, device=dev)
        before = dispatch.launch_counts()["flash_attention"]
        out = flash_attention_kernel(q, k, v, H, window)
        rerun = flash_attention_kernel(q, k, v, H, window)
        layout = flash_attention(*(x.reshape(B, -1, S, x.shape[-1])
                                   .transpose(1, 2) for x in (q, k, v)),
                                 window)
        torch.cuda.synchronize()
        launched = dispatch.launch_counts()["flash_attention"] - before
        err = (out - flash_attention_plain(q, k, v, H, window)).abs().max()
        tol = 2e-5 * v.abs().max().item()
        unfold = out.reshape(B, H, S, hd_v).transpose(1, 2)
        if not (launched == 3 and err.item() <= tol
                and torch.equal(out, rerun) and torch.equal(layout, unfold)):
            raise AssertionError(
                f"flash_attention at head dims {hd}/{hd_v} "
                f"{(B, H, Hkv, S, window)}: {launched} launches of 3, max "
                f"abs err {err.item()} (tol {tol}), rerun equal "
                f"{torch.equal(out, rerun)}, layout equal "
                f"{torch.equal(layout, unfold)}")
        ms = time_ms(lambda: flash_attention_kernel(q, k, v, H, window), 50)
        log(f"[flash] head dims {hd}/{hd_v} on the "
            f"{kernel_instance(hd, hd_v)} instance, q {tuple(q.shape)} kv "
            f"{tuple(k.shape)} window {window}: max abs err "
            f"{err.item():.3e} against the plain version (tol {tol:.3e}), "
            f"rerun and model layout bit-equal, issue-bound {ms:.6f} ms")


def phase_flash_layout(dev):
    """The model-layout launch on strided tensors, as the serving path
    hands them over: q, k and v sliced out of one fused (B, S, H + 2·Hkv,
    hd) tensor at Llama-3.2-1B's and Qwen2.5-3B's widths, against the
    plain version on contiguous folded copies (tolerance 2e-5·max|v|) and
    against the folded launch on those copies (the same bits)."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    for case in [(1, 32, 8, 512, 64, None), (2, 32, 8, 130, 64, 100),
                 (1, 16, 2, 256, 128, None)]:
        B, H, Hkv, S, hd, window = case
        fused = torch.randn((B, S, H + 2 * Hkv, hd), generator=gen,
                            device=dev)
        q, k, v = (fused[:, :, :H], fused[:, :, H:H + Hkv],
                   fused[:, :, H + Hkv:])
        out = flash_attention_kernel(q, k, v, window=window)
        fold = [x.transpose(1, 2).reshape(B * x.shape[2], S, hd).contiguous()
                for x in (q, k, v)]
        ref = flash_attention_plain(*fold, H, window)
        folded = flash_attention_kernel(*fold, H, window)
        unfold = folded.reshape(B, H, S, hd).transpose(1, 2)
        err = (out - ref.reshape(B, H, S, hd).transpose(1, 2)).abs().max()
        tol = 2e-5 * v.abs().max().item()
        if not err.item() <= tol or not torch.equal(out, unfold):
            raise AssertionError(f"flash_attention model layout {case}: "
                                 f"max abs err {err.item()} (tol {tol}), "
                                 f"equal to the folded launch: "
                                 f"{torch.equal(out, unfold)}")
        log(f"[flash] strided (B, S, H, hd) q {tuple(q.shape)} strides "
            f"{q.stride()}, window {window}: max abs err {err.item():.3e} "
            f"against the plain version (tol {tol:.3e}), bits equal to the "
            f"folded launch")


def log_kernel_rows(rows):
    def num(v):
        return "null" if v is None else f"{v:.6f}"
    log("[kernels] name            input                                   "
        "max_abs_err  max_rel_err  tol          ms         device_ms  "
        "plain_ms   library_ms lib_dev_ms bound_ms  bound_by   "
        "library_vs_kernel")
    for (name, shape), r in rows.items():
        lib_err = f"{r['lib_err']:.3e}" if "lib_err" in r else "-"
        log(f"[kernels] {name:15s} {str(shape):39s} {r['err']:.3e}    "
            f"{r['rel']:.3e}    {r['tol']:.3e}    {num(r['ms']):10s} "
            f"{num(r['device_ms']):10s} {num(r['plain_ms']):10s} "
            f"{num(r['library_ms']):10s} {num(r['library_device_ms']):10s} "
            f"{r['bound_ms']:.6f}  {r['bound_by']:10s} {lib_err}")
    for shape in LARGE_SHAPES:
        for name in ("gram", "wsum"):
            r = rows[(name, shape)]
            log(f"[large] {name} {shape}: device {r['device_ms']:.6f} ms, "
                f"issue {r['ms']:.6f} ms, bound {r['bound_ms']:.6f} ms "
                f"({r['bound_by']}), {r['bound_ms'] / r['device_ms']:.1%} "
                f"of the bound; torch.bmm device "
                f"{r['library_device_ms']:.6f} ms")


def _check_launches(label, counts, want):
    want = {name: want.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")


def _add(totals, counts):
    for name, n in counts.items():
        totals[name] = totals.get(name, 0) + n


def main_runs():
    """(label, env, T, config, launches per iteration) of phase 4."""
    from repro_torch.core.decbyzpg import DecByzPGConfig
    from repro_torch.rl.envs import make_cartpole, make_lunarlander
    cartpole, lunar = make_cartpole(horizon=200), make_lunarlander()
    byz = dict(n_byz=3, attack="large_noise(sigma=10)")
    wide = dict(hidden=(64, 64), activation="tanh")
    rfa_mda = {"gram": 8, "weiszfeld": 1, "wsum": 1}   # 6 MDA, RFA, Δ₂
    krum_cw = {"gram": 2, "krum_score": 1, "gossip_reduce": 6}
    return [
        ("cartpole", cartpole, 8, DecByzPGConfig(**byz), rfa_mda),
        ("lunarlander", lunar, 3, DecByzPGConfig(**wide), rfa_mda),
        ("cartpole_krum_cwtm", cartpole, 8,
         DecByzPGConfig(**byz, aggregator="krum", agreement="cwtm"),
         krum_cw),
        ("cartpole_tm_cwmed_per_receiver", cartpole, 8,
         DecByzPGConfig(**byz, aggregator="trimmed_mean", agreement="cwmed",
                        per_receiver=True),
         {"gram": 1, "trimmed_mean": 1, "neighbor_reduce": 6}),
        ("lunarlander_krum_cwmean", lunar, 3,
         DecByzPGConfig(**wide, aggregator="krum", agreement="cwmean"),
         krum_cw),
    ]


def phase_main_path(dev):
    """Drive ``run_decbyzpg`` as a user would, counting launches: each run
    must launch exactly the kernels of its row. Returns the launches per
    kernel over the runs."""
    import numpy as np
    import torch
    from repro_torch.core.decbyzpg import run_decbyzpg
    from repro_torch.kernels import dispatch

    totals = {}
    for label, env, T, cfg, per_iter in main_runs():
        run_decbyzpg(env, cfg, 1, device=dev)           # warm iteration
        torch.cuda.synchronize()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        out = run_decbyzpg(env, cfg, T, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dispatch.launch_counts()
        d = out["theta"].shape[1]
        if not (np.isfinite(out["returns"]).all()
                and np.isfinite(out["diameter"]).all()
                and bool(torch.isfinite(out["theta"]).all())):
            raise AssertionError(f"{label}: non-finite returns, diameter "
                                 f"or theta")
        if out["returns"].shape != (T,) or out["theta"].shape != (cfg.K, d):
            raise AssertionError(f"{label}: unexpected output shapes")
        if not bool(out["coins"][0]):
            raise AssertionError(f"{label}: coin at t=0 is not 1")
        _check_launches(label, counts,
                        {k: n * T for k, n in per_iter.items()})
        _add(totals, counts)
        log(f"[main] {label}: d={d} T={T} ms/iter={secs / T * 1e3:.3f} "
            f"launches/iter={per_iter} returns={out['returns'].tolist()} "
            f"diameter={out['diameter'].tolist()} "
            f"coins={out['coins'].astype(int).tolist()}")
    return totals


def byzpg_runs():
    """(label, env, T, config, launches per iteration) of the ByzPG phase:
    the paper's Algorithm 1 at its defaults (K=13, N=50, B=4, MLP (16, 16)
    relu). The server aggregates on every iteration: bucketing (7 buckets
    of 2) ∘ RFA on (1, 7, d), Krum on (1, 13, d), the trimmed mean on
    (1, 13, d); no agreement, no diameter."""
    from repro_torch.core.byzpg import ByzPGConfig
    from repro_torch.rl.envs import make_cartpole, make_lunarlander
    cartpole = make_cartpole(horizon=200)
    byz = dict(n_byz=3, attack="large_noise(sigma=10)")
    return [
        ("byzpg_cartpole", cartpole, 8, ByzPGConfig(**byz),
         {"gram": 1, "weiszfeld": 1, "wsum": 1}),
        ("byzpg_cartpole_krum", cartpole, 8,
         ByzPGConfig(**byz, aggregator="krum"),
         {"gram": 1, "krum_score": 1}),
        ("byzpg_lunarlander_tm", make_lunarlander(), 3,
         ByzPGConfig(hidden=(64, 64), activation="tanh", n_byz=3,
                     aggregator="trimmed_mean"),
         {"trimmed_mean": 1}),
    ]


def phase_byzpg(dev):
    """Drive ``run_byzpg`` as a user would, counting launches: each run
    must launch exactly the kernels of its row. Returns the launches per
    kernel over the runs and the ``byzpg_cartpole`` output."""
    import numpy as np
    import torch
    from repro_torch.core.byzpg import run_byzpg
    from repro_torch.kernels import dispatch

    totals, kept = {}, None
    for label, env, T, cfg, per_iter in byzpg_runs():
        run_byzpg(env, cfg, 1, device=dev)              # warm iteration
        torch.cuda.synchronize()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        out = run_byzpg(env, cfg, T, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dispatch.launch_counts()
        d = out["vec"].shape[0]
        if not (np.isfinite(out["returns"]).all()
                and bool(torch.isfinite(out["vec"]).all())):
            raise AssertionError(f"{label}: non-finite returns or theta")
        if out["returns"].shape != (T,) or out["vec"].device.type != dev.type:
            raise AssertionError(f"{label}: unexpected output shapes")
        if not bool(out["coins"][0]):
            raise AssertionError(f"{label}: coin at t=0 is not 1")
        _check_launches(label, counts,
                        {k: n * T for k, n in per_iter.items()})
        _add(totals, counts)
        log(f"[byzpg] {label}: d={d} T={T} ms/iter={secs / T * 1e3:.3f} "
            f"launches/iter={per_iter} returns={out['returns'].tolist()} "
            f"coins={out['coins'].astype(int).tolist()}")
        if label == "byzpg_cartpole":
            kept = out
    return totals, kept


#: the reference's fig5 cell (benchmarks/run.py): ByzPG under two attacks
#: against RFA and the plain mean (Fed-PAGE-PG), and fig1's DecByzPG K axis
#: with its κ override
FIG_T, FIG_SEEDS = 15, (0, 1, 2)
FIG_BASE = dict(env="cartpole(horizon=100)", T=FIG_T, seeds=FIG_SEEDS, N=20,
                B=4, eta=2e-2)


def _fig1_kappa(c):
    import dataclasses
    return dataclasses.replace(c, kappa=4 if c.K > 1 else 0)


def experiment_cells():
    """(label, Experiment kwargs, launches per iteration of one seed by
    scenario); a scenario absent from the map launches nothing."""
    return [
        ("fig5_byzpg", dict(FIG_BASE, algo="byzpg", axes={
            "attack": ("large_noise", "avg_zero"),
            "aggregator": ("rfa", "mean")}, K=13, n_byz=3),
         lambda scn: ({"gram": 1, "weiszfeld": 1, "wsum": 1}
                      if scn.aggregator == "rfa" else {})),
        # n_byz 0: RFA unbucketed on (1, K, d), κ MDA grams and Δ₂'s gram
        ("fig1_decbyzpg", dict(FIG_BASE, algo="decbyzpg",
                               axes={"K": (1, 5, 13)},
                               override=_fig1_kappa),
         lambda scn: {"gram": 2 + (4 if scn.K > 1 else 0), "weiszfeld": 1,
                      "wsum": 1}),
    ]


def phase_experiment(dev):
    """The paper's figure front door, ``Experiment(...).run()`` (lane
    groups): every scenario's (3, 15) seed histories, mean ± CI of the
    final return, wall per iteration, exact launches from the group
    structure, and each seed's row within the lane tolerances of the
    single run for that seed in the first scenario (bit-equal rows
    counted). Returns the
    launches per kernel of the Experiment runs (the checks' single runs
    left out) and, by cell, its result, launches and wall in s."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import Experiment
    from repro_torch.core.engine import (ScenarioGrid, grid_scenarios,
                                         lane_groups)
    from repro_torch.core.registry import resolve
    from repro_torch.kernels import dispatch

    totals, cells = {}, {}
    for label, kw, per_iter in experiment_cells():
        exp = Experiment(device=dev, **kw)
        torch.cuda.synchronize()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        res = exp.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dispatch.launch_counts()
        S = len(FIG_SEEDS)
        n_scn = int(np.prod([len(v) for v in kw["axes"].values()]))
        base = {k: v for k, v in kw.items() if k not in (
            "algo", "env", "T", "seeds", "axes", "override")}
        _, scenarios = grid_scenarios(
            ScenarioGrid(seeds=FIG_SEEDS, axes=kw["axes"]), algo=kw["algo"],
            override=kw.get("override"), base=base)
        groups = lane_groups(scenarios, algo=kw["algo"])
        # one lane group launches per iteration one run's kernels, for
        # all its lanes × seeds rows
        want = {}
        for members in groups.values():
            _add(want, {k: n * FIG_T
                        for k, n in per_iter(members[0][0]).items()})
        if len(res) != n_scn:
            raise AssertionError(f"{label}: {len(res)} scenarios, expected "
                                 f"{n_scn}")
        _check_launches(label, counts, want)
        _add(totals, counts)
        cells[label] = (res, counts, secs)
        for scn, out in res.items():
            if out["returns"].shape != (S, FIG_T) \
                    or not np.isfinite(out["returns"]).all():
                raise AssertionError(f"{label} {scn}: returns of shape "
                                     f"{out['returns'].shape}, or not finite")
            log(f"[experiment] {label} {res.scenario_name(scn)}: final "
                f"return {out['final_return_mean']:.3f} ± "
                f"{out['final_return_ci95']:.3f} (95% CI, {S} seeds)")
        log(f"[experiment] {label}: {n_scn} scenarios x {S} seeds x T="
            f"{FIG_T} in {len(groups)} lane groups, {secs:.3f} s: "
            f"{secs / FIG_T * 1e3:.3f} ms per iteration of the whole grid, "
            f"{secs / (len(groups) * FIG_T) * 1e3:.3f} ms per iteration of "
            f"one lane group; launches {counts}")
        # the first scenario's rows against its single runs
        scn, cfg = scenarios[0]
        out, a = res[scn], resolve("algo", kw["algo"])
        equal = 0
        for i, s in enumerate(FIG_SEEDS):
            one = a.run(exp.env, dataclasses.replace(cfg, seed=s), FIG_T,
                        device=dev)
            theta = one[a.carry_hist].cpu().numpy()
            gap_r = float(np.abs(one["returns"] - out["returns"][i]).max())
            gap_t = float(np.abs(theta - out[a.carry_hist][i]).max())
            if not (gap_r <= LANE_TOL["returns"]
                    and gap_t <= LANE_TOL["theta"]
                    and np.array_equal(one["samples"], out["samples"][i])):
                raise AssertionError(f"{label} {scn} seed {s}: the grid's "
                                     f"row is {gap_r} (returns), {gap_t} "
                                     f"(θ) from the single run")
            equal += bool(np.array_equal(one["returns"], out["returns"][i])
                          and np.array_equal(theta, out[a.carry_hist][i]))
        log(f"[experiment] {label} {res.scenario_name(scn)}: each seed's "
            f"row within the lane tolerances of its single run, {equal} of "
            f"{S} bit-equal")
    return totals, cells


#: the sweep CLI's grid (phase 7b): DecByzPG at the paper's K=13 under
#: large_noise, Krum or the trimmed mean, cwtm κ=6 with a consistent or a
#: per-receiver attack, 2 seeds, T=6 in 3 windows
CLI_ENV = "cartpole(horizon=100)"
CLI_AXES = {"aggregator": ("krum", "trimmed_mean"),
            "per_receiver": (False, True)}
CLI_BASE = dict(K=13, n_byz=3, attack="large_noise(sigma=10)", N=20, B=4,
                agreement="cwtm")
CLI_T, CLI_SEEDS, CLI_WINDOWS = 6, (0, 1), 3
#: each fresh process's wall limit
CLI_TIMEOUT_S = 300


def cli_grid_args() -> list:
    """The CLI flags of the grid above."""
    return ["--algo", "decbyzpg", "--env", CLI_ENV, "--T", str(CLI_T),
            "--seeds", str(len(CLI_SEEDS)), "--windows", str(CLI_WINDOWS),
            *[a for k, v in CLI_AXES.items()
              for a in ("--axis", f"{k}={','.join(map(str, v))}")],
            *[a for k, v in CLI_BASE.items() for a in ("--set", f"{k}={v}")]]


def cli_per_iter(scn) -> dict:
    """Launches per iteration of one seed of the CLI grid (§4 of PERF.md):
    Krum's gram and Δ₂'s, or Δ₂'s alone; κ = 6 cwtm rounds, fused with
    the gather for a consistent attack, on the gathered tensor per
    receiver."""
    agg = {"gram": 2, "krum_score": 1} if scn["aggregator"] == "krum" \
        else {"gram": 1, "trimmed_mean": 1}
    agree = "neighbor_reduce" if scn["per_receiver"] else "gossip_reduce"
    return {**agg, agree: 6}


def cli_launches(windows, processes: int = 1) -> dict:
    """Launches of the CLI grid's (group, t0, t1) windows, all seeds; the
    groups are the grid's scenarios in order (no axis of the grid is
    traced, so each is a lane group of one lane), and a group's rows
    launch per iteration one run's kernels on each of the ``processes``
    that hold some of them (``span``)."""
    import itertools
    scns = [dict(zip(CLI_AXES, combo))
            for combo in itertools.product(*CLI_AXES.values())]
    out = {}
    for g, t0, t1 in windows:
        _add(out, {k: n * (t1 - t0) * processes
                   for k, n in cli_per_iter(scns[g]).items()})
    return out


def _cli(args, tele, dev):
    """Start ``python -m repro_torch.launch.sweep`` on ``dev`` in a fresh
    process, its run manifest (with the kernels' launches) to ``tele``."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.sweep", *args,
         "--device", dev.type, "--telemetry-out", tele], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _cli_wait(procs, label):
    """Every process's stdout and launches; kills them all if one fails
    or hangs."""
    import os
    outs = []
    try:
        for p, tele in procs:
            out, err = p.communicate(timeout=CLI_TIMEOUT_S)
            if p.returncode != 0:
                raise AssertionError(f"{label}: the CLI exited "
                                     f"{p.returncode}:\n{err[-3000:]}")
            with open(os.path.join(tele, "manifest.json")) as f:
                outs.append((out, json.load(f)["kernel_launch_counts"]))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _final_lines(out: str) -> list:
    return [ln for ln in out.splitlines() if "final_return" in ln]


def sweep_preempt_resume(dev, fig5, tmp):
    """``fig5_byzpg`` through ``SweepRunner(windows=3)``, preempted after
    5 windows (inside group 1 and T), then resumed from its manifest:
    phase 7's ``Experiment`` result bit for bit and its launches exactly;
    a second resume runs no window and launches nothing. Returns the
    launches."""
    import os
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core.engine import window_slices
    from repro_torch.kernels import dispatch
    from repro_torch.sweep import SweepRunner

    exp_res, exp_counts, exp_secs = fig5
    label, kw, _ = experiment_cells()[0]
    out = os.path.join(tmp, "fig5")
    obs.get_tracer().clear()
    sink = obs.MemorySink()
    torch.cuda.synchronize()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    with obs.telemetry(sink):
        paused = SweepRunner(windows=3, out_dir=out, device=dev,
                             **kw).run(max_windows=5)
        res = SweepRunner.resume(out, device=dev).run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dispatch.launch_counts()
    wins = [(r["group"], r["window"]) for r in sink.records
            if r["stream"] == "sweep.window"]
    if paused is not None or wins[:5] != [(0, 0), (0, 1), (0, 2), (1, 0),
                                          (1, 1)]:
        raise AssertionError(f"{label} sweep: run(max_windows=5) gave "
                             f"{type(paused).__name__} after windows "
                             f"{wins[:5]}")
    if len(wins) != 4 * 3:
        raise AssertionError(f"{label} sweep: {len(wins)} windows ran, "
                             f"expected 12 (none twice)")
    for scn, want in exp_res.items():
        got = res[tuple(scn)]
        for k in ("returns", "samples", "vec", "returns_mean",
                  "returns_ci95"):
            if not np.array_equal(got[k], want[k]):
                raise AssertionError(f"{label} sweep {scn}: {k} differs "
                                     f"from the Experiment's")
        for k in ("final_return_mean", "final_return_ci95"):
            if got[k] != want[k]:
                raise AssertionError(f"{label} sweep {scn}: {k} {got[k]} "
                                     f"!= {want[k]}")
    if counts != exp_counts:
        raise AssertionError(f"{label} sweep: launches {counts}, the "
                             f"Experiment's {exp_counts}")
    commits = sorted(e["dur"] / 1e3 for e in obs.get_tracer().events
                     if e["name"] == "sweep.commit")
    if len(commits) != 12:
        raise AssertionError(f"{len(commits)} window commits, expected 12")
    dispatch.reset_launches()
    with obs.capture("sweep.window") as again:
        SweepRunner.resume(out, device=dev).run()
    torch.cuda.synchronize()
    if again.records or any(dispatch.launch_counts().values()):
        raise AssertionError(f"{label}: resuming the finished sweep ran "
                             f"{len(again.records)} windows, launches "
                             f"{dispatch.launch_counts()}")
    log(f"[sweep] {label}: windows=3, preempted after 5 windows (group 1, "
        f"t={window_slices(FIG_T, 3)[1][1]} of {FIG_T}) and resumed: every scenario's returns, samples, "
        f"vec, curves, final return and CI bit-equal to phase 7's "
        f"Experiment; launches {counts} equal its launches; a second "
        f"resume ran 0 windows and 0 launches")
    log(f"[sweep] {label}: wall {secs:.3f} s (preempted + resumed) against "
        f"the Experiment's {exp_secs:.3f} s; window commit (carry, chunk, "
        f"state) median {_median(commits):.3f} ms, largest "
        f"{commits[-1]:.3f} ms over {len(commits)} commits")
    return counts


def sweep_cli(dev, tmp):
    """The CLI in fresh processes (``cli_grid_args()``): stopped after 4 windows
    and resumed; then two processes on the one card, ``--mode shard``, and
    ``--mode span`` stopped after 2 windows and resumed by one ``local``
    process. Every run's lines and ``summary.json`` equal an in-process
    ``run_grid`` of the grid (not counted), the launches of each part are
    exact, and the processes' launches sum to the grid's. Returns the
    launches of the CLI processes."""
    import os
    import socket
    from repro_torch.core.engine import (ExperimentResult, ScenarioGrid,
                                         run_grid)
    from repro_torch.rl.envs import make_env

    ref = run_grid(make_env(CLI_ENV),
                   ScenarioGrid(seeds=CLI_SEEDS, axes=CLI_AXES), CLI_T,
                   algo="decbyzpg", device=dev, **CLI_BASE)
    want_lines = [f"{name}: final_return={e['final_return_mean']:.3f} +/- "
                  f"{e['final_return_ci95']:.3f}" for name, e in
                  ExperimentResult({}, CLI_AXES, ref).summary().items()]
    want_final = {ExperimentResult.scenario_name(s): r["final_return_mean"]
                  for s, r in ref.items()}
    full = [(g, 0, CLI_T) for g in range(4)]
    totals = {}

    def check(tag, outs, sweep_dir, parts, summed_want=None):
        """The finished processes' lines (the paused ones print none)."""
        done = [text for text, _ in outs if "sweep paused" not in text]
        if not done:
            raise AssertionError(f"{tag}: no process finished the sweep")
        for text in done:
            if _final_lines(text) != want_lines:
                raise AssertionError(f"{tag}: lines {_final_lines(text)}, "
                                     f"the in-process grid's {want_lines}")
        with open(os.path.join(sweep_dir, "summary.json")) as f:
            got = {",".join(f"{k}={v}" for k, v in e["scenario"].items()):
                   e["final_return_mean"] for e in json.load(f)["scenarios"]}
        if got != want_final:
            raise AssertionError(f"{tag}: summary.json {got}, the "
                                 f"in-process grid's {want_final}")
        for (_, launches), want in zip(outs, parts):
            if want is not None:
                _check_launches(tag, launches, want)
        summed = {}
        for _, launches in outs:
            _add(summed, launches)
        _check_launches(f"{tag} (all processes)", summed,
                        summed_want or cli_launches(full))
        _add(totals, summed)

    def launch(args, tag):
        tele = os.path.join(tmp, tag)
        return _cli(args, tele, dev), tele

    d2 = os.path.join(tmp, "cli")
    t0 = time.perf_counter()
    first = _cli_wait([launch([*cli_grid_args(), "--out", d2, "--stop-after", "4"],
                              "t2a")], "CLI stop")
    if "sweep paused" not in first[0][0] or _final_lines(first[0][0]):
        raise AssertionError(f"CLI --stop-after 4: {first[0][0]}")
    second = _cli_wait([launch(["--resume", d2], "t2b")], "CLI resume")
    walls = {"stop + resume": time.perf_counter() - t0}
    # group 0 whole and group 1's first window, then the rest
    w1 = CLI_T // CLI_WINDOWS
    check("CLI stop + resume", first + second, d2,
          [cli_launches([(0, 0, CLI_T), (1, 0, w1)]),
           cli_launches([(1, w1, CLI_T)] + full[2:])])
    log(f"[sweep] CLI in fresh processes, --stop-after 4 then --resume: "
        f"lines equal to the in-process run_grid ({len(want_lines)} "
        f"scenarios), summary.json's final returns bit-equal, launches "
        f"exact per part")

    def two(mode, sweep_dir, extra, tag):
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        flags = [*cli_grid_args(), "--mode", mode, "--processes", "2",
                 "--coordinator", f"localhost:{port}", "--out", sweep_dir,
                 *extra]
        return _cli_wait([launch([*flags, "--process-id", str(i)],
                                 f"{tag}{i}") for i in range(2)],
                         f"{mode} {tag}")

    d3 = os.path.join(tmp, "shard")
    t0 = time.perf_counter()
    shard = two("shard", d3, [], "t3s")
    walls["shard, 2 processes"] = time.perf_counter() - t0
    check("two-process shard", shard, d3, [None, None])
    d4 = os.path.join(tmp, "span")
    t0 = time.perf_counter()
    span = two("span", d4, ["--stop-after", "2"], "t3p")
    if any("sweep paused" not in o or _final_lines(o) for o, _ in span):
        raise AssertionError("span --stop-after 2 did not pause")
    local = _cli_wait([launch(["--resume", d4, "--mode", "local"], "t3l")],
                      "span resume")
    walls["span, 2 processes, + local resume"] = time.perf_counter() - t0
    # under span both processes step group 0's rows for its first two
    # windows, one row each
    rest = cli_launches([(0, 2 * w1, CLI_T)] + full[1:])
    both = cli_launches([(0, 0, 2 * w1)], processes=2)
    _add(both, rest)
    check("two-process span + one-process resume", span + local, d4,
          [None, None, rest], both)
    log(f"[sweep] two processes on the card: shard (both print the lines; "
        f"launches by process {[c for _, c in shard]}), and span stopped "
        f"after 2 windows then resumed by one local process (launches by "
        f"process {[c for _, c in span + local]}): the same lines and "
        f"summary, launches summing to the grid's (the span windows' on "
        f"each process)")
    log(f"[sweep] CLI walls (s, fresh processes included): "
        + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))
    return totals


def sweep_device_mismatch(dev, tmp):
    """A sweep started on the CPU refuses to resume on ``dev``:
    ``SweepMismatch`` naming ``meta.device``, before any launch."""
    import os
    from repro_torch.kernels import dispatch
    from repro_torch.sweep import SweepMismatch, SweepRunner

    d5 = os.path.join(tmp, "cpu")
    SweepRunner(algo="byzpg", env="cartpole(horizon=20)", T=2, seeds=(0,),
                axes={"aggregator": ("mean",)}, windows=2, out_dir=d5,
                device="cpu", K=3, N=4, B=2).run(max_windows=1)
    dispatch.reset_launches()
    try:
        SweepRunner.resume(d5, device=dev).run()
    except SweepMismatch as e:
        if f"meta.device: 'cpu' != '{dev.type}'" not in str(e):
            raise AssertionError(f"the mismatch names {e}") from e
    else:
        raise AssertionError(f"a CPU sweep resumed on {dev}")
    if any(dispatch.launch_counts().values()):
        raise AssertionError("the refused resume launched kernels")
    log(f"[sweep] a sweep started on the CPU refuses to resume on {dev}: "
        f"SweepMismatch names meta.device ('cpu' != '{dev.type}')")


def phase_sweep(dev, fig5):
    """The sweep service on the card (``repro_torch.sweep``), phase 7b:
    :func:`sweep_preempt_resume`, :func:`sweep_cli`,
    :func:`sweep_device_mismatch`. Returns the launches per kernel of the
    sweeps' runs."""
    import tempfile
    totals = {}
    with tempfile.TemporaryDirectory() as tmp:
        _add(totals, sweep_preempt_resume(dev, fig5, tmp))
        _add(totals, sweep_cli(dev, tmp))
        sweep_device_mismatch(dev, tmp)
    log(f"[sweep] launches in the phase {totals}")
    return totals


#: phase 7c (lane batching): the paper's Fig. 3 ladder at its full width,
#: examples_torch/attack_strength_sweep.py's defaults: DecByzPG on
#: CartPole (horizon 200), K=13, n_byz=3, N=20, B=4, eta 2e-2, MLP (16, 16)
#: relu (d = 386), large_noise over five sigmas × {bucketed RFA with MDA
#: κ=5, the mean with κ=0}, 3 seeds: two lane groups of 15 rows
LANE_ENV = "cartpole(horizon=200)"
LANE_SIGMAS = (1.0, 10.0, 50.0, 100.0, 200.0)
LANE_AXES = {"attack": tuple(f"large_noise(sigma={s})" for s in LANE_SIGMAS),
             "aggregator": ("rfa", "mean")}
LANE_BASE = dict(K=13, n_byz=3, N=20, B=4, eta=2e-2)
LANE_T, LANE_SEEDS = 3, (0, 1, 2)
#: the rfa(nu=...) sweep of phase 7c: one group, T and seeds
LANE_NUS = (1e-6, 1e-3, 1e-1)
LANE_NU_T = 2
#: the reference's lane tolerances: returns, the diameter, θ (samples exact)
LANE_TOL = {"returns": 1e-5, "diameter": 1e-3, "theta": 1e-5}


def _lane_override(c):
    import dataclasses
    return dataclasses.replace(c, kappa=0 if c.aggregator.name == "mean"
                               else 5)


def lane_per_iter(cfg) -> dict:
    """Launches per iteration of one run of a Fig. 3 config (a lane group
    launches the same for all its rows): bucketed RFA's gram, weiszfeld
    and wsum for all receivers at once, κ MDA grams, Δ₂'s gram; the mean
    and κ = 0 only Δ₂'s gram."""
    if cfg.aggregator.name == "mean":
        return {"gram": 1 + cfg.kappa}
    return {"gram": 2 + cfg.kappa, "weiszfeld": 1, "wsum": 1}


def _lane_groups(axes, base, seeds):
    from repro_torch.core.engine import (ScenarioGrid, grid_scenarios,
                                         lane_groups)
    _, scenarios = grid_scenarios(ScenarioGrid(seeds=seeds, axes=axes),
                                  override=_lane_override, base=base)
    return lane_groups(scenarios)


def _lane_launches(groups, T: int, rows_run: bool) -> dict:
    """What a grid launches: each group's one-run launches per iteration
    × T, or with ``rows_run`` (lanes=False) × its lanes × seeds as
    well."""
    want = {}
    for (static_cfg, _), members in groups.items():
        for _, cfg, _ in members if rows_run else members[:1]:
            n = len(LANE_SEEDS) if rows_run else 1
            _add(want, {k: v * T * n for k, v in lane_per_iter(cfg).items()})
    return want


def _row_gaps(lanes, per) -> dict:
    """The largest gap of each history between two results of one grid,
    and how many rows are bit-equal in all of them."""
    import numpy as np
    gaps = {k: 0.0 for k in ("returns", "samples", "diameter", "theta")}
    equal = rows = 0
    for scn, want in per.items():
        got = lanes[tuple(scn)]
        for i in range(want["returns"].shape[0]):
            rows += 1
            same = True
            for k in gaps:
                a = np.asarray(got[k][i], np.float64)
                b = np.asarray(want[k][i], np.float64)
                gaps[k] = max(gaps[k], float(np.abs(a - b).max()))
                same &= bool(np.array_equal(got[k][i], want[k][i]))
            equal += same
    return {"gaps": gaps, "equal": equal, "rows": rows}


def phase_lanes(dev):
    """Phase 7c, lane batching at full width (``LANE_*``): the Fig. 3
    grid through ``run_grid`` with ``lanes=True`` (two groups of 15 rows)
    and ``lanes=False`` (30 scenarios' seeds one at a time), each with
    exact launches from the group structure (a group launches per
    iteration one run's kernels), every row's returns, samples, Δ₂ and θ
    held to the reference's lane tolerances (largest gaps and bit-equal
    rows printed) and both walls; the lane run's own ``gram``,
    ``weiszfeld`` and ``wsum`` launches held against their plain versions
    on their inputs; an ``rfa(nu=...)`` sweep as one group, its per-row
    ``nu`` weiszfeld bit-equal to the plain version; and the grid through
    ``SweepRunner(windows=3)``, preempted and resumed, bit-equal to the
    lane run with its launches. Returns the phase's launches."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core.engine import ScenarioGrid, run_grid
    from repro_torch.kernels import dispatch
    from repro_torch.rl.envs import make_env
    from repro_torch.sweep import SweepRunner

    t_all = time.perf_counter()
    env = make_env(LANE_ENV)
    grid = ScenarioGrid(seeds=LANE_SEEDS, axes=LANE_AXES)
    groups = _lane_groups(LANE_AXES, LANE_BASE, LANE_SEEDS)
    if [len(m) * len(LANE_SEEDS) for m in groups.values()] != [15, 15]:
        raise AssertionError(f"phase 7c: groups of "
                             f"{[len(m) for m in groups.values()]} lanes, "
                             f"expected two of 5")
    totals, walls, results = {}, {}, {}
    paths = _PathInputs()
    for lanes in (True, False):
        torch.cuda.synchronize()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        with paths if lanes else contextlib.nullcontext():
            res = run_grid(env, grid, LANE_T, algo="decbyzpg",
                           override=_lane_override, lanes=lanes, device=dev,
                           **LANE_BASE)
        torch.cuda.synchronize()
        walls[lanes] = time.perf_counter() - t0
        counts = dispatch.launch_counts()
        want = _lane_launches(groups, LANE_T, rows_run=not lanes)
        _check_launches(f"phase 7c lanes={lanes}", counts, want)
        _add(totals, counts)
        results[lanes] = (res, counts)
        for scn, out in res.items():
            if not (np.isfinite(out["returns"]).all()
                    and np.isfinite(out["theta"]).all()):
                raise AssertionError(f"phase 7c lanes={lanes} {scn}: "
                                     f"non-finite output")
    paths.check("phase 7c Fig. 3 lanes")
    lane_res, lane_counts = results[True]
    per_res, per_counts = results[False]
    cmp = _row_gaps(lane_res, per_res)
    log(f"[lanes] {card()}: every row against lanes=False: largest gaps "
        + ", ".join(f"{k} {v:.3e}" for k, v in cmp["gaps"].items())
        + f"; {cmp['equal']} of {cmp['rows']} rows bit-equal in all four")
    for k, tol in LANE_TOL.items():
        if not cmp["gaps"][k] <= tol:
            raise AssertionError(f"phase 7c: {k} of the lane route "
                                 f"{cmp['gaps'][k]} from lanes=False, "
                                 f"tolerance {tol}")
    if cmp["gaps"]["samples"] != 0:
        raise AssertionError("phase 7c: samples differ between the routes")
    for (static_cfg, names), members in groups.items():
        log(f"[lanes] {card()}: group {static_cfg.aggregator.canonical()} "
            f"(kappa={members[0][1].kappa}): {len(members)} lanes x "
            f"{len(LANE_SEEDS)} seeds = {len(members) * len(LANE_SEEDS)} "
            f"rows, traced {list(names)}; launches per iteration "
            f"{lane_per_iter(members[0][1])}, one run's")
    log(f"[lanes] {card()}: Fig. 3 grid, K=13, d=386, T={LANE_T}: "
        f"lanes=True wall {walls[True]:.3f} s, launches {lane_counts}; "
        f"lanes=False wall {walls[False]:.3f} s, launches {per_counts}; "
        f"ratio {walls[False] / walls[True]:.3f}")

    # an rfa(nu=...) sweep: one group whose rows carry three nu values
    nu_axes = {"aggregator": tuple(f"rfa(nu={v})" for v in LANE_NUS)}
    nu_base = dict(LANE_BASE, attack="large_noise(sigma=10)")
    nu_groups = _lane_groups(nu_axes, nu_base, LANE_SEEDS)
    if len(nu_groups) != 1:
        raise AssertionError(f"phase 7c: the nu sweep is {len(nu_groups)} "
                             f"groups, expected 1")
    torch.cuda.synchronize()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    with paths:
        nu_res = run_grid(env, ScenarioGrid(seeds=LANE_SEEDS, axes=nu_axes),
                          LANE_NU_T, algo="decbyzpg",
                          override=_lane_override, device=dev, **nu_base)
    torch.cuda.synchronize()
    nu_secs = time.perf_counter() - t0
    nu_counts = dispatch.launch_counts()
    _check_launches("phase 7c nu sweep", nu_counts,
                    _lane_launches(nu_groups, LANE_NU_T, rows_run=False))
    _add(totals, nu_counts)
    per_row = [k for k in paths.seen if k[0] == "weiszfeld"
               and k[1][1] == (len(LANE_NUS) * len(LANE_SEEDS)
                               * LANE_BASE["K"],)]
    if not per_row:
        raise AssertionError(f"phase 7c: no per-row nu weiszfeld launch "
                             f"among {list(paths.seen)}")
    paths.check("phase 7c rfa(nu) sweep")
    log(f"[lanes] {card()}: rfa(nu in {list(LANE_NUS)}) x "
        f"{len(LANE_SEEDS)} seeds as one group of "
        f"{len(LANE_NUS) * len(LANE_SEEDS)} rows, T={LANE_NU_T}: launches "
        f"{nu_counts}, one run's per iteration; wall {nu_secs:.3f} s; the "
        f"per-row nu weiszfeld bit-equal to its plain version; final "
        f"returns {[round(r['final_return_mean'], 3) for r in nu_res.values()]}")

    # the grid as a sweep: preempted inside group 1, resumed
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(algo="decbyzpg", env=LANE_ENV, T=LANE_T, seeds=LANE_SEEDS,
                  axes=LANE_AXES, override=_lane_override, windows=3,
                  out_dir=tmp, device=dev, **LANE_BASE)
        torch.cuda.synchronize()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        paused = SweepRunner(**kw).run(max_windows=4)
        swept = SweepRunner.resume(tmp, override=_lane_override,
                                   device=dev).run()
        torch.cuda.synchronize()
        sweep_secs = time.perf_counter() - t0
        sweep_counts = dispatch.launch_counts()
    if paused is not None:
        raise AssertionError("phase 7c: the sweep finished in 4 windows")
    if sweep_counts != lane_counts:
        raise AssertionError(f"phase 7c sweep: launches {sweep_counts}, the "
                             f"lane run's {lane_counts}")
    _add(totals, sweep_counts)
    for scn, want in lane_res.items():
        got = swept[tuple(scn)]
        for k in ("returns", "samples", "diameter", "theta",
                  "returns_mean", "returns_ci95"):
            if not np.array_equal(got[k], want[k]):
                raise AssertionError(f"phase 7c sweep {scn}: {k} differs "
                                     f"from the lane run")
    log(f"[lanes] {card()}: the grid through SweepRunner(windows=3), "
        f"preempted after 4 windows (inside group 1) and resumed: every "
        f"row bit-equal to the lane run, launches {sweep_counts} equal its "
        f"launches; wall {sweep_secs:.3f} s")
    log(f"[time] phase 7c lanes {time.perf_counter() - t_all:.1f} s")
    return totals


def phase_telemetry(dev):
    """``telemetry=True`` on the card at T=4 under an ``obs.MemorySink``:
    returns, coins, diameter and θ bit-identical to the run without it
    (the same seed, so the same draws), one tap per iteration, and the
    launches of the telemetry run counted: the run's own row plus the
    rejection mask's kernels (Krum's scores: one gram, one krum_score).
    Returns the launches per kernel of the telemetry runs."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core.byzpg import run_byzpg
    from repro_torch.core.decbyzpg import run_decbyzpg
    from repro_torch.kernels import dispatch

    T = 4
    runs = byzpg_runs()[:2] + main_runs()[:1]
    totals = {}
    for label, env, _, cfg, per_iter in runs:
        algo = "decbyzpg" if label == "cartpole" else "byzpg"
        run = run_decbyzpg if algo == "decbyzpg" else run_byzpg
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        off = run(env, cfg, T, device=dev)
        torch.cuda.synchronize()
        t_off = time.perf_counter() - t0
        sink = obs.MemorySink()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        with obs.telemetry(sink):
            on = run(env, dataclasses.replace(cfg, telemetry=True), T,
                     device=dev)
        torch.cuda.synchronize()
        t_on = time.perf_counter() - t0
        counts = dispatch.launch_counts()
        extra = {"gram": 1, "krum_score": 1} \
            if cfg.aggregator.name == "krum" else {}
        want = {k: (per_iter.get(k, 0) + extra.get(k, 0)) * T
                for k in set(per_iter) | set(extra)}
        _check_launches(f"{label} telemetry", counts, want)
        _add(totals, counts)
        carry = "theta" if algo == "decbyzpg" else "vec"
        keys = ["returns", "coins"] + (["diameter"] if algo == "decbyzpg"
                                       else [])
        for k in keys:
            if not np.array_equal(on[k], off[k]):
                raise AssertionError(f"{label}: telemetry changed {k}")
        if not torch.equal(on[carry], off[carry]):
            raise AssertionError(f"{label}: telemetry changed {carry}")
        taps = [r for r in sink.records if r["stream"] == algo]
        if [int(r["t"]) for r in taps] != list(range(T)) or \
                on["rejected"].shape != (T, cfg.K):
            raise AssertionError(f"{label}: {len(taps)} taps for T={T}")
        log(f"[telemetry] {label} ({algo}): {', '.join(keys)} and {carry} "
            f"bit-identical to the run without telemetry; {len(taps)} taps; "
            f"grad_norm={np.round(on['grad_norm'], 4).tolist()}; "
            f"aggregator_confusion={on['aggregator_confusion']}; launches "
            f"{ {k: v for k, v in counts.items() if v} }; ms/iter "
            f"{t_off / T * 1e3:.3f} off, {t_on / T * 1e3:.3f} on")
    return totals


def phase_byzpg_cpu_agreement(dev):
    """Small ByzPG runs on the card against the same runs on the CPU
    (plain versions), fed the same draws and θ₀: bucketed RFA, Krum and
    the trimmed mean at K=13, n_byz=3."""
    import numpy as np
    import torch
    from repro_torch.core.byzpg import ByzPGConfig, run_byzpg
    from repro_torch.core.noise import draw_byzpg_noise
    from repro_torch.rl.envs import make_cartpole
    from repro_torch.rl.policy import resolve_policy

    env = make_cartpole(horizon=32)
    small = dict(K=13, n_byz=3, attack="large_noise(sigma=10)", N=8, B=2)
    T = 3
    for label in ("rfa", "krum", "trimmed_mean"):
        cfg = ByzPGConfig(**small, aggregator=label)
        policy = resolve_policy(cfg, env)
        gen = torch.Generator()
        gen.manual_seed(1)
        theta0 = policy.init_theta(gen)
        noise = [draw_byzpg_noise(gen, cfg, env, policy.d, t)
                 for t in range(T)]
        on_card = [type(nz)(*(None if x is None else x.to(dev) for x in nz))
                   for nz in noise]
        cpu = run_byzpg(env, cfg, T, device="cpu", theta0=theta0,
                        noise=noise)
        gpu = run_byzpg(env, cfg, T, device=dev, theta0=theta0.to(dev),
                        noise=on_card)
        if not np.array_equal(cpu["coins"], gpu["coins"]):
            raise AssertionError(f"byzpg {label}: card/CPU coins differ")
        np.testing.assert_allclose(gpu["returns"], cpu["returns"], rtol=1e-5)
        th_err = (gpu["vec"].cpu() - cpu["vec"]).abs().max().item()
        if not th_err <= 1e-4:
            raise AssertionError(f"byzpg {label}: card/CPU theta differ by "
                                 f"{th_err} > 1e-4")
        log(f"[check] card vs CPU plain path, byzpg {label} (K=13, n_byz=3, "
            f"T={T}, coins {cpu['coins'].astype(int).tolist()}): coins "
            f"equal, returns within rtol 1e-5, theta max abs err "
            f"{th_err:.3e} (tol 1e-4)")


#: the default transformer policy (reduced Qwen2.5-3B: d_model 256, 2
#: layers, 4 heads over 2 KV heads, hd 64, d_ff 512, vocab 512), the
#: parameter count of each agent's row of θ, and the reference's tiny one
TF_POLICY = "transformer(arch='qwen2.5-3b')"
TF_D = 1378560
#: phase 6b's CartPole horizon: the paper's 200 cut to keep the phase near
#: half a minute (the CPU tests hold the policy's runs at horizon 10)
TF_HORIZON = 25
TINY_TF = ("transformer(arch='qwen2.5-3b', d_model=32, n_layers=1, "
           "n_heads=2, d_ff=64)")


def transformer_runs():
    """(label, algo, T, config, aggregation launches per iteration) of
    phase 6b: :data:`TF_POLICY` on ``cartpole(horizon=TF_HORIZON)``, K=13,
    n_byz=3 ``large_noise(sigma=10)``, N=20, B=4. ``per_receiver`` stays
    off: its agreement draws would be K = 13 times the (κ, K, d) = 430 MB
    a step already drawn. The policy's passes take the chunked route, so no run
    launches flash attention."""
    from repro_torch.core.byzpg import ByzPGConfig
    from repro_torch.core.decbyzpg import DecByzPGConfig
    kw = dict(K=13, n_byz=3, attack="large_noise(sigma=10)", N=20, B=4,
              policy=TF_POLICY)
    return [
        ("tf_decbyzpg_rfa_mda", "decbyzpg", 3, DecByzPGConfig(**kw),
         {"gram": 8, "weiszfeld": 1, "wsum": 1}),
        ("tf_decbyzpg_krum_cwtm", "decbyzpg", 2,
         DecByzPGConfig(**kw, aggregator="krum", agreement="cwtm"),
         {"gram": 2, "krum_score": 1, "gossip_reduce": 6}),
        ("tf_byzpg_trimmed_mean", "byzpg", 3,
         ByzPGConfig(**kw, aggregator="trimmed_mean"), {"trimmed_mean": 1}),
    ]


class _Ranges:
    """Per-range host ms (synchronised at both ends) of the runs made
    while active: it stands in for ``record_function`` in the two
    algorithms' modules. Synchronising changes no value."""

    def __init__(self):
        self.ms = {}

    def __enter__(self):
        import contextlib
        import torch
        from repro_torch.core import byzpg, decbyzpg
        self.mods = (byzpg, decbyzpg)
        self.orig = [m.record_function for m in self.mods]

        @contextlib.contextmanager
        def timed(name):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            key = name.split(".", 1)[1]
            self.ms[key] = self.ms.get(key, 0.0) + \
                (time.perf_counter() - t0) * 1e3

        for m in self.mods:
            m.record_function = timed
        return self

    def __exit__(self, *exc):
        for m, f in zip(self.mods, self.orig):
            m.record_function = f


def _path_tol(name: str, args, ref) -> float:
    """The tolerance of each kernel against its plain version, as the
    kernel phases state it: 2e-5·max|G| (gram), 0 (weiszfeld, whose plain
    version is the kernel's order of operations), 1e-5·max|x| (wsum),
    P·eps·max of the input (the cw reduces; K·eps·max|score| for Krum),
    2e-5·max|v| (flash)."""
    if name == "gram":
        return 2e-5 * ref.abs().max().item()
    if name == "weiszfeld":
        return 0.0
    if name == "wsum":
        return 1e-5 * args[0].abs().max().item()
    if name == "krum_score":
        return args[0].shape[-1] * F32_EPS * ref.abs().max().item()
    if name == "trimmed_mean":
        return args[0].shape[1] * F32_EPS * args[0].abs().max().item()
    if name == "gossip_reduce":
        return args[1].shape[1] * F32_EPS * args[0].abs().max().item()
    if name == "neighbor_reduce":
        return args[0].shape[1] * F32_EPS * args[0].abs().max().item()
    if name == "flash_attention":
        return 2e-5 * args[2].abs().max().item()
    raise KeyError(name)


class _PathInputs:
    """While active, keeps the first input of each distinct shape that
    each kernel's launch receives, with its result (clones of both), so
    that :meth:`check` can hold every result against the kernel's plain
    version on the same inputs: the path's own shapes, whatever the kernel
    phases chose. The launch counts are untouched (the recorder sits
    inside the launch the kernel counts). ``host=True`` keeps the copies
    (inputs and results) in host memory, off the card: the federated
    runs' stacks, and the aggregate peaks that phase 10c (b) holds to
    its shard."""

    def __init__(self, host: bool = False):
        self.host = host

    def __enter__(self):
        from repro_torch.kernels import dispatch
        self.kernels = dispatch.kernels()
        self.orig = {n: k._launch for n, k in self.kernels.items()}
        self.seen = {}
        for name, k in self.kernels.items():
            k._launch = self._wrap(name, k._launch)
        return self

    def _wrap(self, name, launch):
        def shape(a):
            return tuple(a.shape) if hasattr(a, "shape") else a

        def clone(a):
            if not hasattr(a, "clone"):
                return a
            return a.to("cpu", copy=True) if self.host else a.clone()

        def recorded(*args, **kwargs):
            out = launch(*args, **kwargs)
            key = (name, tuple(map(shape, args)),
                   tuple(sorted((k, shape(v)) for k, v in kwargs.items())))
            if key not in self.seen:
                self.seen[key] = ([clone(a) for a in args],
                                  {k: clone(v) for k, v in kwargs.items()},
                                  clone(out))
            return out
        return recorded

    def __exit__(self, *exc):
        for name, k in self.kernels.items():
            k._launch = self.orig[name]

    def check(self, label: str) -> None:
        """Every recorded launch against its plain version on the card
        (host copies moved back); raises on the first disagreement and
        logs one line per kernel and shape."""
        def back(a):
            return a.to("cuda") if self.host and hasattr(a, "to") else a

        for (name, shapes, kw), rec in self.seen.items():
            args, out = [back(a) for a in rec[0]], back(rec[2])
            kwargs = {k: back(v) for k, v in rec[1].items()}
            ref = self.kernels[name].plain(*args, **kwargs)
            err = (out - ref).abs().max().item()
            tol = _path_tol(name, args, ref)
            if not err <= tol:
                raise AssertionError(f"{label}: {name} at the path's input "
                                     f"{shapes} {kw}: max abs err {err} > "
                                     f"{tol} against the plain version")
            log(f"[path] {label}: {name} {shapes}{' ' + str(kw) if kw else ''}"
                f" against the plain version on the path's own input: max "
                f"abs err {err:.3e} (tol {tol:.3e})")
        self.seen = {}


def phase_transformer_policy(dev):
    """The transformer policy trained on the card (:func:`transformer_runs`):
    each run's returns, θ and Δ₂ finite, its launches per iteration equal
    to its row (the policy's passes take the chunked route: no flash
    launch), and a repeat with the same seed bit-equal, run under
    :class:`_Ranges` and :class:`_PathInputs` (the aggregation kernels
    at d = :data:`TF_D` against their plain versions on their own
    inputs). Then the tiny policy on the card against the CPU, and the
    first run's honest mean θ served through ``policy_params(theta=)``
    (flash once per layer and request, each launch against the plain
    version on its own input). Returns the launches per kernel of the
    three runs and the served requests."""
    import numpy as np
    import torch
    from repro_torch.core.byzpg import run_byzpg
    from repro_torch.core.decbyzpg import run_decbyzpg
    from repro_torch.kernels import dispatch
    from repro_torch.rl.envs import make_cartpole
    from repro_torch.rl.policy import resolve_policy
    from repro_torch.serving import make_traffic, serve

    env = make_cartpole(horizon=TF_HORIZON)
    totals, served_theta = {}, None
    for label, algo, T, cfg, per_iter in transformer_runs():
        run = run_decbyzpg if algo == "decbyzpg" else run_byzpg
        policy = resolve_policy(cfg, env)
        if policy.d != TF_D:
            raise AssertionError(f"{label}: d {policy.d}, expected {TF_D}")
        run(env, cfg, 1, device=dev)                     # warm iteration
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launches()
        t0 = time.perf_counter()
        out = run(env, cfg, T, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = dispatch.launch_counts()
        _check_launches(label, counts,
                        {k: n * T for k, n in per_iter.items()})
        _add(totals, counts)
        carry = "theta" if algo == "decbyzpg" else "vec"
        finite = np.isfinite(out["returns"]).all() and bool(
            torch.isfinite(out[carry]).all())
        if algo == "decbyzpg":
            finite = finite and np.isfinite(out["diameter"]).all()
        if not finite or out[carry].shape[-1] != TF_D:
            raise AssertionError(f"{label}: non-finite outputs or wrong d")
        with _Ranges() as ranges, _PathInputs() as path:
            again = run(env, cfg, T, device=dev)
        if not (torch.equal(again[carry], out[carry])
                and np.array_equal(again["returns"], out["returns"])):
            raise AssertionError(f"{label}: a repeat is not bit-equal")
        path.check(label)
        if algo == "decbyzpg" and served_theta is None:
            served_theta = out["theta"][cfg.n_byz:].mean(0)
        per_range = {k: round(v / T, 3) for k, v in ranges.ms.items()}
        extra = (f" diameter={out['diameter'].tolist()}"
                 if algo == "decbyzpg" else "")
        log(f"[tf] {card()}: {label}: d={TF_D} T={T} "
            f"ms/iter={secs / T * 1e3:.3f} "
            f"(synchronised ranges, ms/iter: {per_range}) launches/iter="
            f"{per_iter} peak memory {peak} bytes "
            f"returns={out['returns'].tolist()}{extra} "
            f"coins={out['coins'].astype(int).tolist()}; a repeat is "
            f"bit-equal")
        del out, again
        torch.cuda.empty_cache()
    phase_tiny_transformer_cpu_agreement(dev)
    torch.cuda.synchronize()
    dispatch.reset_launches()
    n = 4
    with _PathInputs() as path:
        report = serve(TF_POLICY, f"cartpole(horizon={TF_HORIZON})",
                       theta=served_theta, n_requests=n, realtime=False,
                       warmup=False, device=dev)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    path.check("tf serve")
    L = resolve_policy(transformer_runs()[0][3], env).model_cfg.n_layers
    _check_launches("tf serve", counts, {"flash_attention": L * n})
    _check_served("tf serve", report, make_traffic(
        n, seed=0, rate_rps=50.0, max_new=16, obs_dim=env.obs_dim),
        env.n_actions)
    _add(totals, counts)
    log(f"[tf] the DecByzPG run's honest mean θ served through "
        f"policy_params(theta=): {report.summary()} first streams "
        f"{[r.tokens[:8] for r in report.results[:2]]} flash launches "
        f"{counts['flash_attention']}")
    return totals


def phase_tiny_transformer_cpu_agreement(dev):
    """The reference's tiny transformer policy (K=3, n_byz=1
    ``large_noise(sigma=10)``, RFA, GDA κ=1, N=3, B=2,
    ``cartpole(horizon=10)``, T=2) on the card against the same run on
    the CPU, fed the same draws and θ₀, for both algorithms: coins equal,
    returns within rtol 1e-5, θ within 1e-4 (f32 sums in other orders on
    the two devices)."""
    import numpy as np
    import torch
    from repro_torch.core.byzpg import ByzPGConfig, run_byzpg
    from repro_torch.core.decbyzpg import DecByzPGConfig, run_decbyzpg
    from repro_torch.core.noise import draw_byzpg_noise, draw_step_noise
    from repro_torch.rl.envs import make_cartpole
    from repro_torch.rl.policy import resolve_policy

    env = make_cartpole(horizon=10)
    kw = dict(K=3, n_byz=1, attack="large_noise(sigma=10)",
              aggregator="rfa", N=3, B=2, policy=TINY_TF)
    T = 2
    for algo, cfg, run, draw, carry in [
            ("decbyzpg", DecByzPGConfig(**kw, agreement="gda", kappa=1),
             run_decbyzpg, draw_step_noise, "theta"),
            ("byzpg", ByzPGConfig(**kw), run_byzpg, draw_byzpg_noise,
             "vec")]:
        policy = resolve_policy(cfg, env)
        gen = torch.Generator()
        gen.manual_seed(1)
        theta0 = policy.init_theta(gen)
        noise = [draw(gen, cfg, env, policy.d, t) for t in range(T)]
        on_card = [type(nz)(*(None if x is None else x.to(dev) for x in nz))
                   for nz in noise]
        cpu = run(env, cfg, T, device="cpu", theta0=theta0, noise=noise)
        gpu = run(env, cfg, T, device=dev, theta0=theta0.to(dev),
                  noise=on_card)
        if not np.array_equal(cpu["coins"], gpu["coins"]):
            raise AssertionError(f"tiny transformer {algo}: card/CPU coins "
                                 f"differ")
        np.testing.assert_allclose(gpu["returns"], cpu["returns"], rtol=1e-5)
        err = (gpu[carry].cpu() - cpu[carry]).abs().max().item()
        if not err <= 1e-4:
            raise AssertionError(f"tiny transformer {algo}: card/CPU theta "
                                 f"differ by {err} > 1e-4")
        log(f"[check] card vs CPU plain path, tiny transformer {algo} "
            f"(d={policy.d}, K=3, T={T}): coins equal, returns within rtol "
            f"1e-5, theta max abs err {err:.3e} (tol 1e-4)")


def phase_checkpoint(dev, byzpg_out):
    """``byzpg_cartpole``'s policy parameters saved and restored onto the
    card bit for bit, then one request served by ``serve()`` through
    ``policy_params(checkpoint=)``: the same tokens as serving the same
    parameters directly, and flash attention once per layer per prefill.
    Returns the launches per kernel of the served request."""
    import os
    import tempfile
    import torch
    from repro_torch import checkpoint
    from repro_torch.core.registry import resolve
    from repro_torch.core.tree import tree_paths
    from repro_torch.kernels import dispatch
    from repro_torch.serving import (default_buckets, make_traffic,
                                     policy_params, serve)

    params = byzpg_out["params"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "byzpg_cartpole.npz")
        checkpoint.save(params, path)
        back = checkpoint.restore(params, path, device=dev)
        pairs = list(zip(tree_paths(params), tree_paths(back)))
        if not all(ka == kb and b.device.type == dev.type
                   and torch.equal(a, b)
                   for (ka, a), (kb, b) in pairs):
            raise AssertionError("byzpg_cartpole params: the restored "
                                 "archive differs")
        spec = "transformer(arch='llama3.2-1b', n_layers=2, d_model=64, " \
            "n_heads=2)"
        env = resolve("env", "cartpole(horizon=32)")
        pol = resolve("policy", spec, env=env)
        direct = policy_params(pol, key=0, device=dev)
        ppath = os.path.join(tmp, "policy.npz")
        checkpoint.save(direct, ppath)
        kw = dict(n_requests=1, slots=4, max_new=16, realtime=False,
                  device=dev)
        want = serve(spec, env, params=direct, **kw).results[0].tokens
        torch.cuda.synchronize()
        dispatch.reset_launches()
        report = serve(spec, env, checkpoint=ppath, **kw)
        torch.cuda.synchronize()
        counts = dispatch.launch_counts()
    flash = pol.model_cfg.n_layers * (len(default_buckets(8)) + 1)
    _check_launches("checkpoint serve", counts, {"flash_attention": flash})
    _check_served("checkpoint serve", report, make_traffic(
        1, seed=0, rate_rps=50.0, max_new=16, obs_dim=env.obs_dim),
        env.n_actions)
    got = report.results[0].tokens
    if got != want:
        raise AssertionError(f"served from the checkpoint {got}, directly "
                             f"{want}")
    log(f"[checkpoint] byzpg_cartpole params ({len(pairs)} arrays) restored "
        f"onto {dev} bit for bit; one request served through "
        f"policy_params(checkpoint=): tokens {got} equal to serving the "
        f"parameters directly, flash launches {counts['flash_attention']}")
    return counts


def serving_runs():
    """(label, model config, engine kwargs, requests, prompt lengths,
    flash launches) of phase 5; the config is None for the run through
    ``serve()`` with its defaults (the transformer policy on
    ``cartpole(horizon=32)``, 16 new tokens, prompts of 8 at most). The
    MoE and MLA families at full width: Grok-1 cut to 1 layer (its 8
    experts of 6144 x 32768 are 19.3 GB a layer in f32, and
    ``init_params`` holds the blocks twice while it stacks them),
    DeepSeek-V2-Lite to 4 and MiniCPM3-4B whole; each launches flash
    once per layer per prefill, as Grok-1's GQA does: DeepSeek-V2-Lite's
    MLA at q/k 192, v 128 (the kernel's hd-192 instance), MiniCPM3-4B's
    at 96/64 (the hd-128 instance, v 64). The
    recurrent families at full width and depth, prefilled at exact
    prompt lengths (one warmup prefill of 1 token): Hymba-1.5B launches
    flash once per layer per prefill (25 heads over 5, G = 5), xLSTM-350M
    none."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.serving import default_buckets
    qwen_4l = dataclasses.replace(get_config("qwen2.5-3b"), n_layers=4)
    moe_kw = dict(slots=4, max_prompt=256, max_new=16)
    moe_lens = (1, 16, 128, 256)
    return [
        ("llama3.2-1b_serve", get_config("llama3.2-1b"),
         dict(slots=8, max_prompt=512, max_new=32), 24, (1, 16, 128, 512),
         16 * (len(default_buckets(512)) + 24)),
        ("qwen2.5-3b_4l_serve", qwen_4l,
         dict(slots=4, max_prompt=256, max_new=16), 8, (1, 16, 128, 256),
         4 * (len(default_buckets(256)) + 8)),
        ("policy_serve", None, dict(slots=4, max_new=16), 16, None,
         2 * (len(default_buckets(8)) + 16)),
        ("grok-1_1l_serve",
         dataclasses.replace(get_config("grok-1-314b"), n_layers=1),
         moe_kw, 8, moe_lens, 1 * (len(default_buckets(256)) + 8)),
        ("deepseek-v2-lite_4l_serve",
         dataclasses.replace(get_config("deepseek-v2-lite-16b"), n_layers=4),
         moe_kw, 8, moe_lens, 4 * (len(default_buckets(256)) + 8)),
        ("minicpm3-4b_serve", get_config("minicpm3-4b"), moe_kw, 8,
         moe_lens, 62 * (len(default_buckets(256)) + 8)),
        ("hymba-1.5b_serve", get_config("hymba-1.5b"), moe_kw, 8, moe_lens,
         32 * (1 + 8)),
        ("xlstm-350m_serve", get_config("xlstm-350m"), moe_kw, 8, moe_lens,
         0),
    ]


def tick_read_bound(cfg):
    """(expert bytes, all bytes) that one decode tick must read at least
    once: every expert weight of every layer (the batched expert products
    read all E of them whatever the routing), and every block weight plus
    the LM head. Over the card's memory rate, the tick's floor."""
    import math
    from repro_torch.models.model import param_shapes

    def count(tree):
        return sum(map(count, tree.values())) if isinstance(tree, dict) \
            else math.prod(tree)

    shapes = param_shapes(cfg)
    experts = sum(count(shapes["blocks"]["mlp"][k])
                  for k in ("w_gate", "w_up", "w_down")) \
        if cfg.moe is not None else 0
    head = shapes.get("lm_head", shapes["embed"])
    return 4 * experts, 4 * (count(shapes["blocks"]) + count(head))


def state_bytes(cache) -> int:
    """Bytes of a slot cache's recurrent states (every block leaf outside
    the attention ring): a tick reads and writes each of them once."""
    from repro_torch.core.tree import tree_paths
    return sum(t.numel() * t.element_size()
               for path, t in tree_paths(cache["blocks"])
               if not path.startswith("kv/"))


def _bit_repeat(cfg, params, dev):
    """One 256-token prefill twice on the card: the logits and every cache
    leaf, recurrent states included, must be bit-equal (the MoE combine
    gathers, the scans loop in a fixed order; no atomics)."""
    import torch
    from repro_torch.core.tree import tree_paths
    from repro_torch.models.model import prefill
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen,
                         device=dev)
    runs = [prefill(cfg, params, toks, cache_len=272, last_only=False)
            for _ in range(2)]
    same = torch.equal(runs[0][0], runs[1][0]) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(tree_paths(runs[0][1]),
                                                    tree_paths(runs[1][1])))
    if not same:
        raise AssertionError(f"{cfg.name}: a repeated prefill is not "
                             f"bit-equal")
    return runs[0][0].shape


class _PhaseTimes:
    """Host ms of every prefill (by bucket, the warmup's left out) and tick
    of the engines built while it is active: it wraps ``DecodeEngine``'s
    two methods, each of which ends in a device-to-host copy, so the host
    clock covers the device work."""

    def __init__(self):
        from repro_torch.serving import engine
        self.cls = engine.DecodeEngine
        self.prefill, self.tick = {}, []

    def __enter__(self):
        cls, times = self.cls, self
        self.orig = (cls.prefill_request, cls.tick)
        orig_prefill, orig_tick = self.orig

        def prefill_request(eng, req):
            t0 = time.perf_counter()
            out = orig_prefill(eng, req)
            if req.uid < 0:                     # the engine's warmup
                return out
            bucket = eng.bucket_for(len(req.tokens) if req.tokens is not None
                                    else 1)
            times.prefill.setdefault(bucket, []).append(
                (time.perf_counter() - t0) * 1e3)
            return out

        def tick(eng, state):
            t0 = time.perf_counter()
            out = orig_tick(eng, state)
            times.tick.append((time.perf_counter() - t0) * 1e3)
            return out

        cls.prefill_request, cls.tick = prefill_request, tick
        return self

    def __exit__(self, *exc):
        self.cls.prefill_request, self.cls.tick = self.orig

    def reset(self):
        self.prefill, self.tick = {}, []

    def summary(self) -> str:
        by_bucket = {b: round(sum(t) / len(t), 3)
                     for b, t in sorted(self.prefill.items())}
        per_tick = sum(self.tick) / max(len(self.tick), 1)
        return (f"ticks={len(self.tick)} ms/tick={per_tick:.3f} "
                f"ms/prefill by bucket={by_bucket}")


def _check_served(label, report, traffic, vocab):
    budgets = {r.uid: r.max_new for r in traffic}
    if sorted(r.uid for r in report.results) != sorted(budgets):
        raise AssertionError(f"{label}: served {report.n_requests} of "
                             f"{len(budgets)} requests")
    for r in report.results:
        if len(r.tokens) != budgets[r.uid]:
            raise AssertionError(f"{label}: request {r.uid} got "
                                 f"{len(r.tokens)} tokens, budget "
                                 f"{budgets[r.uid]}")
        if not all(0 <= t < vocab for t in r.tokens):
            raise AssertionError(f"{label}: request {r.uid} has tokens "
                                 f"outside [0, {vocab})")


def phase_serving(dev):
    """Serve through the port's front doors, counting launches: flash
    attention must launch once per layer for every prefill, the engine's
    warmup (one prefill per bucket) included, and nothing else may
    launch. Returns the launches per kernel over the runs."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models.model import init_params
    from repro_torch.serving import (DecodeEngine, PolicyServer,
                                     make_traffic, serve)

    totals = {}
    with _PhaseTimes() as times:
        for label, cfg, kw, n, lens, want_flash in serving_runs():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            dispatch.reset_launches()
            times.reset()
            t_run = time.perf_counter()
            extra = ""
            engine = server = path = None
            if cfg is None:
                # cartpole's observations have 4 entries and 2 actions
                report = serve(key=0, n_requests=n, realtime=False,
                               device=dev, **kw)
                traffic = make_traffic(n, seed=0, rate_rps=50.0,
                                       max_new=kw["max_new"], obs_dim=4)
                _check_served(label, report, traffic, 2)
            else:
                gen = torch.Generator(device=dev)
                gen.manual_seed(0)
                engine = DecodeEngine(cfg, init_params(cfg, gen, device=dev),
                                      device=dev, **kw)
                # the later families' flash launches (Grok-1's G = 6,
                # Hymba's G = 5) are held against the plain version on
                # their own inputs
                path = _PathInputs() if cfg.moe is not None \
                    or cfg.mla is not None or cfg.family == "hybrid" \
                    else contextlib.nullcontext()
                with path:
                    t0 = time.perf_counter()
                    server = PolicyServer(engine)       # runs the warmup
                    extra = f" warmup_s={time.perf_counter() - t0:.3f}"
                    times.reset()
                    traffic = make_traffic(n, seed=0, vocab=cfg.vocab_size,
                                           prompt_lens=lens,
                                           max_new=kw["max_new"])
                    report = server.run_offline(traffic)
                _check_served(label, report, traffic, cfg.vocab_size)
                experts, weights = tick_read_bound(cfg)
                extra += (f" peak_memory={torch.cuda.max_memory_allocated()}"
                          f" tick_read_bound_ms: experts "
                          f"{experts / HBM_BYTES_PER_S * 1e3:.3f} "
                          f"({experts} bytes), all weights "
                          f"{weights / HBM_BYTES_PER_S * 1e3:.3f} "
                          f"({weights} bytes)")
                if cfg.is_recurrent:
                    states = state_bytes(engine.init_state().cache)
                    extra += (f", recurrent states read and written "
                              f"{2 * states / HBM_BYTES_PER_S * 1e3:.3f} "
                              f"({states} bytes)")
            torch.cuda.synchronize()
            counts = dispatch.launch_counts()
            _check_launches(label, counts, {"flash_attention": want_flash})
            _add(totals, counts)
            log(f"[serve] {label}: {report.summary()} {times.summary()}"
                f"{extra} flash_launches={counts['flash_attention']} "
                f"run_s={time.perf_counter() - t_run:.3f}")
            log(f"[serve] {label}: first streams "
                f"{[r.tokens[:8] for r in report.results[:3]]}")
            if isinstance(path, _PathInputs):
                path.check(label)
            if label == "llama3.2-1b_serve":
                _analysis_serving(engine, dev)
            if cfg is not None and (cfg.moe is not None and cfg.mla is not None
                                    or cfg.is_recurrent):
                shape = _bit_repeat(cfg, engine.params, dev)
                log(f"[serve] {label}: a 256-token prefill repeated on the "
                    f"card: logits {tuple(shape)} and every cache leaf "
                    f"bit-equal")
            del report, engine, server, path
            torch.cuda.empty_cache()
    return totals


def phase_serving_cpu_agreement(dev):
    """Llama-3.2-1B's width at 2 layers (depth cut only), the same weights
    on the card and on the CPU: prefill logits within 1e-4 (f32 sums in
    other orders over d_model 2048 and d_ff 8192, logits of O(1)), and
    the served greedy streams equal up to each request's first step whose
    top-1 margin (on the CPU) is within that tolerance."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import (decode_step, init_params, prefill,
                                          tree_map)
    from repro_torch.serving import (DecodeEngine, PolicyServer,
                                     make_traffic)
    tol = 1e-4
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2)
    gen = torch.Generator()
    gen.manual_seed(1)
    cpu_params = init_params(cfg, gen, device="cpu")
    card_params = tree_map(lambda t: t.to(dev), cpu_params)
    traffic = make_traffic(4, seed=1, vocab=cfg.vocab_size,
                           prompt_lens=(1, 16, 77, 128), max_new=8,
                           jitter_budget=False)
    worst = 0.0
    for req in traffic:
        toks = torch.as_tensor(req.tokens[None], dtype=torch.long)
        lc, _ = prefill(cfg, cpu_params, toks, last_only=False)
        lg, _ = prefill(cfg, card_params, toks.to(dev), last_only=False)
        err = (lg.cpu() - lc).abs().max().item()
        worst = max(worst, err)
        if not err <= tol:
            raise AssertionError(f"card/CPU prefill logits of request "
                                 f"{req.uid} differ by {err} > {tol}")
    streams = {}
    for d, params in (("cpu", cpu_params), (dev, card_params)):
        engine = DecodeEngine(cfg, params, slots=4, max_new=8,
                              max_prompt=128, device=d)
        report = PolicyServer(engine, warmup=False).run_offline(traffic)
        streams[str(d)] = {r.uid: r.tokens for r in report.results}
    compared = 0
    for req in traffic:
        # the CPU's unbatched greedy stream and each step's top-1 margin
        W = len(req.tokens) + req.max_new
        logits, cache = prefill(cfg, cpu_params, torch.as_tensor(
            req.tokens[None], dtype=torch.long), cache_len=W)
        row, margins, want = logits[0, -1], [], []
        for i in range(req.max_new):
            top = torch.topk(row, 2).values
            margins.append((top[0] - top[1]).item())
            tok = torch.argmax(row)
            want.append(int(tok))
            if i + 1 < req.max_new:
                logits, cache = decode_step(cfg, cpu_params, tok[None],
                                            cache)
                row = logits[0, 0]
        n = next((i for i, m in enumerate(margins) if m <= tol),
                 len(margins))
        cpu_s, card_s = streams["cpu"][req.uid], streams[str(dev)][req.uid]
        if cpu_s != want or card_s[:n] != want[:n] \
                or len(card_s) != len(want):
            raise AssertionError(f"request {req.uid}: card {card_s}, CPU "
                                 f"{cpu_s}, unbatched {want}, margins "
                                 f"{margins}")
        compared += n
    log(f"[check] card vs CPU, Llama-3.2-1B width at 2 layers (4 requests, "
        f"prompts <= 128, 8 new tokens): prefill logits max abs err "
        f"{worst:.3e} (tol {tol}); streams equal over {compared} of "
        f"{sum(r.max_new for r in traffic)} tokens under the margin rule")
    phase_policy_cpu_agreement(dev, tol)


class _RoutingMargins:
    """While active, every MoE layer's smallest top-k routing margin (the
    gap between the k-th and (k+1)-th router probability over its tokens)
    is recorded: a rounding difference below it cannot flip a choice.
    It may be entered again; the margins accumulate."""

    def __init__(self):
        self.margins = []

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe.moe_forward

        def recorded(p, cfg, x, **kw):
            with torch.no_grad():
                self.margins.append(moe.top_k_margin(
                    moe.router_probs(p, x), cfg.moe.top_k).item())
            return self.orig(p, cfg, x, **kw)

        moe.moe_forward = recorded
        return self

    def __exit__(self, *exc):
        self.moe.moe_forward = self.orig

    def smallest(self) -> float:
        return min(self.margins, default=float("inf"))


def _padded_stream(cfg, params, tokens, max_new, bucket):
    """The CPU's unbatched greedy stream of one request as the engine
    serves it: the prompt right-padded to its ``bucket`` (pad tokens take
    part in an MoE layer's routing and capacity), the first token read at
    the true last position, the padded ring entries emptied. Returns the
    tokens and each step's top-1 margin."""
    import torch
    from repro_torch.models.model import decode_step, prefill
    P = len(tokens)
    toks = torch.zeros((1, bucket), dtype=torch.long)
    toks[0, :P] = torch.as_tensor(tokens)
    logits, cache = prefill(cfg, params, toks, cache_len=bucket + max_new,
                            last_only=False)
    cache["slot_pos"][cache["slot_pos"] >= P] = -1
    cache["pos"] = torch.tensor(P)
    row, margins, want = logits[0, P - 1], [], []
    for i in range(max_new):
        top = torch.topk(row, 2).values
        margins.append((top[0] - top[1]).item())
        tok = torch.argmax(row)
        want.append(int(tok))
        if i + 1 < max_new:
            logits, cache = decode_step(cfg, params, tok[None], cache)
            row = logits[0, 0]
    return want, margins


def phase_moe_cpu_agreement(dev):
    """DeepSeek-V2-Lite's width at 1 layer (MLA with absorbed decode, 64
    experts top-6 with 2 shared), the same weights on the card and on the
    CPU: the prefill logits within ``MOE_REL_TOL`` of their largest
    entry (the expert weights' E^-1/2 init makes the residual stream
    O(100), so an absolute tolerance says nothing), and the served greedy
    streams equal up to each request's first step whose top-1 margin (on
    the CPU, over the padded prompt the engine serves) is within that
    tolerance. The smallest top-k routing margin of the card's run is
    reported, and named in any failure, so that a routing flip is a
    stated cause."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, prefill, tree_map
    from repro_torch.serving import (DecodeEngine, PolicyServer,
                                     make_traffic)
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"), n_layers=1)
    gen = torch.Generator()
    gen.manual_seed(1)
    cpu_params = init_params(cfg, gen, device="cpu")
    card_params = tree_map(lambda t: t.to(dev), cpu_params)
    traffic = make_traffic(4, seed=1, vocab=cfg.vocab_size,
                           prompt_lens=(1, 16, 77, 128), max_new=4,
                           jitter_budget=False)
    worst, scale = 0.0, 0.0
    card_margins = _RoutingMargins()
    for req in traffic:
        toks = torch.as_tensor(req.tokens[None], dtype=torch.long)
        lc, _ = prefill(cfg, cpu_params, toks, last_only=False)
        with card_margins:
            lg, _ = prefill(cfg, card_params, toks.to(dev), last_only=False)
        err = (lg.cpu() - lc).abs().max().item()
        big = lc.abs().max().item()
        worst, scale = max(worst, err / big), max(scale, big)
        if not err <= MOE_REL_TOL * big:
            raise AssertionError(
                f"DeepSeek-V2-Lite width: card/CPU prefill logits of "
                f"request {req.uid} differ by {err} > {MOE_REL_TOL} x "
                f"{big}; smallest routing margin on the card "
                f"{card_margins.smallest()}")
    tol = MOE_REL_TOL * scale
    streams = {}
    for d, params in (("cpu", cpu_params), (dev, card_params)):
        engine = DecodeEngine(cfg, params, slots=4, max_new=4,
                              max_prompt=128, device=d)
        with card_margins if d == dev else contextlib.nullcontext():
            report = PolicyServer(engine, warmup=False).run_offline(traffic)
        streams[str(d)] = {r.uid: r.tokens for r in report.results}
    compared = 0
    for req in traffic:
        want, margins = _padded_stream(cfg, cpu_params, req.tokens,
                                       req.max_new,
                                       engine.bucket_for(len(req.tokens)))
        n = next((i for i, m in enumerate(margins) if m <= tol),
                 len(margins))
        cpu_s, card_s = streams["cpu"][req.uid], streams[str(dev)][req.uid]
        if cpu_s != want or card_s[:n] != want[:n] \
                or len(card_s) != len(want):
            raise AssertionError(
                f"DeepSeek-V2-Lite width, request {req.uid}: card {card_s}, "
                f"CPU {cpu_s}, unbatched {want}, margins {margins}; "
                f"smallest routing margin on the card "
                f"{card_margins.smallest()}")
        compared += n
    log(f"[check] card vs CPU, DeepSeek-V2-Lite width at 1 layer (4 "
        f"requests, prompts <= 128, 4 new tokens): prefill logits max abs "
        f"err / max|logits| {worst:.3e} (tol {MOE_REL_TOL}, max|logits| "
        f"{scale:.6f}); streams equal over {compared} of "
        f"{sum(r.max_new for r in traffic)} tokens under the margin rule "
        f"(tol {tol:.3e}); smallest top-{cfg.moe.top_k} routing margin on "
        f"the card {card_margins.smallest():.3e} over "
        f"{len(card_margins.margins)} MoE calls")


def phase_recurrent_cpu_agreement(dev):
    """Hymba-1.5B at full width and 2 layers, and xLSTM-350M at full width
    and 1 (mLSTM, sLSTM) pair, the same weights (drawn on the CPU) on the
    card and on the CPU: the prefill logits within ``REC_REL_TOL`` of
    their largest entry (f32 sums in other orders, compounded through
    every step of the scans), and the served greedy streams (exact-length
    prefills) equal up to each request's first step whose top-1 margin
    (on the CPU, over the unbatched exact-length stream) is within that
    tolerance times max|logits|."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, prefill, tree_map
    from repro_torch.serving import (DecodeEngine, PolicyServer,
                                     make_traffic)
    for arch in ("hymba-1.5b", "xlstm-350m"):
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        gen = torch.Generator()
        gen.manual_seed(1)
        cpu_params = init_params(cfg, gen, device="cpu")
        card_params = tree_map(lambda t: t.to(dev), cpu_params)
        traffic = make_traffic(4, seed=1, vocab=cfg.vocab_size,
                               prompt_lens=(1, 16, 77, 128), max_new=8,
                               jitter_budget=False)
        worst, scale = 0.0, 0.0
        for req in traffic:
            toks = torch.as_tensor(req.tokens[None], dtype=torch.long)
            lc, _ = prefill(cfg, cpu_params, toks, last_only=False)
            lg, _ = prefill(cfg, card_params, toks.to(dev), last_only=False)
            err = (lg.cpu() - lc).abs().max().item()
            big = lc.abs().max().item()
            worst, scale = max(worst, err / big), max(scale, big)
            if not err <= REC_REL_TOL * big:
                raise AssertionError(
                    f"{arch} width: card/CPU prefill logits of request "
                    f"{req.uid} ({len(req.tokens)} tokens) differ by {err} "
                    f"> {REC_REL_TOL} x {big}")
        tol = REC_REL_TOL * scale
        streams = {}
        for d, params in (("cpu", cpu_params), (dev, card_params)):
            engine = DecodeEngine(cfg, params, slots=4, max_new=8,
                                  max_prompt=128, device=d)
            report = PolicyServer(engine, warmup=False).run_offline(traffic)
            streams[str(d)] = {r.uid: r.tokens for r in report.results}
        compared = 0
        for req in traffic:
            want, margins = _padded_stream(cfg, cpu_params, req.tokens,
                                           req.max_new, len(req.tokens))
            n = next((i for i, m in enumerate(margins) if m <= tol),
                     len(margins))
            cpu_s, card_s = streams["cpu"][req.uid], \
                streams[str(dev)][req.uid]
            if cpu_s != want or card_s[:n] != want[:n] \
                    or len(card_s) != len(want):
                raise AssertionError(
                    f"{arch} width, request {req.uid}: card {card_s}, CPU "
                    f"{cpu_s}, unbatched {want}, margins {margins}")
            compared += n
        log(f"[check] card vs CPU, {arch} width at "
            f"{'2 layers' if cfg.family == 'hybrid' else '1 pair'} (4 "
            f"requests, prompts 1, 16, 77, 128 at exact length, 8 new "
            f"tokens): prefill logits max abs err / max|logits| "
            f"{worst:.3e} (tol {REC_REL_TOL}, max|logits| {scale:.6f}); "
            f"streams equal over {compared} of "
            f"{sum(r.max_new for r in traffic)} tokens under the margin "
            f"rule (tol {tol:.3e})")
        del cpu_params, card_params


#: a transformer policy at head dim 48, which the flash kernel runs
#: zero-padded to 64
POLICY_HD48 = "transformer(d_model=96, n_heads=2)"


def hold_policy_streams(label, cfg, cpu_params, env, traffic, cpu_streams,
                        card_streams, tol) -> int:
    """The margin rule for a transformer policy's served action streams:
    the CPU's equal each request's unbatched greedy stream on the CPU
    (the observation in the first prefix embedding, one prompt token),
    and the card's equal it up to the request's first step whose top-1
    margin is within ``tol``. Returns the tokens compared."""
    import numpy as np
    import torch
    from repro_torch.models.model import decode_step, prefill
    compared = 0
    for req in traffic:
        pe = torch.zeros((1, cfg.n_prefix_embeds, cfg.d_model))
        pe[0, 0, :req.obs.shape[0]] = torch.from_numpy(req.obs)
        logits, cache = prefill(cfg, cpu_params, torch.zeros(
            (1, 1), dtype=torch.long), pe, cache_len=cfg.n_prefix_embeds
            + 1 + req.max_new)
        row, margins, want = logits[0, -1, :env.n_actions], [], []
        for i in range(req.max_new):
            top = torch.topk(row, 2).values
            margins.append((top[0] - top[1]).item())
            tok = torch.argmax(row)
            want.append(int(tok))
            if i + 1 < req.max_new:
                logits, cache = decode_step(cfg, cpu_params, tok[None],
                                            cache)
                row = logits[0, 0, :env.n_actions]
        m = next((i for i, x in enumerate(margins) if x <= tol),
                 len(margins))
        cpu_s, card_s = cpu_streams[req.uid], card_streams[req.uid]
        if cpu_s != want or card_s[:m] != want[:m] \
                or len(card_s) != len(want):
            raise AssertionError(f"{label} request {req.uid}: card "
                                 f"{card_s}, CPU {cpu_s}, unbatched {want}, "
                                 f"margins {np.round(margins, 6).tolist()}")
        compared += m
    return compared


def phase_policy_cpu_agreement(dev, tol):
    """``serve()`` with the :data:`POLICY_HD48` policy on the card and on
    the CPU, the same weights (drawn on the CPU): the card's prefills must
    go through the flash kernel, and the greedy streams must equal the
    CPU's unbatched ones up to each request's first step whose top-1
    margin is within ``tol``."""
    import torch
    from repro_torch.core.registry import resolve
    from repro_torch.kernels import dispatch
    from repro_torch.models.model import tree_map
    from repro_torch.serving import make_traffic, serve
    env = resolve("env", "cartpole(horizon=32)")
    pol = resolve("policy", POLICY_HD48, env=env)
    cfg = pol.model_cfg
    if cfg.resolved_head_dim != 48:
        raise AssertionError(f"{POLICY_HD48}: head dim "
                             f"{cfg.resolved_head_dim}, expected 48")
    gen = torch.Generator()
    gen.manual_seed(3)
    cpu_params = pol.init(gen)
    n, max_new = 8, 8
    streams, launched = {}, {}
    for d, params in (("cpu", cpu_params),
                      (dev, tree_map(lambda t: t.to(dev), cpu_params))):
        before = dispatch.launch_counts()["flash_attention"]
        report = serve(pol, env, params=params, n_requests=n, slots=4,
                       max_new=max_new, realtime=False, warmup=False,
                       device=d)
        torch.cuda.synchronize()
        launched[str(d)] = dispatch.launch_counts()["flash_attention"] - before
        streams[str(d)] = {r.uid: r.tokens for r in report.results}
    # one flash launch per layer per prefill on the card, none on the CPU
    if launched != {"cpu": 0, str(dev): cfg.n_layers * n}:
        raise AssertionError(f"{POLICY_HD48}: flash launches {launched}, "
                             f"expected {cfg.n_layers * n} on the card")
    traffic = make_traffic(n, seed=0, rate_rps=50.0, max_new=max_new,
                           obs_dim=env.obs_dim)
    compared = hold_policy_streams(POLICY_HD48, cfg, cpu_params, env,
                                   traffic, streams["cpu"],
                                   streams[str(dev)], tol)
    log(f"[check] card vs CPU, {POLICY_HD48} (head dim 48 on the hd 64 "
        f"kernel, {launched[str(dev)]} flash launches on the card): greedy "
        f"streams equal over {compared} of "
        f"{sum(r.max_new for r in traffic)} tokens under the margin rule "
        f"(tol {tol})")


def phase_cpu_agreement(dev):
    """Small runs on the card against the same runs on the CPU (plain
    versions), fed the same draws and θ₀: RFA/MDA, Krum/cwtm and the
    trimmed mean with cwmed under per-receiver equivocation."""
    import numpy as np
    import torch
    from repro_torch.core.decbyzpg import DecByzPGConfig, run_decbyzpg
    from repro_torch.core.noise import draw_step_noise
    from repro_torch.rl.envs import make_cartpole
    from repro_torch.rl.policy import resolve_policy

    env = make_cartpole(horizon=32)
    small = dict(K=13, n_byz=3, attack="large_noise(sigma=10)", N=8, B=2)
    T = 3
    for label, cfg in [
            ("rfa_mda", DecByzPGConfig(**small)),
            ("krum_cwtm", DecByzPGConfig(**small, aggregator="krum",
                                         agreement="cwtm")),
            ("tm_cwmed_per_receiver",
             DecByzPGConfig(**small, aggregator="trimmed_mean",
                            agreement="cwmed", per_receiver=True))]:
        policy = resolve_policy(cfg, env)
        gen = torch.Generator()
        gen.manual_seed(1)
        theta0 = policy.init_theta(gen)
        noise = [draw_step_noise(gen, cfg, env, policy.d, t)
                 for t in range(T)]
        on_card = [type(nz)(*(None if x is None else x.to(dev) for x in nz))
                   for nz in noise]
        cpu = run_decbyzpg(env, cfg, T, device="cpu", theta0=theta0,
                           noise=noise)
        gpu = run_decbyzpg(env, cfg, T, device=dev, theta0=theta0.to(dev),
                           noise=on_card)
        # f32 sums in other orders on the two devices; the rollouts must
        # pick the same actions, so returns agree to rounding
        if not np.array_equal(cpu["coins"], gpu["coins"]):
            raise AssertionError(f"{label}: card/CPU coins differ")
        np.testing.assert_allclose(gpu["returns"], cpu["returns"], rtol=1e-5)
        th_err = (gpu["theta"].cpu() - cpu["theta"]).abs().max().item()
        if not th_err <= 1e-4:
            raise AssertionError(f"{label}: card/CPU theta differ by "
                                 f"{th_err} > 1e-4")
        log(f"[check] card vs CPU plain path, {label} (K=13, n_byz=3, "
            f"T={T}): coins equal, returns within rtol 1e-5, theta max abs "
            f"err {th_err:.3e} (tol 1e-4)")


# ---------------------------------------------------------------------------
# Phase 10: federated LLM training (distributed/fed_trainer.py)
# ---------------------------------------------------------------------------

#: Llama-3.2-1B at full width, cut from 16 to 2 layers: its (K, D) stacks
#: at K = 4 hold D = 384,313,344 (the embedding 262,668,288 of it)
FED_ARCH, FED_LAYERS, FED_D = "llama3.2-1b", 2, 384313344
FED_K, FED_BYZ, FED_BATCH, FED_SEQ = 4, 1, 2, 128
#: the tree run's seed: its window's coins, drawn on the card after θ₀,
#: hold a c = 1 (t = 0) and a c = 0 ([1, 0, 1, 0, 0]; seed 0's are all 1)
FED_SEED, FED_TREE_T, FED_FLAT_T = 1, 5, 3
FED_KW = dict(n_byz=FED_BYZ, attack="large_noise(sigma=10)", kappa=3,
              lr=1e-3, page_p=0.25, seed=FED_SEED)
#: the flat runs' coins: a large step, then two PAGE steps
FED_FLAT_COINS = (True, False, False)
#: launches per flat step: bucketing (2 buckets of 2: Lemma 3 at K = 4,
#: n_byz = 1) ∘ RFA, Krum (n_near 1), the trimmed mean (n_trim 1)
FED_FLAT_LAUNCHES = {"rfa": {"gram": 1, "weiszfeld": 1, "wsum": 1},
                     "krum": {"gram": 1, "krum_score": 1},
                     "trimmed_mean": {"trimmed_mean": 1}}
#: the peak the full-width runs must stay under
FED_PEAK_LIMIT = 70 * 2 ** 30
#: tree against flat at full width (mean, no attack): θ within this share
#: of max|θ| (an H100 run measured 2.2e-8: the Gram and mixing sums leaf
#: by leaf against one ravel) and the honest losses within FED_LOSS_TOL
#: (about an ulp at 12; the run measured 0)
FED_TREE_FLAT_TOL = 2e-7
FED_LOSS_TOL = 1e-6
#: the card against the CPU (reduced Llama, 2 steps): the aggregated
#: direction v within FED_CPU_V_TOL of max|v|, θ within FED_CPU_TOL of
#: max|θ| (an H100 run measured 2.0e-5 on v, where the PAGE step's
#: g_new − g_old cancels, and 7.3e-5 on θ, Adam near its eps: see
#: ``phase_fed_cpu_agreement``)
FED_CPU_V_TOL = 1e-4
FED_CPU_TOL = 2e-4
#: gram's gap to its plain version on the flat trainer's input, as a share
#: of √(G_ii G_jj) per entry
FED_GRAM_TOL = 1e-6
#: per-coordinate kernels are held against their plain versions on column
#: blocks of this many coordinates (the plain trimmed mean pads K to 8)
FED_BLOCK = 1 << 26
FED_CLI_TIMEOUT_S = 600


def _fed_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(FED_ARCH), n_layers=FED_LAYERS)


def _fed_pipe(cfg, dev):
    from repro_torch.data import DataConfig, TokenPipeline
    return TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=FED_SEQ,
                                    per_agent_batch=FED_BATCH,
                                    n_agents=FED_K, seed=FED_SEED),
                         device=dev)


class _FedTimer:
    """While active, each ``fed_train_step`` call and each of the
    trainers' ``obs.named_phase`` ranges is timed on the host clock,
    synchronised at both ends (synchronising changes no value)."""

    def __enter__(self):
        import torch
        from repro_torch import obs
        from repro_torch.distributed import fed_trainer as ft
        self.ft, self.obs = ft, obs
        self.step_ms, self.phase_ms = [], {}
        self.orig_step, self.orig_phase = ft.fed_train_step, obs.named_phase

        @contextlib.contextmanager
        def timed(name, enabled=True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            key = name.split(".", 1)[1]
            self.phase_ms.setdefault(key, []).append(
                (time.perf_counter() - t0) * 1e3)

        def step(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.orig_step(*args, **kwargs)
            torch.cuda.synchronize()
            self.step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        ft.fed_train_step = step
        obs.named_phase = timed
        return self

    def __exit__(self, *exc):
        self.ft.fed_train_step = self.orig_step
        self.obs.named_phase = self.orig_phase


def _fed_tree_run(cfg, fed, dev, batches, mask):
    """One seeded ``fed_train_window`` of FED_TREE_T steps from the common
    init, which nothing here keeps (the window lets go of each spent
    state); returns (state, metrics). One generator draws θ₀, then the
    window's coins and noise, as the training CLI does."""
    from repro_torch.core.engine import seed_generator
    from repro_torch.distributed.fed_trainer import (fed_train_window,
                                                     init_fed_state)
    gen = seed_generator(fed.seed, dev)
    return fed_train_window(
        cfg, fed, init_fed_state(cfg, fed, FED_K, gen, device=dev),
        batches, mask, range(FED_TREE_T), gen)


def _fed_mesh_repeat(cfg, fed, dev, batches, mask):
    """The window's FED_TREE_T steps again through ``make_fed_step`` on a
    one-rank ("data", "model") = (1, 1) mesh: the seeded generator's
    θ₀, coins and draws in the window's order, each step the step of its
    coin, the placed state made from the common init without a copy.
    Returns (state, metrics stacked, coins, ms per step, peak bytes,
    bytes allocated when the peak was reset: the mesh made)."""
    import torch
    from repro_torch.analysis.donation import one_rank_mesh
    from repro_torch.core.engine import seed_generator
    from repro_torch.core.noise import draw_fed_coins
    from repro_torch.distributed.fed_trainer import (fed_noise,
                                                     init_fed_state,
                                                     make_fed_step,
                                                     place_fed_state)
    with one_rank_mesh(dev.type) as mesh:
        steps = {c: make_fed_step(cfg, fed, mesh, large=c,
                                  per_agent_batch=FED_BATCH,
                                  seq_len=FED_SEQ)[0] for c in (True, False)}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gen = seed_generator(fed.seed, dev)
        state = place_fed_state(
            init_fed_state(cfg, fed, FED_K, gen, device=dev), mesh, cfg)
        coins = draw_fed_coins(gen, range(FED_TREE_T), fed.page_p)
        rows, ms = [], []
        for t, coin in enumerate(coins):
            batch = {k: v[t] for k, v in batches.items()}
            nz = fed_noise(gen, fed, state, FED_BYZ)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = steps[coin](state, batch, mask, nz)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            rows.append(m)
        peak = torch.cuda.max_memory_allocated()
    out = {k: torch.stack([m[k] for m in rows]) for k in rows[0]}
    return state, out, coins, ms, peak, base


def phase_fed_tree(dev):
    """``fed_tree_llama``: the tree trainer's window over FED_TREE_T steps
    at full width (K = 4, n_byz = 1 ``large_noise(sigma=10)``,
    ``fed_aggregator`` rfa, κ = 3, Adam lr 1e-3, batches of 2 x 128 tokens
    per agent): both coins occur, every output is finite, the t = 0 honest
    loss equals the mean of ``lm_loss_labeled`` at θ₀ on the honest
    agents' batches, the peak stays under FED_PEAK_LIMIT, no kernel
    launches (the tree aggregators are plain, as the reference's). Then
    the same steps through ``make_fed_step`` on a one-rank (1, 1) mesh
    (:func:`_fed_mesh_repeat`, the placed state's route with every split
    of size 1): the same coins, parameters, losses and diameters bit for
    bit, at the window's peak to the byte, no kernel launch."""
    import torch
    from repro_torch.core.tree import tree_paths
    from repro_torch.distributed.fed_trainer import FedConfig
    from repro_torch.kernels import dispatch
    from repro_torch.models.model import init_params, lm_loss_labeled
    cfg = _fed_cfg()
    fed = FedConfig(aggregator="rfa", **FED_KW)
    pipe = _fed_pipe(cfg, dev)
    steps = [pipe.batch(t) for t in range(FED_TREE_T)]
    batches = {k: torch.stack([b[k] for b in steps]) for k in steps[0]}
    mask = torch.arange(FED_K, device=dev) < FED_BYZ
    with torch.no_grad():
        p0 = init_params(cfg, FED_SEED, device=dev)
        want0 = torch.stack([
            lm_loss_labeled(cfg, p0, steps[0]["tokens"][k],
                            steps[0]["labels"][k])
            for k in range(FED_BYZ, FED_K)]).mean().item()
        del p0
    # the autograd thread's cuBLAS workspace (32 MiB, kept for the
    # process) is made here, before both runs' peaks are measured
    w = torch.ones((2, 2), device=dev, requires_grad=True)
    (w @ w).sum().backward()
    del w
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    with _FedTimer() as timer:
        state, m = _fed_tree_run(cfg, fed, dev, batches, mask)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = dispatch.launch_counts()
    _check_launches("fed_tree_llama", counts, {})
    leaves = [t for _, t in tree_paths(state.params)]
    D = sum(t[0].numel() for t in leaves)
    if D != FED_D:
        raise AssertionError(f"fed_tree_llama: D {D}, expected {FED_D}")
    coins = m["coin"].tolist()
    if not (any(coins) and not all(coins)):
        raise AssertionError(f"fed_tree_llama: coins {coins} lack a c = 1 "
                             f"or a c = 0 step")
    losses, diam = m["loss"].tolist(), m["diameter"].tolist()
    if not all(bool(torch.isfinite(t).all())
               for t in [m["loss"], m["diameter"], *leaves]):
        raise AssertionError("fed_tree_llama: non-finite outputs")
    if not abs(losses[0] - want0) <= 1e-6 * abs(want0):
        raise AssertionError(f"fed_tree_llama: t=0 honest loss {losses[0]} "
                             f"vs lm_loss_labeled at θ₀ {want0}")
    if not peak < FED_PEAK_LIMIT:
        raise AssertionError(f"fed_tree_llama: peak {peak} bytes >= "
                             f"{FED_PEAK_LIMIT}")
    _analysis_fed_step(cfg, fed, state,
                       {k: v[0] for k, v in batches.items()}, mask, dev)
    kept = [t.cpu() for t in leaves]
    m = {k: v.cpu() for k, v in m.items()}
    del state, leaves
    torch.cuda.empty_cache()
    dispatch.reset_launches()
    with _FedTimer() as warm:
        again, m2, coins2, mesh_ms, mesh_peak, mesh_base = _fed_mesh_repeat(
            cfg, fed, dev, batches, mask)
    mesh_counts = dispatch.launch_counts()
    _check_launches("fed_tree_llama_mesh", mesh_counts, {})
    from repro_torch.carriers import placed
    same = all(torch.equal(a, placed.local(b).cpu()) for a, (_, b) in
               zip(kept, tree_paths(again.params)))
    if not (same and coins2 == coins
            and torch.equal(m2["loss"].cpu(), m["loss"])
            and torch.equal(m2["diameter"].cpu(), m["diameter"])):
        raise AssertionError("fed_tree_llama: the make_fed_step repeat on a "
                             "one-rank mesh is not bit-equal")
    if (mesh_peak, mesh_base) != (peak, base):
        raise AssertionError(f"fed_tree_llama: the one-rank mesh's peak "
                             f"{mesh_peak} bytes from {mesh_base} at its "
                             f"start, the window's {peak} from {base}")
    del again, kept
    torch.cuda.empty_cache()
    phases, warm_phases = ({k: [round(x, 3) for x in v]
                            for k, v in t.phase_ms.items()}
                           for t in (timer, warm))
    log(f"[fed] {card()}: fed_tree_llama ({FED_ARCH} at full width, "
        f"{FED_LAYERS} layers, D={D}, K={FED_K}, n_byz={FED_BYZ} "
        f"large_noise(sigma=10), fed_aggregator rfa, kappa=3, Adam lr "
        f"1e-3, {FED_BATCH} x {FED_SEQ} tokens per agent, seed "
        f"{FED_SEED}): coins {[int(c) for c in coins]} loss "
        f"{[round(x, 6) for x in losses]} diameter {diam} ms/step "
        f"{[round(x, 3) for x in timer.step_ms]} (window "
        f"{secs * 1e3:.3f} ms, synchronised; step 0 holds the first "
        f"calls' set-up); phase ms per step {phases}; peak memory {peak} "
        f"bytes ({peak / 2 ** 30:.3f} GiB); t=0 honest loss "
        f"{losses[0]:.6f} vs lm_loss_labeled at θ₀ {want0:.6f}; 0 kernel "
        f"launches")
    log(f"[fed] {card()}: fed_tree_llama_mesh (the same steps through "
        f"make_fed_step on a one-rank (data, model) = (1, 1) mesh, the "
        f"placed state made without a copy): ms/step "
        f"{[round(x, 3) for x in mesh_ms]} against the window's "
        f"{[round(x, 3) for x in timer.step_ms]}; phase ms per step "
        f"{warm_phases}; peak memory {mesh_peak} bytes from {mesh_base} "
        f"allocated at its start, the window's to the byte; coins, "
        f"parameters, losses and diameters bit-equal to the window; 0 "
        f"kernel launches")
    return counts


def _fed_gap(name, args, out, ref):
    """The largest gap between a flat-trainer launch and its plain version,
    each entry's gap over its own f32 scale, and the tolerance on that
    share: gram's (i, j) over √(G_ii G_jj) (Cauchy-Schwarz bounds the sum
    of |products|), wsum's coordinate over Σ_k |w_k x_kj|, the trimmed
    mean's over max_k |x_kj|, a Krum score over itself; weiszfeld must be
    bit-equal. A per-entry scale keeps a far Byzantine row from widening
    the honest entries' tolerance."""
    import torch
    gap = (out - ref).abs()
    if name == "gram":
        d = torch.diagonal(ref, dim1=-2, dim2=-1).clamp_min(0)
        scale = torch.sqrt(d[..., :, None] * d[..., None, :])
        tol = FED_GRAM_TOL
    elif name == "wsum":
        x, w = args[0], args[1]
        scale = (w[..., None].abs() * x.abs()).sum(-2)
        tol = 4 * F32_EPS
    elif name == "trimmed_mean":
        scale = args[0].abs().amax(-2)
        tol = args[0].shape[-2] * F32_EPS
    elif name == "krum_score":
        scale = ref.abs()
        tol = args[0].shape[-1] * F32_EPS
    else:                                        # weiszfeld
        return gap.max().item(), 0.0
    share = torch.where(gap > 0, gap / scale.clamp_min(1e-30),
                        torch.zeros_like(gap))
    return share.max().item(), tol


def _fed_kernel_rows(seen, dev):
    """Every recorded flat-trainer launch against its plain version on
    its own input (:func:`_fed_gap`; trimmed_mean and wsum on column
    blocks of FED_BLOCK, gram whole: its chunk plan depends on d), and
    its device time by CUDA events beside the bound, each input moved
    back to the card in turn. Returns log lines."""
    import torch
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import dispatch
    kernels = dispatch.kernels()
    lines = []
    for key in list(seen):
        (name, shapes, kw) = key
        args, kwargs, out = (
            tree_map(lambda a: a.to(dev) if hasattr(a, "to") else a, x)
            for x in seen.pop(key))
        k = kernels[name]
        if name in ("trimmed_mean", "wsum") and \
                args[0].shape[-1] > FED_BLOCK:
            d = args[0].shape[-1]
            err = tol = 0.0
            for lo in range(0, d, FED_BLOCK):
                cols = slice(lo, min(lo + FED_BLOCK, d))
                part = [args[0][..., cols].contiguous(), *args[1:]]
                ref = k.plain(*part, **kwargs)
                e, tol = _fed_gap(name, part, out[..., cols], ref)
                err = max(err, e)
                del part, ref
        else:
            ref = k.plain(*args, **kwargs)
            err, tol = _fed_gap(name, args, out, ref)
            del ref
        if not err <= tol:
            raise AssertionError(f"fed flat: {name} at {shapes} {kw}: gap "
                                 f"{err} of the entry's scale > {tol}")
        torch.cuda.empty_cache()
        ms = time_ms(lambda: k._launch(*args, **kwargs), 5, 1)
        x = args[0]
        bt, kk = x.shape[0], x.shape[1]
        if name == "gram":
            d = x.shape[-1]
            b = bound(4 * (bt * kk * d + bt * kk * kk), 2 * bt * kk * kk * d)
        elif name == "wsum":
            d = x.shape[-1]
            b = bound(4 * (bt * kk * d + bt * kk + bt * d), 2 * bt * kk * d)
        elif name == "trimmed_mean":
            d = x.shape[-1]
            b = bound(4 * (bt * kk * d + bt * d), bt * d * kk * kk)
        elif name == "weiszfeld":
            b = bound(4 * (bt * kk * kk + bt * kk),
                      N_ITER * bt * (2 * kk * kk + 8 * kk))
        else:                                    # krum_score
            b = bound(4 * (bt * kk * kk + bt * kk), bt * kk * kk * (kk + 2))
        ragged = ""
        if name == "gram":
            from repro_torch.kernels.pairwise_dist import gram_chunks
            plan = gram_chunks(x.shape[-1])
            ragged = (f", {len(plan)} chunks, the last "
                      f"{x.shape[-1] - plan[-1]} wide")
        kws = f" {kw}" if kw else ""
        lines.append(
            f"[fed-kernels] {card()}: {name} {shapes}{kws} on the flat "
            f"trainer's own input{ragged}: largest gap to the plain version "
            f"{err:.3e} of the entry's scale (tol {tol:.3e}); device "
            f"{ms:.6f} ms (CUDA events, 5 launches), bound {b[0]:.6f} ms "
            f"({b[1]}), {b[0] / ms:.1%} of the bound")
    return lines


def _fed_flat_steps(cfg, fed, dev, sharded=None, record=False):
    """FED_FLAT_T flat steps (coins FED_FLAT_COINS) from the common init
    and the seeded draws, the launches counted from 0, each step and the
    trainer's phases timed (synchronised; no value changes). ``record``
    keeps the last step's launches (:class:`_PathInputs`, in host
    memory). Returns (state, [(loss, diameter)], ms per step, peak over
    steps 0-1, recorded launches or None, launch counts, phase ms)."""
    import torch
    from repro_torch.core.engine import seed_generator
    from repro_torch.distributed.fed_trainer import (fed_noise,
                                                     fed_train_step_flat,
                                                     init_flat_fed_state)
    from repro_torch.kernels import dispatch
    pipe = _fed_pipe(cfg, dev)
    mask = torch.arange(FED_K, device=dev) < FED_BYZ
    gen = seed_generator(fed.seed, dev)      # θ₀, then every step's noise
    state, unravel = init_flat_fed_state(cfg, fed, FED_K, gen, device=dev)
    if state.theta.shape != (FED_K, FED_D):
        raise AssertionError(f"flat state theta {tuple(state.theta.shape)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    rows, ms, seen = [], [], None
    with _FedTimer() as timer:
        for t, coin in enumerate(FED_FLAT_COINS):
            last = t == len(FED_FLAT_COINS) - 1
            if last:
                peak = torch.cuda.max_memory_allocated()
            with (_PathInputs(host=True) if last and record
                  else contextlib.nullcontext()) as path:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = fed_train_step_flat(
                    cfg, fed, state, unravel, pipe.batch(t), mask,
                    fed_noise(gen, fed, state, FED_BYZ), large=coin,
                    sharded=sharded)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            if last and record:
                seen = path.seen
            rows.append((m["loss"].item(), m["diameter"].item()))
    return (state, rows, ms, peak, seen, dispatch.launch_counts(),
            timer.phase_ms)


def _flat_fields(state) -> dict:
    """The flat state's fields by name (v's first row: every row is the
    broadcast aggregate, one expanded view)."""
    return {"theta": state.theta, "prev": state.prev, "v": state.v[0],
            "adam m": state.opt_state.m, "adam v": state.opt_state.v,
            "adam step": state.opt_state.step, "step": state.step}


class _HostFields:
    """Pinned host buffers for a state's fields, allocated at the first
    :meth:`keep` and reused by every later one of the same shapes (26 GB
    for a full-width flat state); :meth:`equal` brings one field at a
    time back to the card and compares it there, bit for bit."""

    def __init__(self):
        self.bufs = {}

    def keep(self, fields: dict) -> None:
        import torch
        for k, v in fields.items():
            buf = self.bufs.get(k)
            if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
                buf = self.bufs[k] = torch.empty(
                    v.shape, dtype=v.dtype, pin_memory=v.is_cuda)
            buf.copy_(v)

    def equal(self, fields: dict) -> bool:
        import torch
        for k, v in fields.items():
            back = self.bufs[k].to(v.device)
            same = torch.equal(v, back)
            del back
            if not same:
                return False
        return True


def phase_fed_flat(dev):
    """``fed_flat_llama_{rfa,krum,trimmed_mean}``: the flat trainer at
    full width, FED_FLAT_T steps each (coins FED_FLAT_COINS) with the
    registry aggregators: exact launches per step (FED_FLAT_LAUNCHES),
    finite outputs, the peak under FED_PEAK_LIMIT over the first two
    steps (a large and a PAGE step); the last step's launches recorded
    (:class:`_PathInputs`), the state kept in host memory and freed on
    the card, and each launch held against its plain version on its own
    input and timed beside its bound.

    Then phase 10c (a), ``fed_sharded_llama_{...}``: the same steps with
    ``sharded=True`` (the D-sharded flat layer with one shard) from the
    same init and draws, with the same launches per step; every field of
    the final state and every step's loss and diameter bit-equal to the
    run before; ms per step, the phases and the peak. Returns the
    launches per kernel."""
    import torch
    from repro_torch.distributed.fed_trainer import FedConfig
    cfg = _fed_cfg()
    totals = {}
    host = _HostFields()
    for agg, per_step in FED_FLAT_LAUNCHES.items():
        label = f"fed_flat_llama_{agg}"
        fed = FedConfig(aggregator=agg, **FED_KW)
        want = {k: n * FED_FLAT_T for k, n in per_step.items()}
        state, rows, ms, peak, seen, counts, _ = _fed_flat_steps(
            cfg, fed, dev, record=True)
        _check_launches(label, counts, want)
        _add(totals, counts)
        if not (bool(torch.isfinite(state.theta).all())
                and bool(torch.isfinite(torch.tensor(rows)).all())):
            raise AssertionError(f"{label}: non-finite outputs")
        if not peak < FED_PEAK_LIMIT:
            raise AssertionError(f"{label}: peak {peak} bytes >= "
                                 f"{FED_PEAK_LIMIT}")
        t0 = time.perf_counter()
        host.keep(_flat_fields(state))
        keep_s = time.perf_counter() - t0
        del state
        torch.cuda.empty_cache()
        lines = _fed_kernel_rows(seen, dev)
        del seen
        torch.cuda.empty_cache()
        log(f"[fed] {card()}: {label} (D={FED_D}, K={FED_K}, n_byz="
            f"{FED_BYZ} large_noise(sigma=10), registry aggregator {agg}, "
            f"kappa=3): coins {[int(c) for c in FED_FLAT_COINS]} (loss, "
            f"diameter) {rows} ms/step {[round(x, 3) for x in ms]} "
            f"launches/step {per_step} peak memory over steps 0-1 {peak} "
            f"bytes ({peak / 2 ** 30:.3f} GiB)")
        for line in lines:
            log(line)

        flat_label, label = label, f"fed_sharded_llama_{agg}"
        state, srows, sms, speak, _, counts, phases = _fed_flat_steps(
            cfg, fed, dev, sharded=True)
        _check_launches(label, counts, want)
        _add(totals, counts)
        t0 = time.perf_counter()
        same = srows == rows and host.equal(_flat_fields(state))
        cmp_s = time.perf_counter() - t0
        del state
        torch.cuda.empty_cache()
        if not same:
            raise AssertionError(f"{label}: sharded=True is not bit-equal to "
                                 f"the unsharded run: (loss, diameter) "
                                 f"{srows} vs {rows}")
        if not speak < FED_PEAK_LIMIT:
            raise AssertionError(f"{label}: peak {speak} bytes >= "
                                 f"{FED_PEAK_LIMIT}")
        split = {k: [round(x, 3) for x in v] for k, v in phases.items()}
        log(f"[fed] {card()}: {label} (phase 10c a: sharded=True on one "
            f"process, the D-sharded flat layer with one shard; D={FED_D}, "
            f"K={FED_K}, registry aggregator {agg}): ms/step "
            f"{[round(x, 3) for x in sms]} phase ms per step {split} "
            f"launches/step {per_step} (the unsharded run's) peak memory "
            f"over steps 0-1 {speak} bytes ({speak / 2 ** 30:.3f} GiB; "
            f"unsharded {peak}); theta, prev, v, Adam m, v and step and "
            f"every (loss, diameter) bit-equal to {flat_label} (the state "
            f"kept in pinned host buffers in {keep_s:.1f} s, compared "
            f"field by field on the card in {cmp_s:.1f} s)")
    return totals


#: phase 10c (b): the reduced model's flat steps over two gloo ranks on
#: the one card (NCCL refuses two ranks on one GPU), D split in two,
#: against the one-process route; RFA without the attack (under
#: large_noise its weights follow the Gram matrix's rounding order at the
#: attacked row), Krum and the trimmed mean with it
FED_RANKS, FED_RANK_T = 2, 2
FED_RANK_CASES = {"rfa": "none", "krum": "large_noise(sigma=10)",
                  "trimmed_mean": "large_noise(sigma=10)"}
#: θ over the ranks within this share of max|θ| of the one-process run
#: (the Gram partials summed in another order; the CPU tests' gaps are
#: below 2e-6 of the largest state entry)
FED_RANK_TOL = 1e-6
FED_RANK_TIMEOUT_S = 600


@contextlib.contextmanager
def _aggregate_peaks(peaks, dev):
    """While active, each ``fed.aggregate`` phase of the trainers on a
    CUDA ``dev`` appends the peak bytes it allocated above what was
    allocated at its start."""
    import torch
    from repro_torch import obs
    orig = obs.named_phase

    @contextlib.contextmanager
    def phase(name, enabled=True):
        watch = name == "fed.aggregate" and dev.type == "cuda"
        if watch:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        with orig(name, enabled):
            yield
        if watch:
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated() - base)

    obs.named_phase = phase
    try:
        yield
    finally:
        obs.named_phase = orig


def _fed_rank_runs(dev, who, mesh=None, krum_stacks=None,
                   cases=FED_RANK_CASES):
    """FED_RANK_T flat steps (coin 1, then 0) of the reduced model per
    case of ``cases`` (aggregator -> attack), from the seed-1 init with draws from a generator
    on ``dev`` seeded 2: on ``mesh`` (D split over its "model" ranks,
    ``sharded=True``) or on one process. Every launch of a case is
    recorded (:class:`_PathInputs`, host copies, so the aggregate peaks
    stay the route's own) and held against its plain version on its own
    input, logged as ``[path] fed_two_ranks_<aggregator> <who>``.
    ``krum_stacks`` collects the stacks the one-process Krum scores.
    Returns {aggregator: θ's local columns and their first column, the
    launches per step, each step's aggregate peak, loss and ms (to the
    loss on the host)}."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import aggregators
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.carriers import columns
    from repro_torch.distributed import fed_trainer as ft
    from repro_torch.kernels import dispatch
    cfg = reduced(get_config(FED_ARCH))
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 32, 2, FED_K, seed=1),
                         device=dev)
    mask = torch.arange(FED_K, device=dev) < FED_BYZ
    krum = aggregators.krum

    def recorded(x, n_byz, m=1, sharded=None):
        krum_stacks.append(x)
        return krum(x, n_byz, m, sharded)

    out = {}
    for agg, attack in cases.items():
        fed = ft.FedConfig(aggregator=agg, **dict(FED_KW, attack=attack))
        state, unravel = ft.init_flat_fed_state(cfg, fed, FED_K, 1,
                                                device=dev, mesh=mesh)
        gen = torch.Generator(device=dev)
        gen.manual_seed(2)
        launches, peaks, losses, ms = [], [], [], []
        if krum_stacks is not None:
            aggregators.krum = recorded
        try:
            with _PathInputs(host=True) as path:
                for t in range(FED_RANK_T):
                    dispatch.reset_launches()
                    batch = pipe.batch(t)
                    nz = ft.fed_noise(gen, fed, state, FED_BYZ)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with _aggregate_peaks(peaks, dev):
                        state, m = ft.fed_train_step_flat(
                            cfg, fed, state, unravel, batch, mask, nz,
                            large=t == 0, sharded=True if mesh else None)
                    losses.append(m["loss"].item())
                    ms.append((time.perf_counter() - t0) * 1e3)
                    launches.append(dispatch.launch_counts())
        finally:
            aggregators.krum = krum
        if not path.seen:
            raise AssertionError(f"fed_two_ranks_{agg} {who}: no launch "
                                 f"recorded")
        path.check(f"fed_two_ranks_{agg} {who}")
        local, sh = columns.local_columns(state.theta)
        out[agg] = {"theta": local.cpu(), "lo": 0 if sh is None else sh.lo,
                    "launches": launches, "peaks": peaks, "losses": losses,
                    "ms": ms}
    return out


def _join_rank(rank, world, port, where):
    """A spawned rank's join, through ``init_distributed`` on
    localhost:PORT: ``where`` is a device type, or ``cuda/nccl`` and
    ``cuda/gloo`` naming the backend (else the rule picks it: NCCL where
    each rank has a card of its own). Returns the rank's device (its
    card on CUDA)."""
    sys.path.insert(0, str(SRC))
    from repro_torch.distributed import init_distributed
    kind, _, backend = where.partition("/")
    return init_distributed(f"localhost:{port}", int(world), int(rank),
                            timeout_s=FED_RANK_TIMEOUT_S, device=kind,
                            backend=backend or None, group_of_one=True)


def _leave_rank():
    """A spawned rank's teardown, through ``leave_distributed``."""
    from repro_torch.distributed import leave_distributed
    leave_distributed()


def _rank_where(dev, backend=None) -> str:
    """The DEVICE argument of a spawned rank (:func:`_join_rank`)."""
    return dev.type if backend is None else f"{dev.type}/{backend}"


def _run_ranks(flag, world, where, extra=(), parent=None,
               timeout=FED_RANK_TIMEOUT_S):
    """``world`` fresh ``chip_smoke.py FLAG RANK WORLD PORT OUT WHERE
    *EXTRA`` ranks on a free localhost port, with ``parent()`` run here
    meanwhile. Returns (its result, each rank's saved results and
    standard output, in rank order, and the wall seconds from the start
    to the last rank's exit). A rank that fails raises with its errors;
    every rank still running then is stopped."""
    import os
    import socket
    import tempfile
    import torch
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    with tempfile.TemporaryDirectory() as tmp:
        dsts = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), flag, str(r),
             str(world), str(port), dsts[r], where, *extra], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
        try:
            mine = None if parent is None else parent()
            outs = []
            for p in procs:
                out, err = p.communicate(timeout=timeout)
                if p.returncode != 0:
                    raise AssertionError(f"{flag} rank exited "
                                         f"{p.returncode}:\n{err[-3000:]}")
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        secs = time.perf_counter() - t0
        ranks = [torch.load(d, weights_only=False) for d in dsts]
    return mine, ranks, outs, secs


def fed_rank_main(argv) -> int:
    """``chip_smoke.py --fed-rank RANK WORLD PORT OUT DEVICE``: one rank
    of phase 10c (b), joined on localhost:PORT (:func:`_join_rank`),
    on its card (DEVICE ``cuda``) or the CPU; writes its results to
    OUT."""
    rank, world, port, dst, where = argv
    dev = _join_rank(rank, world, port, where)
    import torch
    from repro_torch.launch.mesh import make_debug_mesh
    try:
        mesh = make_debug_mesh(1, int(world), device_type=dev.type)
        torch.save(_fed_rank_runs(dev, f"rank {rank} of {world}", mesh),
                   dst)
    finally:
        _leave_rank()
    return 0


def _krum_gap(x, n_near: int) -> float:
    """Krum's winning margin on the (K, d) stack it scored: the gap
    between the winner's score and the next one above it, over the
    largest squared norm among the two agents and their scored
    neighbours (the Gram identity's rounding scales with those norms, not
    with a far Byzantine's). With one neighbour the closest pair ties
    exactly and the first wins, so the margin is to the next pair."""
    import torch
    from repro_torch.kernels.pairwise_dist import gram, sq_dists_from_gram
    g = gram(x[None])[0].double().cpu()
    d2 = sq_dists_from_gram(g)
    order = torch.argsort(d2, dim=1, stable=True)[:, 1:n_near + 1]
    scores = d2.gather(1, order).sum(1)
    w = int(torch.argmin(scores))
    r = int(torch.argmin(torch.where(scores > scores[w], scores,
                                     torch.inf)))
    involved = {w, r, *order[w].tolist(), *order[r].tolist()}
    return ((scores[r] - scores[w]) / max(g[i, i] for i in involved)).item()


def _ranks_on(dev, world, backend=None) -> str:
    """Where ``world`` spawned ranks run, by ``init_distributed``'s rule:
    "2 gloo ranks on the one card", "2 nccl ranks on 2 cards"."""
    import torch
    from repro_torch.distributed.sharding import choose_backend
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    kind = choose_backend(dev.type, world, cards, backend)
    if not cards:
        return f"{world} {kind} ranks on the CPU"
    used = min(world, cards)
    return f"{world} {kind} ranks on " + ("the one card" if used == 1
                                          else f"{used} cards")


def _fed_two_ranks_spawn(dev, backend=None, one_process=True):
    """Phase 10c (b)'s FED_RANKS ranks (``backend`` as
    :func:`_join_rank` takes it), with the one-process route run here
    meanwhile unless not ``one_process``: (its results, the stacks its
    Krum scored, the ranks' results, the ranks' wall seconds). Each
    rank's ``[path]`` lines are logged."""
    stacks = []
    want, ranks, outs, secs = _run_ranks(
        "--fed-rank", FED_RANKS, _rank_where(dev, backend),
        parent=(lambda: _fed_rank_runs(dev, "one process",
                                       krum_stacks=stacks))
        if one_process else None)
    for out in outs:
        paths = [ln for ln in out.splitlines() if ln.startswith("[path] ")]
        if not paths:
            raise AssertionError("fed rank: no launch held against its "
                                 "plain version")
        for ln in paths:
            log(ln)
    return want, stacks, ranks, secs


def phase_fed_two_ranks(dev, backend=None, run=None):
    """Phase 10c (b): the reduced model's flat steps over FED_RANKS ranks
    (fresh processes, D split in two; gloo on the one card) against the
    one-process route on the card, for FED_RANK_CASES: every launch of
    each rank and of the one-process run held against the kernel's plain
    version on its own input (the ranks' ``[path]`` lines logged), θ
    within FED_RANK_TOL of max|θ|, Krum's margins above 1e-4, the losses within
    FED_LOSS_TOL, each rank's launches per step the one-process run's,
    and each rank's peak across the aggregate call below its whole
    (K, D) stack (no rank gathers it). ``run``: the results of
    :func:`_fed_two_ranks_spawn` to check, else spawned here over
    ``backend``. Returns the launches of every rank and of the
    one-process runs."""
    import torch
    want, stacks, ranks, secs = run or _fed_two_ranks_spawn(dev, backend)
    totals = {}
    margins = [_krum_gap(x[0], max(FED_K - FED_BYZ - 2, 1))
               for x in stacks]
    if not min(margins) > 1e-4:
        raise AssertionError(f"fed two ranks: Krum margins {margins}")
    for agg, one in want.items():
        for counts in one["launches"]:
            _add(totals, counts)
        theta = torch.cat([r[agg]["theta"] for r in
                           sorted(ranks, key=lambda r: r[agg]["lo"])], dim=1)
        scale = one["theta"].abs().max().item()
        err = (theta - one["theta"]).abs().max().item()
        loss_err = max(abs(a - b) for r in ranks for a, b in
                       zip(r[agg]["losses"], one["losses"]))
        shard = 4 * FED_K * ranks[0][agg]["theta"].shape[1]
        peaks = [p for r in ranks for p in r[agg]["peaks"]]
        for r in ranks:
            if r[agg]["launches"] != one["launches"]:
                raise AssertionError(f"fed two ranks, {agg}: launches "
                                     f"{r[agg]['launches']} vs one process "
                                     f"{one['launches']}")
            for counts in r[agg]["launches"]:
                _add(totals, counts)
        if not (err <= FED_RANK_TOL * scale and loss_err <= FED_LOSS_TOL
                and max(peaks, default=0) < 2 * shard):
            raise AssertionError(f"fed two ranks, {agg}: theta max abs err "
                                 f"{err} (max|theta| {scale}), loss |diff| "
                                 f"{loss_err}, aggregate peaks {peaks} vs "
                                 f"shard {shard} bytes")
        per_step = {k: n for k, n in one["launches"][0].items() if n}
        gaps = (f"; Krum margins {[round(m, 6) for m in margins]}"
                if agg == "krum" else "")
        log(f"[fed] {card()}: fed_two_ranks_{agg} (phase 10c b: reduced "
            f"{FED_ARCH}, D={one['theta'].shape[1]} split over "
            f"{_ranks_on(dev, FED_RANKS, backend)}, K={FED_K}, attack "
            f"{FED_RANK_CASES[agg]}, {FED_RANK_T} steps, sharded=True): "
            f"theta max abs err {err:.3e} = {err / scale:.3e} of "
            f"max|theta| (tol {FED_RANK_TOL}) against the one-process "
            f"route on the card, loss |diff| {loss_err:.3e} (tol "
            f"{FED_LOSS_TOL}), launches per step per rank {per_step} (the "
            f"one-process run's), each rank's peak across the aggregate "
            f"call {peaks} bytes against its (K, D/{FED_RANKS}) shard of "
            f"{shard} bytes{gaps}; the ranks' wall {secs:.1f} s")
    return totals


#: phase 10d: the tree trainer over four gloo ranks on the one card, one
#: ("data", "model") = (2, 2) mesh: (arch, fed_axis, aggregator, attack,
#: steps). With fed_axis "data" K = 2 agents over "data", each leaf split
#: over "model" (RFA without the attack, as in 10c b), coin 1 then 0, each
#: agent's loss and gradient on the rank's blocks; with "all" K = 4, one
#: agent a rank, leaves whole, the coin-1 step only (its steps spend
#: 1.2-1.4 s in host-staged gathers; the PAGE step's reads and memory
#: bound are the "data" cases'); reduced Grok-1 with its fed_axis "pod":
#: K = 1, the rows and the layer stack over "data", the experts over
#: "model", coin 1 then 0
FED_TREE_RANKS = 4
#: an agent's batch rows and tokens
FED_TREE_RANK_B, FED_TREE_RANK_S = 2, 32
FED_TREE_RANK_CASES = (
    ("llama3.2-1b", "data", "mean", "none", 2),
    ("llama3.2-1b", "data", "rfa", "none", 2),
    ("llama3.2-1b", "all", "krum", "large_noise(sigma=10)", 1),
    ("llama3.2-1b", "all", "trimmed_mean", "large_noise(sigma=10)", 1),
    ("grok-1-314b", "pod", "mean", "none", 2))


def _fed_tree_rank_runs(dev, mesh=None, krum_stacks=None):
    """Each FED_TREE_RANK_CASES case's tree steps (coin 1, then 0) of the
    reduced model by :func:`_fed_chain` from the seed-1 init, the draws
    from a generator on ``dev`` seeded 1 after θ₀: through
    ``make_fed_step`` on ``mesh`` (each step from the one-process chain's
    state, placed), or the one-process chain itself. Each step is
    recorded by :func:`_fed_recorder` (peaks after a reset at its start,
    the estimate's peak, launches, v and θ), the cuBLAS workspaces of
    both autograd threads made first (64 MiB, more than this model's
    state); ``krum_stacks`` collects the (K, D) stacks Krum scores.
    Returns {case: those records and the byte counts of
    :func:`_tree_rank_bound`: one field's blocks, its leaves gathered
    whole for a loss, the largest leaf's K rows, whether the estimate ran
    on the rows and blocks and, for each coin, the dry run's
    ``train_gathered_bytes`` of its plan}."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tree import tree_paths
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed import aggregation as agg_lib
    from repro_torch.distributed import fed_trainer as ft
    from repro_torch.distributed.sharding import AbstractMesh, n_agents
    from repro_torch.launch import analysis, dryrun
    shape = AbstractMesh((2, 2), ("data", "model"))
    agg_krum = agg_lib.agg_krum
    w = torch.ones((2, 2), device=dev, requires_grad=True)
    (w @ w).sum().backward()
    del w

    def recorded(tree, n_byz):
        krum_stacks.append(torch.cat([x.reshape(x.shape[0], -1) for _, x in
                                      tree_paths(tree)], dim=1).cpu())
        return agg_krum(tree, n_byz)

    out = {}
    for arch, axis, agg, attack, n_steps in FED_TREE_RANK_CASES:
        cfg = dataclasses.replace(reduced(get_config(arch)), fed_axis=axis)
        K = n_agents(cfg, shape)
        fed = ft.FedConfig(aggregator=agg, **dict(FED_KW, attack=attack))
        pipe = TokenPipeline(DataConfig(cfg.vocab_size, FED_TREE_RANK_S,
                                        FED_TREE_RANK_B, K, seed=1),
                             device=dev)
        mask = torch.arange(K, device=dev) < min(FED_BYZ, K - 1)
        rec = {}
        if krum_stacks is not None:
            agg_lib.agg_krum = recorded
        try:
            _fed_chain(cfg, fed, dev, K, mesh, (True, False)[:n_steps],
                       pipe.batch, mask, 1, _fed_recorder(
                           dev, rec, "_estimate" if mesh is None
                           else "_estimate_placed"))
        finally:
            agg_lib.agg_krum = agg_krum
        _, shapes, bshape, (specs, bspecs, _) = ft.make_fed_step(
            cfg, fed, shape, large=True, per_agent_batch=FED_TREE_RANK_B,
            seq_len=FED_TREE_RANK_S)
        whole = dict(tree_paths(shapes.params))
        field = gathered = rows = 0
        for path, blk, _ in rec["theta"][-1]:
            field += blk.nbytes
            rows = max(rows, K * blk[0].nbytes)
            if blk.shape[1:] != whole[path].shape[1:]:
                gathered += 4 * math.prod(whole[path].shape[1:])
        plan = analysis.estimate_plan(cfg, shape, shapes, specs, bshape,
                                      bspecs)
        grads = sum(math.prod(leaf.block[1:]) * leaf.itemsize
                    for leaf in (analysis.Leaf.of(t, sp, shape) for
                                 (_, t), (_, sp) in zip(
                                     tree_paths(shapes.params),
                                     tree_paths(specs.params))))
        rec.update(K=K, attack=attack, field=field, gathered=gathered,
                   rows=rows, blocks_route=bool(plan), lr=fed.lr,
                   reckoned={c: dryrun.train_gathered_bytes(
                       plan, grads * (1 if c else 2)) for c in (True, False)},
                   D=sum(math.prod(x.shape[1:]) for x in whole.values()))
        out[arch, axis, agg] = rec
    return out


#: the ranks' aggregated directions v against the one-process step's
#: from the same state: a rounding bound of max|v| (the blocks sum the
#: partial products of a split leaf, and a split batch's rows, in another
#: order than the whole leaf and batch)
FED_BLOCK_V_TOL = 1e-5
#: where Adam's update is not clear of v's rounding (below), θ within
#: this many lr: two updates of opposite sign, each at most 1.45·lr at
#: Adam's steps 1 and 2 (|m̂|/√v̂ with the bias corrections)
FED_ADAM_FLIP_LR = 3.0


def _fed_step_gaps(one, recs, t, lr, b2=0.999, dev=None):
    """The ranks' step ``t`` (their records ``recs``) against the
    one-process chain's (``one``), from the same state and draws,
    computed on ``dev`` (None: where the records lie): v's
    largest gap over max|v|; θ's largest gap over max|θ| on the entries
    whose Adam update is clear of v's rounding, and elsewhere over lr,
    with the count of those entries beyond FED_CPU_TOL of max|θ|; the
    losses' largest gap. An entry is
    clear where √v̂ (Adam's bias-corrected second moment after the step,
    at its step t + 1) is at least 2·lr·FED_BLOCK_V_TOL·max|v| /
    (FED_CPU_TOL·max|θ|): there a rounding of v within FED_BLOCK_V_TOL of
    max|v| moves lr·m̂/(√v̂ + eps) by at most half of FED_CPU_TOL·max|θ|;
    elsewhere (a gradient entry within its rounding of zero, whose first
    Adam update is lr times its sign) it may move θ by up to
    FED_ADAM_FLIP_LR·lr."""
    import torch

    def on(x):
        return x if dev is None else x.to(dev)
    wv = {p: on(x) for p, x, _ in one["v"][t]}
    wt = {p: on(x) for p, x, _ in one["theta"][t]}
    wa = {p: on(x) for p, x, _ in one["adam_v"][t]}
    v_scale = max(x.abs().max().item() for x in wv.values())
    th_scale = max(x.abs().max().item() for x in wt.values())
    thr = 2 * lr * FED_BLOCK_V_TOL * v_scale / (FED_CPU_TOL * th_scale)
    bc2 = 1 - b2 ** (t + 1)
    v_err = clear = other = 0.0
    n_other = 0
    for rec in recs:
        for p, blk, idx in rec["v"][t]:
            w = wv[p] if idx is None else wv[p][idx]
            v_err = max(v_err, (on(blk) - w).abs().max().item())
        for p, blk, idx in rec["theta"][t]:
            w = wt[p] if idx is None else wt[p][idx]
            a = wa[p] if idx is None else wa[p][idx]
            gap = (on(blk) - w).abs()
            ok = torch.sqrt(a / bc2) >= thr
            if ok.any():
                clear = max(clear, gap[ok].max().item())
            if not ok.all():
                other = max(other, gap[~ok].max().item())
                n_other += int((gap[~ok] > FED_CPU_TOL * th_scale).sum())
    return {"v": v_err / v_scale, "theta": clear / th_scale,
            "theta_lr": other / lr, "n_other": n_other,
            "loss": max(abs(r["losses"][t] - one["losses"][t])
                        for r in recs)}


def _fed_gaps_ok(g) -> bool:
    return (g["v"] <= FED_BLOCK_V_TOL and g["theta"] <= FED_CPU_TOL
            and g["theta_lr"] <= FED_ADAM_FLIP_LR
            and g["loss"] <= FED_LOSS_TOL)


def _fed_gaps_text(g) -> str:
    return (f"v max abs err {g['v']:.3e} of max|v| (tol {FED_BLOCK_V_TOL}), "
            f"theta {g['theta']:.3e} of max|theta| where Adam's update is "
            f"clear of v's rounding (tol {FED_CPU_TOL}), {g['theta_lr']:.3e} "
            f"lr where it is not ({g['n_other']} entries beyond "
            f"{FED_CPU_TOL} of max|theta|; tol {FED_ADAM_FLIP_LR}), loss "
            f"|diff| {g['loss']:.3e} (tol "
            f"{FED_LOSS_TOL})")


def _tree_rank_bound(rank: dict, large: bool, act: int = 0,
                     estimate_only: bool = False) -> int:
    """The most a rank of phase 10d may allocate across a step above its
    start, from its own byte counts (``_fed_tree_rank_runs``): its
    estimate holds its block of the directions and, on its rows and
    blocks, the dry run's ``train_gathered_bytes`` of its plan (its
    gradient blocks, one layer's gathered leaves and their gradients, the
    largest all-gather) and ``act``, the one-process estimate's
    activations; where nothing splits an agent's leaves or rows, the
    agent's whole gradients (one, or two on a PAGE step); after the
    estimate it holds at most seven fields at its block (the directions,
    their attacked copy, the aggregate, Adam's two new moments and new
    parameters, one agreement round's mix); the larger of the two, plus
    one leaf's K rows gathered for the aggregation. W is one agent's
    whole leaves, 4 D bytes. ``estimate_only``: the estimate's term
    alone (with ``blocks_route`` False, the whole-leaf route's: the
    fields its loss reads gathered whole and the whole gradients)."""
    w = 4 * rank["D"]
    if rank["blocks_route"]:
        estimate = rank["field"] + rank["reckoned"][large] + act
    else:
        reads, grads = (1, 1) if large else (3, 2)
        estimate = rank["field"] + reads * rank["gathered"] + grads * w
    if estimate_only:
        return estimate
    return max(estimate, 7 * rank["field"]) + rank["rows"]


def fed_tree_rank_main(argv) -> int:
    """``chip_smoke.py --fed-tree-rank RANK WORLD PORT OUT DEVICE``: one
    rank of phase 10d, joined on localhost:PORT (:func:`_join_rank`), on
    its card (DEVICE ``cuda``) or the CPU, on a ("data", "model") = (2, 2)
    mesh; writes its results to OUT."""
    rank, world, port, dst, where = argv
    dev = _join_rank(rank, world, port, where)
    import torch
    from repro_torch.launch.mesh import make_debug_mesh
    try:
        mesh = make_debug_mesh(2, 2, device_type=dev.type)
        torch.save(_fed_tree_rank_runs(dev, mesh), dst)
    finally:
        _leave_rank()
    return 0


def phase_fed_tree_ranks(dev):
    """Phase 10d: the tree trainer over FED_TREE_RANKS gloo ranks on the
    one card (fresh processes, one process group for every case), each
    case of FED_TREE_RANK_CASES through ``make_fed_step`` on the (2, 2)
    mesh against the one-process ``fed_train_step`` on the card from the
    same init and draws: where nothing splits an agent's leaves or rows
    ("all"), every rank's parameter blocks within FED_RANK_TOL of max|θ|;
    on the rows and blocks ("data", "pod"), within FED_CPU_TOL (the
    blocks sum in another order, and Adam's first step from the common
    init turns a rounding of a gradient entry near its eps into a share
    of lr); the losses within FED_LOSS_TOL, Krum's margins above 1e-4, no
    kernel launch, and what each rank allocates across a step above its
    start (its peak less its resident blocks, batch and cuBLAS
    workspaces) within :func:`_tree_rank_bound`, the activations those of
    the one-process estimate (its peak above the step's start less its
    whole directions and gradients). Where nothing is split, the bound
    must lie below the rank's reading plus one whole field of the stack
    (K agents' whole leaves, 4 K D bytes), so a rank that gathered a
    field would cross it; on the rows and blocks, its estimate term must
    lie at least one agent's whole leaves below the whole-leaf route's
    (:func:`_tree_rank_bound` with ``estimate_only``, neither counting
    the activations). The one-process
    step's allocation above its start is logged beside it.
    On the CPU (a rehearsal) no allocation is read."""
    stacks = []
    want, ranks, _, secs = _run_ranks(
        "--fed-tree-rank", FED_TREE_RANKS, dev.type,
        parent=lambda: _fed_tree_rank_runs(dev, krum_stacks=stacks))
    margins = [_krum_gap(x, max(FED_K - FED_BYZ - 2, 1)) for x in stacks]
    if not min(margins) > 1e-4:
        raise AssertionError(f"fed tree ranks: Krum margins {margins}")
    for key, one in want.items():
        arch, axis, agg = key
        recs = [r[key] for r in ranks]
        n = len(one["losses"])
        blocks_route = recs[0]["blocks_route"]
        if blocks_route:
            gaps = [_fed_step_gaps(one, recs, t, one["lr"]) for t in range(n)]
            close = all(_fed_gaps_ok(g) for g in gaps)
            text = "; ".join(f"step {t}: {_fed_gaps_text(g)}"
                             for t, g in enumerate(gaps))
        else:
            whole = {p: x for p, x, _ in one["theta"][-1]}
            scale = max(x.abs().max().item() for x in whole.values())
            err = max((blk - whole[p][idx]).abs().max().item()
                      for r in recs for p, blk, idx in r["theta"][-1])
            loss_err = max(abs(a - b) for r in recs for a, b in
                           zip(r["losses"], one["losses"]))
            close = err <= FED_RANK_TOL * scale and loss_err <= FED_LOSS_TOL
            text = (f"theta max abs err {err:.3e} = {err / scale:.3e} of "
                    f"max|theta| (tol {FED_RANK_TOL}), loss |diff| "
                    f"{loss_err:.3e} (tol {FED_LOSS_TOL})")
        launches = [c for r in [one, *recs] for c in r["launches"]
                    if any(c.values())]
        stack = 4 * one["K"] * one["D"]
        w = 4 * one["D"]
        peaks = [p for r in recs for p in r["peaks"]]
        above = [p - b for r in recs for p, b in zip(r["peaks"],
                                                     r["starts"])]
        act = [max(one["est_peaks"][t] - one["starts"][t]
                   - (one["K"] + (1 if t == 0 else 2)) * w, 0)
               for t in range(n)]
        bounds = [_tree_rank_bound(r, t == 0, act[t]) for r in recs
                  for t in range(n)]
        one_above = [p - b for p, b in zip(one["peaks"], one["starts"])]
        if blocks_route:
            # the estimate's term at least one agent's whole leaves below
            # the whole-leaf route's (its gathered leaves and gradients)
            # (reckonings compared alike: neither counts the activations)
            tight = all(
                _tree_rank_bound(r, t == 0, estimate_only=True) + w
                <= _tree_rank_bound(dict(r, blocks_route=False), t == 0,
                                    estimate_only=True)
                for r in recs for t in range(n))
            memory = dev.type != "cuda" or (tight and all(
                a <= b for a, b in zip(above, bounds)))
        else:
            memory = dev.type != "cuda" or all(
                a <= b < a + stack for a, b in zip(above, bounds))
        if not (close and not launches and memory):
            raise AssertionError(
                f"fed tree ranks, {arch}/{axis}/{agg}: {text}, launches "
                f"{launches}, step peaks {peaks}, above their starts "
                f"{above} against the bounds {bounds} (each must lie below "
                f"its reading plus one field of the stack, {stack} bytes)")
        krum = (f"; Krum margins {[round(m, 6) for m in margins]}"
                if agg == "krum" else "")
        ms = [[round(x, 3) for x in r["ms"]] for r in recs]
        route = ("on each rank's rows and blocks" if blocks_route
                 else "plain")
        est = [p - b for r in recs for p, b in zip(r["est_peaks"],
                                                   r["starts"])]
        log(f"[fed] {card()}: fed_tree_ranks_{axis}_{agg} (phase 10d: "
            f"reduced {arch}, D={one['D']}, fed_axis {axis}, K="
            f"{one['K']} over {FED_TREE_RANKS} gloo ranks on the one card, "
            f"(data, model) = (2, 2), attack {one['attack']}, {n} step(s) "
            f"through make_fed_step, each from the one-process chain's "
            f"state, the estimate {route}): {text} against the "
            f"one-process tree step on the card, 0 kernel launches, each "
            f"rank's allocation across a step above its start {above} "
            f"bytes (peaks {peaks}; across the estimate {est}) within the "
            f"bounds {bounds}, each below its reading plus one field of "
            f"the stack ({stack}); the one-process step's {one_above}, its "
            f"estimate's activations {act}; ms/step per rank {ms}, one "
            f"process {[round(x, 3) for x in one['ms']]}{krum}; the ranks' "
            f"wall {secs:.1f} s")


#: phases 10e and 10f: the tree trainer's step at a model's full width
#: cut to FED_LAYERS layers (f32) over two gloo ranks on the card, (data,
#: model) = (1, 2), K = 1, every leaf a column, row or vocabulary block
#: (the norms, MLA's w_dq and w_dkv whole), none gathered; FED_BATCH x
#: FED_SEQ tokens; the coin-1 step, then coin 0. 10e: Llama-3.2-1B (phase
#: 10's model, D = FED_D, fed_axis "data"); 10f: MiniCPM3-4B (D =
#: 501,404,160, fed_axis "pod"): MLA on 20 of the 40 heads through w_dq ->
#: w_uq, 3200 of the 6400 d_ff columns and 36,724 vocabulary rows a rank
FED_BLOCK_ARCHS = {"10e": FED_ARCH, "10f": "minicpm3-4b"}
FED_BLOCK_MESH = (1, 2)
FED_BLOCK_KW = dict(aggregator="mean", attack="none", n_byz=0, kappa=1,
                    lr=1e-3)
#: what a rank may allocate beyond its reckoning: cuBLAS's workspaces,
#: made once a process, and the allocator's rounding
FED_BLOCK_SLACK = 64 << 20


def _fed_blocks_of(tree) -> list:
    """(path, the rank's block on the host, its index) of a tree."""
    from repro_torch.carriers import placed
    from repro_torch.core.tree import tree_paths
    return [(p, placed.local(x).cpu(), None if placed.layout(x) is None
             else placed.layout(x).index()) for p, x in tree_paths(tree)]


def _fed_chain(cfg, fed, dev, K, mesh, coins, batch_of, mask, seed,
               record):
    """The steps of ``coins`` from the common init (``seed``), each from
    the one-process chain's state: on one process (``mesh`` None) the
    chain itself; on a rank, each step through ``make_fed_step`` on
    ``mesh`` from that state placed, then the one-process step that
    carries the chain on (not recorded). Every process draws θ₀ and each
    step's noise from one generator on ``dev`` in the same order, so a
    rank's step and the one-process step start from the same state and
    draws. ``record(t, run)`` runs a step and records it."""
    from repro_torch.core.engine import seed_generator
    from repro_torch.distributed import fed_trainer as ft
    gen = seed_generator(seed, dev)
    state = ft.init_fed_state(cfg, fed, K, gen, device=dev)
    n_byz = int(mask.sum())
    if mesh is not None:
        steps = {c: ft.make_fed_step(cfg, fed, mesh, large=c)[0]
                 for c in set(coins)}
    for t, coin in enumerate(coins):
        nz = ft.fed_noise(gen, fed, state, n_byz)
        batch = batch_of(t)
        if mesh is None:
            state, _ = record(t, lambda: ft.fed_train_step(
                cfg, fed, state, batch, mask, nz, large=coin))
            continue
        placed_state = ft.place_fed_state(state, mesh, cfg)
        record(t, lambda: steps[coin](placed_state, batch, mask, nz))
        del placed_state
        if t + 1 < len(coins):
            state, _ = ft.fed_train_step(cfg, fed, state, batch, mask, nz,
                                         large=coin)


def _fed_recorder(dev, rec, estimate_name):
    """``record(t, run)`` for :func:`_fed_chain`: runs the step with the
    peak reset at its start, recording its ms, loss, the bytes allocated
    at its start, its peak across the estimate (``estimate_name``, the
    fed trainer's function, wrapped) and across the step, its launches
    and its v and θ blocks (and, for the one-process chain's
    ``"_estimate"``, Adam's second moment)."""
    import torch
    from repro_torch.distributed import fed_trainer as ft
    from repro_torch.kernels import dispatch
    cuda = dev.type == "cuda"
    for k in ("ms", "losses", "starts", "est_peaks", "peaks", "launches",
              "v", "theta", "adam_v"):
        rec.setdefault(k, [])

    def record(t, run):
        est = getattr(ft, estimate_name)

        def measured(*args, **kw):
            out = est(*args, **kw)
            if cuda:
                torch.cuda.synchronize()
            rec["est_peaks"].append(torch.cuda.max_memory_allocated()
                                    if cuda else 0)
            return out

        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        rec["starts"].append(torch.cuda.memory_allocated() if cuda else 0)
        dispatch.reset_launches()
        setattr(ft, estimate_name, measured)
        try:
            t0 = time.perf_counter()
            state, m = run()
            if cuda:
                torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
        finally:
            setattr(ft, estimate_name, est)
        rec["peaks"].append(torch.cuda.max_memory_allocated() if cuda
                            else 0)
        rec["launches"].append(dispatch.launch_counts())
        rec["losses"].append(m["loss"].item())
        rec["v"].append(_fed_blocks_of(state.v))
        rec["theta"].append(_fed_blocks_of(state.params))
        if estimate_name == "_estimate":
            rec["adam_v"].append(_fed_blocks_of(state.opt_state.v))
        return state, m

    return record


def _fed_block_cfg(phase):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(FED_BLOCK_ARCHS[phase]),
                               n_layers=FED_LAYERS)


def _fed_block_run(dev, phase, mesh=None):
    """Phase 10e's or 10f's two steps (K = 1, coins 1 then 0) of
    :func:`_fed_chain`, on one process (``mesh`` None) or this rank's
    blocks of ``mesh``, recorded by :func:`_fed_recorder`; then the
    rank's byte counts."""
    import math
    import torch
    from repro_torch.core.tree import tree_paths
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed import fed_trainer as ft
    cfg = _fed_block_cfg(phase)
    fed = ft.FedConfig(**FED_BLOCK_KW)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, FED_SEQ, FED_BATCH, 1,
                                    seed=FED_SEED), device=dev)
    mask = torch.zeros((1,), dtype=torch.bool, device=dev)
    w = torch.ones((2, 2), device=dev, requires_grad=True)
    (w @ w).sum().backward()             # cuBLAS's workspaces, made once
    del w
    rec = {}
    _fed_chain(cfg, fed, dev, 1, mesh, (True, False), pipe.batch, mask,
               FED_SEED, _fed_recorder(dev, rec, "_estimate_placed"
                                       if mesh is not None else
                                       "_estimate"))
    shapes = dict(tree_paths(ft.init_fed_state(cfg, fed, 1, 0,
                                                device="meta").params))
    field = largest = gathered = 0
    for path, blk, _ in rec["theta"][-1]:
        field += blk.nbytes
        largest = max(largest, blk.nbytes)
        if blk.shape[1:] != shapes[path].shape[1:]:
            gathered += 4 * math.prod(shapes[path].shape[1:])
    rec.update(field=field, largest=largest, gathered=gathered,
               whole=4 * sum(math.prod(x.shape[1:])
                             for x in shapes.values()))
    return rec


def fed_block_rank_main(argv) -> int:
    """``chip_smoke.py --fed-block-rank RANK WORLD PORT OUT DEVICE PHASE``:
    one rank of phase PHASE (10e or 10f), joined on localhost:PORT
    (:func:`_join_rank`), on its card (DEVICE ``cuda``) or the CPU, on the
    FED_BLOCK_MESH mesh; writes its results to OUT."""
    rank, world, port, dst, where, phase = argv
    dev = _join_rank(rank, world, port, where)
    import torch
    from repro_torch.launch.mesh import make_debug_mesh
    try:
        mesh = make_debug_mesh(*FED_BLOCK_MESH, device_type=dev.type)
        torch.save(_fed_block_run(dev, phase, mesh), dst)
    finally:
        _leave_rank()
    return 0


def _fed_block_reckoning(phase, large: bool) -> dict:
    """Phase 10e's or 10f's rank as the dry run reckons it
    (``AbstractMesh`` of FED_BLOCK_MESH, f32): the estimate's plan, its
    largest gather and ``train_gathered_bytes`` of one step of the coin
    (one agent's gradient blocks, two on a PAGE step)."""
    import math
    import torch
    from repro_torch.core.tree import tree_paths
    from repro_torch.distributed import fed_trainer as ft
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.launch import analysis, dryrun
    cfg = _fed_block_cfg(phase)
    mesh = AbstractMesh(FED_BLOCK_MESH, ("data", "model"))
    _, shape, batch, (specs, batch_sh, _) = ft.make_fed_step(
        cfg, ft.FedConfig(**FED_BLOCK_KW), mesh, large=True,
        dtype=torch.float32, per_agent_batch=FED_BATCH, seq_len=FED_SEQ)
    plan = analysis.estimate_plan(cfg, mesh, shape, specs, batch, batch_sh)
    grads = sum(math.prod(leaf.block[1:]) * leaf.itemsize for leaf in (
        analysis.Leaf.of(t, s, mesh) for (_, t), (_, s) in zip(
            tree_paths(shape.params), tree_paths(specs.params))))
    return {"plan": plan, "big": max((b for _, b, _ in plan), default=0),
            "whole": [path for (kind, path), _, _ in plan
                      if kind == "whole"],
            "gathered": dryrun.train_gathered_bytes(
                plan, grads * (1 if large else 2))}


def phase_fed_blocks(dev, phase, backend=None, run=None):
    """Phase 10e (Llama-3.2-1B, D = FED_D) or 10f (MiniCPM3-4B, MLA on
    blocks of its heads): the tree trainer's step on each rank's blocks
    at the model's full width (FED_LAYERS layers, f32), over two ranks
    (fresh processes, one group; gloo on the one card), (data, model) =
    (1, 2), K = 1, the coin-1 step then the coin-0 step, against
    the one-process ``fed_train_step`` on the card from the same init and
    batches: each rank's v blocks within FED_CPU_V_TOL of max|v| and its
    θ blocks within FED_CPU_TOL of max|θ| (phase 10's card-vs-CPU
    tolerances: the blocks sum in another order, and Adam's first step
    from the common init turns a rounding of a gradient entry near its
    eps into a share of lr, which the PAGE step's gradients then read),
    the losses within FED_LOSS_TOL,
    the two ranks' losses bit-identical, no kernel launch, no leaf
    gathered whole (the dry run's plan). Each rank's allocation across
    each estimate above the step's start within its reckoning: its
    direction blocks, ``train_gathered_bytes`` (its gradient blocks, one
    layer's gathered leaves and their gradients, the largest all-gather)
    and the one-process estimate's activations, plus FED_BLOCK_SLACK;
    its reckoning (without the activations) lies at least one agent's
    whole leaves below the estimate's term of :func:`_tree_rank_bound`
    for the same rank (which counts none either). Each rank's step
    allocation and max_memory_allocated (which also holds the one-process
    chain's whole state that the rank carries) are logged beside the
    card's name and power limit. ``run``: the results of
    :func:`_fed_blocks_spawn` to check, else spawned here over
    ``backend``."""
    import torch
    torch.cuda.empty_cache()
    one, ranks, secs = run or _fed_blocks_spawn(dev, phase, backend)
    torch.cuda.empty_cache()
    return _fed_block_check(phase, one, ranks, secs, dev, backend)


def _fed_blocks_spawn(dev, phase, backend=None, one_process=True):
    """Phase 10e's or 10f's ranks (``backend`` as :func:`_join_rank`
    takes it), with the one-process run here meanwhile unless not
    ``one_process``: (its results, the ranks' results, their wall
    seconds)."""
    world = FED_BLOCK_MESH[0] * FED_BLOCK_MESH[1]
    one, ranks, _, secs = _run_ranks(
        "--fed-block-rank", world, _rank_where(dev, backend), (phase,),
        parent=(lambda: _fed_block_run(dev, phase)) if one_process
        else None)
    return one, ranks, secs


def _fed_block_check(phase, one, ranks, secs, dev, backend=None):
    """Phase 10e's or 10f's comparisons (:func:`phase_fed_blocks`); logs
    them."""
    bad, lines = [], []
    cuda = dev.type == "cuda"
    W = ranks[0]["whole"]
    lr = FED_BLOCK_KW["lr"]
    gb = 2 ** 30
    for t in range(2):
        large = t == 0
        rk = _fed_block_reckoning(phase, large)
        if rk["whole"]:
            bad.append(f"the plan gathers leaves whole: {rk['whole']}")
        g = _fed_step_gaps(one, ranks, t, lr, dev=dev)
        if not _fed_gaps_ok(g):
            bad.append(f"step {t}: {_fed_gaps_text(g)}")
        if any(r["losses"][t] != ranks[0]["losses"][t] for r in ranks):
            bad.append(f"step {t}: the ranks' losses differ")
        if any(any(r["launches"][t].values()) for r in [one, *ranks]):
            bad.append(f"step {t}: kernel launches")
        # the one-process estimate's activations: its peak above the
        # step's start less its whole directions and gradients
        grads = 1 if large else 2
        act = max(one["est_peaks"][t] - one["starts"][t] - (1 + grads) * W,
                  0)
        est = [r["est_peaks"][t] - r["starts"][t] for r in ranks]
        step = [r["peaks"][t] - r["starts"][t] for r in ranks]
        bound = ranks[0]["field"] + rk["gathered"] + act + FED_BLOCK_SLACK
        # _tree_rank_bound's estimate term for the same rank: its
        # direction blocks, the fields its loss read gathered whole and
        # the agent's whole gradients
        old = ranks[0]["field"] + (1 if large else 3) \
            * ranks[0]["gathered"] + grads * W
        if cuda and not (max(est) <= bound
                         and bound - act - FED_BLOCK_SLACK + W <= old):
            bad.append(f"step {t}: estimate allocations {est} against "
                       f"the bound {bound} (the present estimate term "
                       f"{old}, one agent {W})")
        lines.append(
            f"[fed] {card()}: fed_blocks {phase} step {t} (coin "
            f"{int(large)}, from "
            f"the one-process chain's state): {_fed_gaps_text(g)}; ms/step "
            f"per rank {[round(r['ms'][t], 3) for r in ranks]}, one "
            f"process {one['ms'][t]:.3f}; each rank's allocation above "
            f"the step's start across the estimate "
            f"{[round(x / gb, 3) for x in est]} GiB within the bound "
            f"{bound / gb:.3f} GiB (its direction blocks "
            f"{ranks[0]['field'] / gb:.3f}, train_gathered_bytes "
            f"{rk['gathered'] / gb:.3f} with the largest all-gather "
            f"{rk['big'] / 2**20:.3f} MiB, the one-process activations "
            f"{act / gb:.3f}, slack {FED_BLOCK_SLACK >> 20} MiB), the "
            f"present estimate term {old / gb:.3f} GiB, one agent's whole "
            f"leaves {W / gb:.3f} GiB; across the whole step "
            f"{[round(x / gb, 3) for x in step]} GiB (one process "
            f"{(one['peaks'][t] - one['starts'][t]) / gb:.3f}); "
            f"max_memory_allocated per rank "
            f"{[round(r['peaks'][t] / gb, 3) for r in ranks]} GiB (at "
            f"the step's start "
            f"{[round(r['starts'][t] / gb, 3) for r in ranks]} GiB: the "
            f"rank's blocks and the one-process chain's whole state it "
            f"carries), one process {one['peaks'][t] / gb:.3f} GiB")
    lines.append(f"[fed] {card()}: fed_blocks (phase {phase}: "
                 f"{FED_BLOCK_ARCHS[phase]} full width, {FED_LAYERS} layers, "
                 f"D={ranks[0]['whole'] // 4}, K=1 over "
                 f"{_ranks_on(dev, len(ranks), backend)}, (data, model) = "
                 f"{FED_BLOCK_MESH}, {FED_BATCH} x {FED_SEQ} tokens, coins "
                 f"1 then 0); the ranks' wall {secs:.1f} s")
    for line in lines:
        log(line)
    if bad:
        raise AssertionError(f"fed blocks {phase}: {bad}")


def phase_fed_tree_vs_flat(dev):
    """The reference's invariant at full width: with ``mean`` and attack
    ``none`` the tree and flat trainers take the same step from the same
    init and batch (coin 1): honest losses within FED_TREE_FLAT_TOL and
    the raveled θ within FED_TREE_FLAT_TOL of max|θ|, run one after the
    other (both states do not fit beside each other)."""
    import torch
    from repro_torch.core.tree import ravel_tree, tree_map
    from repro_torch.distributed.fed_trainer import (FedConfig,
                                                     fed_train_step,
                                                     fed_train_step_flat,
                                                     init_fed_state,
                                                     init_flat_fed_state)
    cfg = _fed_cfg()
    fed = FedConfig(aggregator="mean", **dict(FED_KW, attack="none"))
    batch = _fed_pipe(cfg, dev).batch(0)
    mask = torch.arange(FED_K, device=dev) < FED_BYZ
    state = init_fed_state(cfg, fed, FED_K, FED_SEED, device=dev)
    state, tm = fed_train_step(cfg, fed, state, batch, mask, large=True)
    tree_theta = torch.stack([
        ravel_tree(tree_map(lambda leaf: leaf[k], state.params)).cpu()
        for k in range(FED_K)])
    del state
    torch.cuda.empty_cache()
    fstate, unravel = init_flat_fed_state(cfg, fed, FED_K, FED_SEED,
                                          device=dev)
    fstate, fm = fed_train_step_flat(cfg, fed, fstate, unravel, batch, mask,
                                     large=True)
    scale = fstate.theta.abs().max().item()
    err = max((fstate.theta[k].cpu() - tree_theta[k]).abs().max().item()
              for k in range(FED_K))
    loss_err = abs(tm["loss"].item() - fm["loss"].item())
    del fstate, tree_theta
    torch.cuda.empty_cache()
    if not (err <= FED_TREE_FLAT_TOL * scale and loss_err <= FED_LOSS_TOL):
        raise AssertionError(f"tree vs flat at full width: theta max abs "
                             f"err {err} (max|theta| {scale}), loss |diff| "
                             f"{loss_err}: over {FED_TREE_FLAT_TOL}")
    log(f"[fed] {card()}: tree vs flat trainer at full width (mean, no "
        f"attack, coin 1): honest loss {tm['loss'].item():.6f} vs "
        f"{fm['loss'].item():.6f} (|diff| {loss_err:.3e}), raveled theta "
        f"max abs err {err:.3e} = {err / scale:.3e} of max|theta| "
        f"{scale:.6f} (tol {FED_TREE_FLAT_TOL} of max|theta| and "
        f"{FED_LOSS_TOL} on the loss)")


def phase_fed_cpu_agreement(dev):
    """The card against the CPU: reduced Llama (2 layers, d 256), K = 4,
    n_byz = 1 ``large_noise(sigma=10)``, 2 steps (coin 1 then 0) of the
    tree trainer (fed trimmed_mean) and of the flat trainer (the
    trimmed_mean kernel) from the same weights and noise: the aggregated
    direction v within FED_CPU_V_TOL of max|v| (on the PAGE step v sums
    g_new − g_old, which cancel to well under the gradients' size),
    θ within FED_CPU_TOL of max|θ|, losses within 1e-5.

    The trimmed mean because it is conditioned per coordinate: RFA's
    weights come from the Gram identity, whose rounding at the σ = 10
    row (‖x‖² ≈ 100·D) exceeds the honest rows' distances, so its honest
    weights differ between any two summation orders. θ's tolerance is
    wider than v's: Adam's update lr·m̂/(√v̂ + 1e-8) turns a rounding
    difference in a coordinate whose aggregate is near 1e-8 into a share
    of lr; a wrong route would move θ by about lr = 1e-3.

    One run has read θ 3.49e-4 of max|θ| here, where every other read
    7.325e-05; which side moved is not known (``tools/fed_cpu_repeat.py``
    repeats each side to look for it; :func:`phase_fed_cpu_repeat` reads
    the tree trainer again at the end of phase 10). Returns the tree
    trainer's CPU θ, its card θ and the reading (θ's gap over max|θ|)."""
    tree = None
    for flat in (False, True):
        cpu_theta, cpu_vs, cpu_losses = fed_two_steps("cpu", flat)
        gpu_theta, gpu_vs, gpu_losses = fed_two_steps(dev, flat)
        loss_err = max(abs(a - b) for a, b in zip(cpu_losses, gpu_losses))
        v_err = max(e / v_scale for e, v_scale in
                    (tree_gap(a, b) for a, b in zip(cpu_vs, gpu_vs)))
        err, scale = tree_gap(cpu_theta, gpu_theta)
        label = ("flat (the trimmed_mean kernel)" if flat
                 else "tree (fed trimmed_mean)")
        if not (v_err <= FED_CPU_V_TOL and err <= FED_CPU_TOL * scale
                and loss_err <= 1e-5):
            raise AssertionError(f"fed card vs CPU, {label}: v gap {v_err} "
                                 f"of max|v|, theta max abs err {err} (max "
                                 f"{scale}), loss |diff| {loss_err}")
        log(f"[check] {card()}: card vs CPU, fed {label} (reduced "
            f"{FED_ARCH}, K={FED_K}, 2 steps): v max abs err "
            f"{v_err:.3e} of max|v| (tol {FED_CPU_V_TOL}), theta max abs "
            f"err {err:.3e} = {err / scale:.3e} of max|theta| (tol "
            f"{FED_CPU_TOL}), loss |diff| {loss_err:.3e} (tol 1e-5)")
        if not flat:
            tree = (cpu_theta, gpu_theta, err / scale)
    return tree


def phase_fed_cpu_repeat(dev, tree):
    """The tree trainer's card-vs-CPU θ check again, at the end of phase
    10 (after its full-width states, the ranks and the CLI, with the
    allocator's cache as they left it), against the same CPU θ: both
    readings printed, the card's two θ compared bit for bit, and the
    same tolerance held."""
    import torch
    cpu_theta, first_theta, first = tree
    reserved = torch.cuda.memory_reserved()
    gpu_theta, _, _ = fed_two_steps(dev, False)
    err, scale = tree_gap(cpu_theta, gpu_theta)
    same = tree_gap(first_theta, gpu_theta)[0] == 0.0
    log(f"[check] {card()}: card vs CPU, fed tree (fed trimmed_mean) at "
        f"the end of phase 10, the allocator holding {reserved / 2**30:.3f} "
        f"GiB: theta max abs err {err:.3e} = {err / scale:.3e} of "
        f"max|theta| (the first reading {first:.3e}; tol {FED_CPU_TOL}); "
        f"the card's two theta {'bit-equal' if same else 'DIFFER'}")
    if not err <= FED_CPU_TOL * scale:
        raise AssertionError(f"fed card vs CPU, tree, at the end of phase "
                             f"10: theta max abs err {err} (max {scale}); "
                             f"the first reading {first} of max|theta|")


def fed_two_steps(dev, flat: bool):
    """One side of ``phase_fed_cpu_agreement``: the reduced model's 2 steps
    on ``dev`` from the CPU's weights and noise. Returns θ (the flat
    stack, or the params tree), each step's v and each step's loss, all
    on the CPU."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tree import tree_map
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed import fed_trainer as ft
    cfg = reduced(get_config(FED_ARCH))
    fed = ft.FedConfig(aggregator="trimmed_mean", **FED_KW)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 32, 2, FED_K, seed=1),
                         device="cpu")
    mask = (torch.arange(FED_K) < FED_BYZ).to(dev)
    if flat:
        state, unravel = ft.init_flat_fed_state(cfg, fed, FED_K, 1,
                                                device="cpu")
    else:
        state = ft.init_fed_state(cfg, fed, FED_K, 1, device="cpu")
    state = tree_map(lambda x: x.to(dev), state)
    gen = torch.Generator()
    gen.manual_seed(2)
    vs, losses = [], []
    for t, coin in enumerate((True, False)):
        nz = ft.fed_noise(gen, fed, state, FED_BYZ)
        nz = type(nz)(*(None if x is None else x.to(dev) for x in nz))
        b = {k: v.to(dev) for k, v in pipe.batch(t).items()}
        if flat:
            state, m = ft.fed_train_step_flat(cfg, fed, state, unravel, b,
                                              mask, nz, large=coin)
        else:
            state, m = ft.fed_train_step(cfg, fed, state, b, mask, nz,
                                         large=coin)
        vs.append(tree_map(lambda x: x.cpu(), state.v))
        losses.append(m["loss"].item())
    theta = tree_map(lambda x: x.cpu(),
                     state.theta if flat else state.params)
    return theta, vs, losses


def tree_gap(a_tree, b_tree):
    """max |b − a| over the leaves of two trees, and max |a|."""
    from repro_torch.core.tree import tree_paths
    pairs = list(zip(tree_paths(a_tree), tree_paths(b_tree)))
    scale = max(a.abs().max().item() for (_, a), _ in pairs)
    err = max((b - a).abs().max().item() for (_, a), (_, b) in pairs)
    return err, scale


def phase_fed_cli(dev):
    """``python -m repro_torch.launch.train`` in fresh processes on the
    card, windowed and ``--no-fused``, both started at once: exit 0, one
    ``fed`` record per step in ``metrics.jsonl``, a manifest, and a
    checkpoint that restores to agent 0's θ of the same run repeated in
    this process (bit for bit) while they run."""
    import os
    import tempfile
    import torch
    from repro_torch.checkpoint import restore
    from repro_torch.core.tree import tree_paths
    from repro_torch.launch import train
    steps = 6
    base = ["--arch", FED_ARCH, "--reduced", "--agents", "4", "--byz", "1",
            "--attack", "large_noise(sigma=10)", "--steps", str(steps),
            "--window", "3"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    modes = {"fused": [], "legacy": ["--no-fused"]}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        try:
            for mode, extra in modes.items():
                tele = os.path.join(tmp, mode)
                ckpt = os.path.join(tmp, f"{mode}.npz")
                args = base + ["--telemetry-out", tele, "--ckpt", ckpt] \
                    + extra
                procs[mode] = (time.perf_counter(), subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.train",
                     *args], env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True))
            # the same runs in this process while the fresh ones run
            agent0 = {mode: train._agent0(train.main(
                base + extra + ["--device", dev.type]).params)
                for mode, extra in modes.items()}
            secs = {}
            for mode, (t0, proc) in procs.items():
                _, err = proc.communicate(timeout=FED_CLI_TIMEOUT_S)
                secs[mode] = time.perf_counter() - t0
                if proc.returncode != 0:
                    raise AssertionError(f"train CLI ({mode}) exited "
                                         f"{proc.returncode}:\n"
                                         f"{err[-3000:]}")
        finally:
            for _, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        for mode in modes:
            tele = os.path.join(tmp, mode)
            with open(os.path.join(tele, "metrics.jsonl")) as f:
                recs = [json.loads(ln) for ln in f]
            fed_rows = [r for r in recs if r.get("stream") == "fed"]
            if [r["step"] for r in fed_rows] != list(range(steps)):
                raise AssertionError(f"train CLI ({mode}): fed records "
                                     f"{[r.get('step') for r in fed_rows]}")
            with open(os.path.join(tele, "manifest.json")) as f:
                manifest = json.load(f)
            if manifest["mode"] != mode or manifest["device"] != dev.type:
                raise AssertionError(f"train CLI ({mode}): manifest "
                                     f"{manifest}")
            back = restore(agent0[mode], os.path.join(tmp, f"{mode}.npz"),
                           device=dev)
            same = all(torch.equal(a, b) for (_, a), (_, b) in
                       zip(tree_paths(agent0[mode]), tree_paths(back)))
            if not same:
                raise AssertionError(f"train CLI ({mode}): the checkpoint "
                                     f"is not agent 0's theta of the same "
                                     f"run in this process")
            log(f"[fed] train CLI ({mode}) in a fresh process on the card "
                f"(both modes at once): exit 0 in {secs[mode]:.1f} s, "
                f"{len(fed_rows)} fed records, "
                f"losses {[round(r['loss'], 6) for r in fed_rows]}, "
                f"manifest mode {manifest['mode']}; its checkpoint restores "
                f"to agent 0's theta of the same run in this process, bit "
                f"for bit")


def phase_fed(dev):
    """Phase 10, federated LLM training at Llama-3.2-1B's full width: the
    tree run, the flat runs (each with phase 10c (a), its ``sharded=True``
    repeat), phase 10c (b) over two ranks, tree against flat, the card
    against the CPU and the CLI. Returns the launches per kernel."""
    totals = {}
    t0 = time.perf_counter()
    _add(totals, phase_fed_tree(dev))
    log(f"[time] phase 10 tree runs {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _add(totals, phase_fed_flat(dev))
    log(f"[time] phase 10 flat runs with 10c (a) "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _add(totals, phase_fed_two_ranks(dev))
    log(f"[time] phase 10c (b) two ranks {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_fed_tree_ranks(dev)
    log(f"[time] phase 10d tree ranks {time.perf_counter() - t0:.1f} s")
    for phase in FED_BLOCK_ARCHS:
        t0 = time.perf_counter()
        phase_fed_blocks(dev, phase)
        log(f"[time] phase {phase} blocks at full width "
            f"{time.perf_counter() - t0:.1f} s")
    phase_fed_tree_vs_flat(dev)
    tree = phase_fed_cpu_agreement(dev)
    phase_fed_cli(dev)
    phase_fed_cpu_repeat(dev, tree)
    return totals


#: phase 11: serving under a mesh. (a) Llama-3.2-1B at full width and
#: depth through make_serve_fns on a one-rank (1, 1) mesh: B prompts of S
#: tokens, then greedy decode steps; (b) its width cut to 2 layers over
#: two gloo ranks on the card, on each (data, model) mesh, 3 steps
SERVE_MESH_ARCH, SERVE_MESH_SEED = "llama3.2-1b", 0
SERVE_MESH_B, SERVE_MESH_S, SERVE_MESH_STEPS = 4, 512, 8
SERVE_RANKS, SERVE_RANK_LAYERS, SERVE_RANK_STEPS = 2, 2, 3
SERVE_RANK_MESHES = ((1, 2), (2, 1))
#: (b) and (c): a rank against the one-process route within this share of
#: its largest logit and of its largest cache entry: where a rank serves
#: a subset of the rows ((2, 1)) or runs on its blocks ((1, 2): column
#: and row blocks, partial products summed over the ranks) its matmuls
#: are other shapes, so f32 sums over d = 2048 (Grok-1: 6144) run in
#: other orders (√2048 · 2⁻²³ ≈ 5.4e-6 of an entry's scale; the CPU
#: tests' gaps at d 256 are below 2.4e-6). Where "model" has one rank
#: ((2, 1)) a rank also matches the route on its own rows bit for bit
SERVE_RANK_TOL = 1e-5
SERVE_RANK_TIMEOUT_S = 600


def _serve_mesh_cfg(layers=None):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(SERVE_MESH_ARCH)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def _serve_mesh_tokens(cfg, dev):
    """The seeded (B, S) int32 prompts, the same in every process."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_MESH_SEED + 1)
    return torch.randint(0, cfg.vocab_size, (SERVE_MESH_B, SERVE_MESH_S),
                         generator=gen, device=dev, dtype=torch.int32)


def _greedy(logits):
    """The next tokens of (placed) logits (B, 1, V): each rank's rows'
    argmax, placed like the logits' rows (a plain tensor stays plain)."""
    import torch
    from repro_torch.carriers import placed
    tok = placed.local(logits)[:, -1].argmax(-1)[:, None].to(torch.int32)
    lay = placed.layout(logits)
    if lay is None:
        return tok
    return placed.Layout(lay.mesh, (lay.shape[0], 1),
                         lay.splits[:2]).wrap(tok)


def _plain_serve(cfg, params, tokens, steps, keep=()):
    """``model.prefill`` and ``steps`` greedy ``decode_step``s: the logits
    of each call, the greedy tokens, and the caches (host copies) after
    the calls listed in ``keep`` (0 the prefill)."""
    from repro_torch.core.tree import tree_paths
    from repro_torch.models import model as tm
    logits, cache = tm.prefill(cfg, params, tokens, cache_len=SERVE_MESH_S)
    out = {"logits": [logits], "tokens": [], "caches": {}}
    for i in range(steps + 1):
        if i in keep:
            out["caches"][i] = {p: x.cpu() for p, x in tree_paths(cache)}
        if i == steps:
            break
        tok = _greedy(logits)
        out["tokens"].append(tok)
        logits, cache = tm.decode_step(cfg, params, tok, cache)
        out["logits"].append(logits)
    out["cache"] = cache
    return out


def _serve_one_rank(cfg, params, tokens, dev, mesh):
    """Phase 11 (a)'s mesh run: ``make_serve_fns`` on the one-rank (1, 1)
    ``mesh``, a prefill and SERVE_MESH_STEPS greedy decode steps, with
    the launches counted (zeroed just before) and the flash launches held
    against the plain version on their own inputs. Returns the serving
    functions, the logits, the tokens, the cache, the launches, ms and
    the peak bytes."""
    import torch
    from repro_torch.distributed.serving import make_serve_fns
    from repro_torch.kernels import dispatch
    cuda = dev.type == "cuda"
    fns = make_serve_fns(cfg, mesh, SERVE_MESH_B, SERVE_MESH_S)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    with _PathInputs() as path:
        t0 = time.perf_counter()
        logits, cache = fns.prefill(params, tokens)
        if cuda:
            torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    out = {"logits": [logits], "tokens": [], "ms": []}
    for _ in range(SERVE_MESH_STEPS):
        tok = _greedy(logits)
        out["tokens"].append(tok)
        t0 = time.perf_counter()
        logits, cache = fns.decode(params, tok, cache)
        if cuda:
            torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["logits"].append(logits)
    out["launches"] = dispatch.launch_counts()
    out["peak"] = torch.cuda.max_memory_allocated() if cuda else 0
    path.check("serve_mesh_one_rank")
    out.update(fns=fns, cache=cache, prefill_ms=prefill_ms)
    return out


def phase_serve_mesh_one_rank(dev):
    """Phase 11 (a): Llama-3.2-1B at full width and depth through
    ``make_serve_fns`` on a one-rank (1, 1) mesh against ``model.prefill``
    and ``decode_step`` on the same tensors: logits, greedy tokens and
    every cache leaf bit for bit, the prefill's flash launches those of
    the plain route; the dry run's ``argument_bytes`` for this (cfg, B,
    S, (1, 1)) equal to the bytes the params and tokens hold, printed
    with its ``peak_per_device_gb`` beside the measured peak. Then phase
    12's audit of one more decode step on the kept cache. Returns the
    mesh run's launches."""
    import torch
    from repro_torch.analysis.donation import one_rank_mesh
    from repro_torch.carriers import placed
    from repro_torch.core.tree import tree_paths
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.kernels import dispatch
    from repro_torch.launch import dryrun
    from repro_torch.models.model import init_params
    cfg = _serve_mesh_cfg()
    params = init_params(cfg, SERVE_MESH_SEED, device=dev)
    tokens = _serve_mesh_tokens(cfg, dev)
    held = sum(x.nbytes for _, x in tree_paths(params)) + tokens.nbytes
    with one_rank_mesh(dev.type) as one:
        mesh = _serve_one_rank(cfg, params, tokens, dev, one)
        dispatch.reset_launches()
        plain = _plain_serve(cfg, params, tokens, SERVE_MESH_STEPS)
        plain_flash = dispatch.launch_counts()["flash_attention"]
        bad = [i for i, (a, b) in enumerate(zip(mesh["logits"],
                                                plain["logits"]))
               if not torch.equal(placed.local(a), b)]
        bad += [f"token {i}" for i, (a, b) in enumerate(
            zip(mesh["tokens"], plain["tokens"]))
            if not torch.equal(placed.local(a), b)]
        bad += [p for (p, a), (_, b) in zip(tree_paths(mesh["cache"]),
                                            tree_paths(plain["cache"]))
                if not torch.equal(placed.local(a), b)]
        del plain
        # after the comparisons: the audited step writes the kept cache
        _analysis_serve_decode(mesh["fns"], params,
                               _greedy(mesh["logits"][-1]), mesh["cache"],
                               dev)
    flash = mesh["launches"]["flash_attention"]
    amesh = AbstractMesh((1, 1), ("data", "model"))
    mem = {mode: dryrun.memory(dryrun.serve_program(
        cfg, mode, SERVE_MESH_B, SERVE_MESH_S, amesh, torch.float32), amesh)
        for mode in ("prefill", "decode")}
    if bad or flash != plain_flash or flash != cfg.n_layers \
            or mem["prefill"]["argument_bytes"] != held:
        raise AssertionError(
            f"serve mesh one rank: differs from the plain route at {bad}; "
            f"flash launches {flash} vs the plain route's {plain_flash} "
            f"(want {cfg.n_layers}); dry-run argument_bytes "
            f"{mem['prefill']['argument_bytes']} vs held {held}")
    ms = mesh["ms"]
    log(f"[serve-mesh] {card()}: {SERVE_MESH_ARCH} full width and depth "
        f"({cfg.n_layers} layers, d {cfg.d_model}) through make_serve_fns "
        f"on a one-rank (1, 1) mesh, B={SERVE_MESH_B} x S={SERVE_MESH_S}, "
        f"{SERVE_MESH_STEPS} greedy steps: logits, tokens and every cache "
        f"leaf bit-equal to model.prefill/decode_step; prefill "
        f"{mesh['prefill_ms']:.3f} ms, decode ms/step "
        f"{[round(x, 3) for x in ms]} (median {_median(ms):.3f}); flash "
        f"launches {flash} (plain route {plain_flash})")
    log(f"[serve-mesh] {card()}: peak allocated across the mesh run "
        f"{mesh['peak']} bytes ({mesh['peak'] / 2**30:.3f} GiB); dry run "
        f"(1, 1): prefill argument_bytes {mem['prefill']['argument_bytes']}"
        f" (= params + tokens held, {held}), output_bytes "
        f"{mem['prefill']['output_bytes']}, peak_per_device_gb "
        f"{mem['prefill']['peak_per_device_gb']}; decode argument_bytes "
        f"{mem['decode']['argument_bytes']}, alias_bytes "
        f"{mem['decode']['alias_bytes']}, peak_per_device_gb "
        f"{mem['decode']['peak_per_device_gb']}")
    return mesh["launches"]


def _serve_rank_blocks(cache) -> list:
    """A (placed) cache's leaves: (path, the rank's block on the host, its
    global index, or None for a plain leaf)."""
    from repro_torch.carriers import placed
    from repro_torch.core.tree import tree_paths
    out = []
    for path, x in tree_paths(cache):
        lay = placed.layout(x)
        out.append((path, placed.local(x).cpu(), None if lay is None
                    else [(i.start, i.stop) for i in lay.index()]))
    return out


def _serve_one_process(dev, rows):
    """Phase 11 (b)'s one-process route on the card: ``model.prefill``
    and SERVE_RANK_STEPS greedy ``decode_step``s of the prompts' ``rows``
    ``(lo, hi)``. Returns the logits and tokens of each call and the
    cache after the prefill and after the last step (host copies), and
    the launches."""
    from repro_torch.kernels import dispatch
    from repro_torch.models.model import init_params
    cfg = _serve_mesh_cfg(SERVE_RANK_LAYERS)
    params = init_params(cfg, SERVE_MESH_SEED, device=dev)
    tokens = _serve_mesh_tokens(cfg, dev)[slice(*rows)]
    dispatch.reset_launches()
    out = _plain_serve(cfg, params, tokens, SERVE_RANK_STEPS,
                       keep=(0, SERVE_RANK_STEPS))
    return {"logits": [x.cpu() for x in out["logits"]],
            "tokens": [x.cpu() for x in out["tokens"]],
            "caches": out["caches"], "launches": dispatch.launch_counts()}


def _serve_rank_runs(dev, meshes):
    """Phase 11 (b)'s runs on this rank: for each (data, model) shape of
    ``meshes`` (shape -> DeviceMesh), a prefill and SERVE_RANK_STEPS
    greedy decode steps through ``make_serve_fns`` (the params placed
    once). Returns {shape: the rank's rows, each call's logit rows and
    tokens, its cache blocks after the prefill and after the last step,
    the launches}."""
    from repro_torch.carriers import placed
    from repro_torch.distributed.serving import make_serve_fns
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.kernels import dispatch
    from repro_torch.models.model import init_params
    cfg = _serve_mesh_cfg(SERVE_RANK_LAYERS)
    whole = init_params(cfg, SERVE_MESH_SEED, device=dev)
    tokens = _serve_mesh_tokens(cfg, dev)
    out = {}
    for shape, mesh in meshes.items():
        dispatch.reset_launches()
        fns = make_serve_fns(cfg, mesh, SERVE_MESH_B, SERVE_MESH_S)
        params = place_tree(whole, fns.shardings["params"], mesh)
        logits, cache = fns.prefill(params, tokens)
        rec = {"rows": placed.layout(logits).block(0),
               "logits": [placed.local(logits).cpu()], "tokens": [],
               "caches": {0: _serve_rank_blocks(cache)}}
        for _ in range(SERVE_RANK_STEPS):
            tok = _greedy(logits)
            rec["tokens"].append(placed.local(tok).cpu())
            logits, cache = fns.decode(params, tok, cache)
            rec["logits"].append(placed.local(logits).cpu())
        rec["caches"][SERVE_RANK_STEPS] = _serve_rank_blocks(cache)
        rec["launches"] = dispatch.launch_counts()
        out[shape] = rec
        del params, cache
    return out


def serve_rank_main(argv) -> int:
    """``chip_smoke.py --serve-rank RANK WORLD PORT OUT DEVICE``: one rank
    of phase 11 (b), joined on localhost:PORT (:func:`_join_rank`), on its
    card (DEVICE ``cuda``) or the CPU, over each mesh of SERVE_RANK_MESHES;
    writes its results to OUT."""
    rank, world, port, dst, where = argv
    dev = _join_rank(rank, world, port, where)
    import torch
    from repro_torch.launch.mesh import make_debug_mesh
    try:
        meshes = {s: make_debug_mesh(*s, device_type=dev.type)
                  for s in SERVE_RANK_MESHES}
        torch.save(_serve_rank_runs(dev, meshes), dst)
    finally:
        _leave_rank()
    return 0


def phase_serve_mesh_ranks(dev):
    """Phase 11 (b): Llama-3.2-1B's width cut to SERVE_RANK_LAYERS layers
    over SERVE_RANKS gloo ranks on the one card (fresh processes, one
    group; small collectives staged through the host), on each mesh of
    SERVE_RANK_MESHES, against the one-process route on the card from the
    same weights and prompts: each rank's logit rows after the prefill
    and every step, and its cache blocks after the prefill and after the
    last step, within SERVE_RANK_TOL of the largest entry against the
    route on the whole batch, and where "model" has one rank ((2, 1))
    bit for bit against the route on the rank's own rows, greedy tokens
    included; on (1, 2), where each rank runs on its head, column, row
    and vocabulary blocks, the greedy tokens equal wherever the route's
    top-1 margin exceeds twice the tolerance, and the two ranks' logits
    and tokens bit-identical; each rank's launches the one-process
    route's. Returns the ranks' launches."""
    import torch
    from repro_torch.distributed.sharding import row_block
    blocks = {(0, SERVE_MESH_B)} | {
        (r.start, r.stop) for shape in SERVE_RANK_MESHES
        for r in (row_block(SERVE_MESH_B, shape[0], i)
                  for i in range(shape[0]))}
    one, ranks, _, secs = _run_ranks(
        "--serve-rank", SERVE_RANKS, dev.type,
        parent=lambda: {rows: _serve_one_process(dev, rows)
                        for rows in sorted(blocks)},
        timeout=SERVE_RANK_TIMEOUT_S)
    whole = one[0, SERVE_MESH_B]
    lscale = max(x.abs().max().item() for x in whole["logits"])
    cscale = {step: max(x.abs().max().item() for x in c.values()
                        if x.is_floating_point())
              for step, c in whole["caches"].items()}
    totals = {}
    for shape in SERVE_RANK_MESHES:
        gaps = {"logits": 0.0, "cache": 0.0}
        bad = []
        exact = shape[1] == 1              # whole leaves, the rank's rows
        for r, res in enumerate(ranks):
            got = res[shape]
            _add(totals, got["launches"])
            lo, hi = got["rows"]
            own = one[lo, hi]
            if got["launches"] != own["launches"]:
                bad.append(f"rank {r} launches {got['launches']}")
            if not exact and any(
                    not torch.equal(a, b) for key in ("logits", "tokens")
                    for a, b in zip(got[key], ranks[0][shape][key])):
                bad.append(f"rank {r} differs from rank 0")
            for i, (a, b, w) in enumerate(zip(got["logits"], own["logits"],
                                              whole["logits"])):
                gaps["logits"] = max(gaps["logits"],
                                     (a - w[lo:hi]).abs().max().item())
                if exact and not torch.equal(a, b):
                    bad.append(f"rank {r} logits {i}")
            for i, (a, b, w) in enumerate(zip(got["tokens"], own["tokens"],
                                              whole["tokens"])):
                top = torch.topk(own["logits"][i][:, -1], 2).values
                sure = (top[:, 0] - top[:, 1] > 2 * SERVE_RANK_TOL
                        * lscale).all()
                if (exact or sure) and not (torch.equal(a, b)
                                            and torch.equal(a, w[lo:hi])):
                    bad.append(f"rank {r} token {i}")
            for step, blks in got["caches"].items():
                for path, blk, idx in blks:
                    if idx is None:
                        if not torch.equal(blk, own["caches"][step][path]):
                            bad.append(f"rank {r} step {step} {path}")
                        continue
                    at = [slice(*i) for i in idx]
                    w = whole["caches"][step][path][tuple(at)]
                    at[1] = slice(None)           # the rank's own rows
                    if exact and not torch.equal(
                            blk, own["caches"][step][path][tuple(at)]):
                        bad.append(f"rank {r} step {step} {path}")
                    if blk.is_floating_point():
                        gaps["cache"] = max(
                            gaps["cache"],
                            (blk - w).abs().max().item() / cscale[step])
        if gaps["logits"] > SERVE_RANK_TOL * lscale \
                or gaps["cache"] > SERVE_RANK_TOL:
            bad.append(f"whole-batch gaps {gaps} (max|logit| {lscale})")
        log(f"[serve-mesh] {card()}: {SERVE_MESH_ARCH} width cut to "
            f"{SERVE_RANK_LAYERS} layers over {SERVE_RANKS} gloo ranks on "
            f"the one card, (data, model) = {shape}, B={SERVE_MESH_B} x "
            f"S={SERVE_MESH_S}, {SERVE_RANK_STEPS} greedy steps: against "
            f"the one-process route on the card on each rank's own rows "
            f"{('bit for bit' if exact else 'on its blocks, the two ranks bit-identical') if not bad else 'NOT as required'}; against "
            f"it on the whole batch logits max abs gap "
            f"{gaps['logits']:.3e} = {gaps['logits'] / lscale:.3e} of "
            f"max|logit| and cache blocks {gaps['cache']:.3e} of the "
            f"largest entry (tol {SERVE_RANK_TOL}) after the prefill and "
            f"step {SERVE_RANK_STEPS}, greedy tokens "
            f"{'compared' if bad else 'equal'}; flash launches per rank "
            f"{whole['launches']['flash_attention']}; the ranks' wall "
            f"{secs:.1f} s")
        if bad:
            raise AssertionError(f"serve mesh ranks {shape}: {bad[:8]}")
    return totals


#: phase 11 (c) and (d): each model at full width cut to 1 layer through
#: make_serve_fns over two gloo ranks on the card, (data, model) = (1, 2).
#: (c) Grok-1: expert-parallel (4 of the 8 experts a rank), head-parallel
#: (24 query over 4 KV heads, hd 128, G = 6) and vocab-parallel (65,536 of
#: the 131,072 rows and logit columns a rank); (d) DeepSeek-V2-Lite: MLA
#: on 8 of the 16 heads through ``wq``, 32 of the 64 experts, the shared
#: experts' d_ff columns and 51,200 vocabulary rows a rank, absorbed
#: decode. B prompts of S tokens into a ring of W, greedy steps
SERVE_TP_ARCHS, SERVE_TP_MESH = ("grok-1-314b", "deepseek-v2-lite-16b"), \
    (1, 2)
SERVE_TP_B, SERVE_TP_S, SERVE_TP_W, SERVE_TP_STEPS = 2, 128, 256, 8
#: what a rank may allocate beyond the dry run's reckoning and the
#: one-process route's activations for the same call: cuBLAS's
#: workspaces, made once a process
SERVE_TP_SLACK = 64 << 20


def _serve_tp_cfg(arch):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=1)


def _serve_tp_phase(arch) -> str:
    """The letter of ``arch``'s run in phase 11."""
    return "cd"[SERVE_TP_ARCHS.index(arch)]


def _serve_tp_params(cfg, dev, mesh=None):
    """Phase 11 (c)'s and (d)'s seeded weights, drawn block by block on
    the (1, 2) mesh's "model" split (one generator per leaf and block:
    norms ones, the embedding 0.02 N(0, 1), the others N(0, 1) over the
    root of their contraction width), so a rank draws only its own
    blocks and no rank builds the layer whole. ``mesh`` None: every
    block, written into the whole leaf (the one-process route's tree);
    else this rank's blocks as placed leaves of ``mesh``."""
    import torch
    from repro_torch.carriers import placed
    from repro_torch.core.tree import tree_map, tree_paths
    from repro_torch.distributed.sharding import (AbstractMesh,
                                                  param_shardings,
                                                  placements)
    from repro_torch.models.model import init_params
    shapes = init_params(cfg, 0, device="meta")
    specs = param_shardings(cfg, shapes, AbstractMesh(SERVE_TP_MESH, (
        "data", "model")))
    m = SERVE_TP_MESH[1]
    leaves = []
    for j, ((path, t), (_, spec)) in enumerate(zip(tree_paths(shapes),
                                                    tree_paths(specs))):
        name = path.split("/")[-1]
        split = [d for d, e in enumerate(spec) if e == "model"]
        d, n = (split[0], m) if split else (0, 1)
        blk = list(t.shape)
        blk[d] //= n

        def draw(b):
            if name.startswith("norm") or name == "final_norm":
                return torch.ones(blk, dtype=t.dtype, device=dev)
            gen = torch.Generator(device=dev)
            gen.manual_seed(SERVE_MESH_SEED + 1000 * j + b)
            x = torch.randn(blk, generator=gen, device=dev, dtype=t.dtype)
            return x.mul_(0.02 if name == "embed" else t.shape[-2] ** -0.5)
        if mesh is None:
            x = torch.empty(t.shape, dtype=t.dtype, device=dev)
            for b in range(n):
                x.narrow(d, b * blk[d], blk[d]).copy_(draw(b))
        else:
            b = mesh.get_coordinate()[1] if split else 0
            x = placed.Layout.of(t.shape, mesh, placements(
                spec, mesh)).wrap(draw(b))
        leaves.append(x)
    it = iter(leaves)
    return tree_map(lambda _: next(it), shapes)


def _serve_tp_tokens(cfg, dev):
    """The seeded (B, S) int32 prompts of phase 11 (c) and (d)."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE_MESH_SEED + 2)
    return torch.randint(0, cfg.vocab_size, (SERVE_TP_B, SERVE_TP_S),
                         generator=gen, device=dev, dtype=torch.int32)


def _serve_tp_rank_run(dev, mesh, arch):
    """Phase 11 (c) or (d), ``arch``'s run, on this rank: its blocks
    drawn, then a prefill and SERVE_TP_STEPS greedy decode steps through
    ``make_serve_fns`` with the launches counted (zeroed just before,
    read just after) and each launch held against its plain version on
    its own input. Returns the
    logits and tokens (host copies), the launches, the smallest routing
    margin, the peaks (after drawing, and over the run), the bytes of
    the rank's blocks, ms per call."""
    import torch
    from repro_torch.carriers import placed
    from repro_torch.core.tree import tree_paths
    from repro_torch.distributed.serving import make_serve_fns
    from repro_torch.kernels import dispatch
    cfg = _serve_tp_cfg(arch)
    torch.cuda.reset_peak_memory_stats()
    params = _serve_tp_params(cfg, dev, mesh)
    torch.cuda.synchronize()
    out = {"built_peak": torch.cuda.max_memory_allocated(),
           "held": sum(placed.local(x).nbytes
                       for _, x in tree_paths(params)),
           "logits": [], "tokens": [], "ms": []}
    tokens = _serve_tp_tokens(cfg, dev)
    fns = make_serve_fns(cfg, mesh, SERVE_TP_B, SERVE_TP_W)
    dispatch.reset_launches()
    with _PathInputs() as path, _RoutingMargins() as margins:
        t0 = time.perf_counter()
        logits, cache = fns.prefill(params, tokens)
        for i in range(SERVE_TP_STEPS + 1):
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["logits"].append(placed.local(logits).cpu())
            if i == SERVE_TP_STEPS:
                break
            tok = _greedy(logits)
            out["tokens"].append(placed.local(tok).cpu())
            t0 = time.perf_counter()
            logits, cache = fns.decode(params, tok, cache)
    out["launches"] = dispatch.launch_counts()
    out["peak"] = torch.cuda.max_memory_allocated()
    out["margin"] = margins.smallest()
    path.check(f"serve_tp rank {mesh.get_rank()}")
    return out


def serve_tp_rank_main(argv) -> int:
    """``chip_smoke.py --serve-tp-rank RANK WORLD PORT OUT DEVICE ARCH``:
    one rank of phase 11's run of ARCH ((c) or (d)), joined on
    localhost:PORT (:func:`_join_rank`), on its card (DEVICE ``cuda``) or
    the CPU, on the SERVE_TP_MESH mesh; writes its results to OUT."""
    rank, world, port, dst, where, arch = argv
    dev = _join_rank(rank, world, port, where)
    import torch
    from repro_torch.launch.mesh import make_debug_mesh
    try:
        mesh = make_debug_mesh(*SERVE_TP_MESH, device_type=dev.type)
        torch.save(_serve_tp_rank_run(dev, mesh, arch), dst)
    finally:
        _leave_rank()
    return 0


def _serve_tp_one_process(cfg, dev):
    """Phase 11 (c)'s or (d)'s one-process route on the card from the
    whole tree: ``model.prefill`` and SERVE_TP_STEPS greedy
    ``decode_step``s. Returns
    the logits and tokens of each call (host copies), each call's
    activations (its peak above what it started with and returns new)
    and ms, the tree's bytes."""
    import torch
    from repro_torch.core.tree import tree_paths
    from repro_torch.models import model as tm
    params = _serve_tp_params(cfg, dev)
    tree = sum(x.nbytes for _, x in tree_paths(params))
    tokens = _serve_tp_tokens(cfg, dev)
    out = {"logits": [], "tokens": [], "act": [], "tree": tree, "ms": []}

    def call(fn, *args):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, cache = fn(*args)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        new = torch.cuda.memory_allocated() - base
        out["act"].append(torch.cuda.max_memory_allocated() - base - new)
        out["logits"].append(logits.cpu())
        return logits, cache

    logits, cache = call(lambda: tm.prefill(cfg, params, tokens,
                                            cache_len=SERVE_TP_W))
    for _ in range(SERVE_TP_STEPS):
        tok = _greedy(logits)
        out["tokens"].append(tok.cpu())
        logits, cache = call(tm.decode_step, cfg, params, tok, cache)
    del params, cache
    torch.cuda.empty_cache()
    return out


def phase_serve_mesh_tp(dev, arch, backend=None, run=None):
    """Phase 11 (c) (Grok-1) or (d) (DeepSeek-V2-Lite): ``arch`` at full
    width cut to 1 layer over two ranks (fresh processes, one group; gloo
    on the one card), (data, model) = (1, 2), each rank holding only
    its blocks (drawn as blocks) and no leaf gathered whole, against
    the one-process route on the card from the whole tree: each rank's
    logits after the prefill and every step within SERVE_RANK_TOL of
    max|logit| while its greedy stream is the route's, the streams equal
    wherever the route's top-1 margin exceeds twice that tolerance, the
    two ranks' logits and tokens bit-identical, the smallest top-2
    routing margin printed; each rank's flash launch (one a layer, on
    its heads: MLA's at q/k 192, v 128) held against the plain version on
    its own input
    (inside the rank); each rank's peak
    allocation within the dry run's reckoning for its (1, 2) blocks plus
    the route's activations (and SERVE_TP_SLACK), and under the whole
    tree's bytes. ``run``: the results of :func:`_serve_tp_spawn` to
    check, else spawned here over ``backend``. Returns the ranks'
    launches."""
    import torch
    cfg = _serve_tp_cfg(arch)
    torch.cuda.empty_cache()
    one, ranks, secs = run or _serve_tp_spawn(dev, arch, backend)
    return _serve_tp_check(arch, cfg, one, ranks, secs, dev, backend)


def _serve_tp_spawn(dev, arch, backend=None, one_process=True):
    """Phase 11 (c)'s or (d)'s ranks (``backend`` as :func:`_join_rank`
    takes it), with the one-process route here meanwhile unless not
    ``one_process``: (its results, the ranks' results, their wall
    seconds). The ranks' bracketed lines are logged."""
    world = SERVE_TP_MESH[0] * SERVE_TP_MESH[1]
    one, ranks, outs, secs = _run_ranks(
        "--serve-tp-rank", world, _rank_where(dev, backend), (arch,),
        parent=(lambda: _serve_tp_one_process(_serve_tp_cfg(arch), dev))
        if one_process else None, timeout=SERVE_RANK_TIMEOUT_S)
    for r, out in enumerate(outs):
        for line in out.splitlines():
            if line.startswith("["):
                log(f"[serve-tp] rank {r}: {line}")
    return one, ranks, secs


def _serve_tp_check(arch, cfg, one, ranks, secs, dev, backend=None):
    """Phase 11 (c)'s or (d)'s comparisons of the ranks' results with the
    one-process route's (:func:`phase_serve_mesh_tp`); logs them and
    returns the ranks' launches."""
    import torch
    from repro_torch.core.tree import tree_paths
    from repro_torch.distributed.sharding import (AbstractMesh,
                                                  param_shardings,
                                                  serve_uses)
    from repro_torch.launch import dryrun
    from repro_torch.models.model import init_params
    world = len(ranks)
    m = SERVE_TP_MESH[1]
    amesh = AbstractMesh(SERVE_TP_MESH, ("data", "model"))
    shapes = init_params(cfg, 0, device="meta")
    gathered = [p for p, u in tree_paths(serve_uses(
        cfg, shapes, param_shardings(cfg, shapes, amesh), amesh))
        if u == "gather"]
    flash = cfg.n_layers
    mem = {mode: dryrun.memory(dryrun.serve_program(
        cfg, mode, SERVE_TP_B, SERVE_TP_W, amesh, torch.float32), amesh)
        for mode in ("prefill", "decode")}
    reckon = max(m["peak_per_device_gb"] for m in mem.values()) * 2**30
    bound = reckon + max(one["act"]) + SERVE_TP_SLACK
    scale = max(x.abs().max().item() for x in one["logits"])
    tol = SERVE_RANK_TOL * scale
    bad, totals, gap, compared = [], {}, 0.0, 0
    if gathered:
        bad.append(f"leaves gathered whole: {gathered}")
    for r, res in enumerate(ranks):
        _add(totals, res["launches"])
        if res["launches"].get("flash_attention", 0) != flash:
            bad.append(f"rank {r} launches {res['launches']}")
        for key in ("logits", "tokens"):
            if any(not torch.equal(a, b) for a, b in zip(res[key],
                                                          ranks[0][key])):
                bad.append(f"rank {r} {key} differ from rank 0's")
        if not res["peak"] <= bound or not res["peak"] < one["tree"]:
            bad.append(f"rank {r} peak {res['peak']} (bound {bound}, tree "
                       f"{one['tree']})")
    res = ranks[0]
    # row by row: logits while the streams agree; tokens while the
    # route's top-1 margin exceeds twice the tolerance
    for row in range(SERVE_TP_B):
        for i, (a, w) in enumerate(zip(res["logits"], one["logits"])):
            if i and not torch.equal(res["tokens"][i - 1][row],
                                     one["tokens"][i - 1][row]):
                break
            gap = max(gap, (a[row] - w[row]).abs().max().item())
            compared += 1
            if i == SERVE_TP_STEPS:
                break
            top = torch.topk(w[row, -1], 2).values
            if (top[0] - top[1]).item() > 2 * tol and not torch.equal(
                    res["tokens"][i][row], one["tokens"][i][row]):
                bad.append(f"row {row} token {i} differs above the margin")
    if gap > tol:
        bad.append(f"logits gap {gap} > {tol}")
    gb = 2**30
    heads = f"{cfg.n_heads // m} of {cfg.n_heads} heads " + (
        "(MLA)" if cfg.mla is not None
        else f"over {cfg.n_kv_heads // m} of {cfg.n_kv_heads} KV heads")
    experts = "" if cfg.moe is None else \
        f"{cfg.moe.n_experts // m} of {cfg.moe.n_experts} experts, "
    log(f"[serve-tp] {card()}: phase 11 ({_serve_tp_phase(arch)}) {arch} "
        f"full width, 1 layer, through make_serve_fns over "
        f"{_ranks_on(dev, world, backend)}, (data, model) = {SERVE_TP_MESH} "
        f"({experts}{heads}, {cfg.vocab_size // m} vocabulary rows a "
        f"rank), "
        f"B={SERVE_TP_B} x S={SERVE_TP_S}, W={SERVE_TP_W}, "
        f"{SERVE_TP_STEPS} greedy steps: logits max abs gap "
        f"{gap:.3e} = {gap / scale:.3e} of max|logit| over {compared} "
        f"compared row-calls (tol {SERVE_RANK_TOL}); greedy streams "
        f"{'equal' if not bad else 'compared'} under the margin rule; the "
        f"ranks' logits and tokens bit-identical; smallest top-2 routing "
        f"margin {min(r['margin'] for r in ranks):.3e}; flash launches a "
        f"rank {[r['launches'].get('flash_attention', 0) for r in ranks]} "
        f"(want {flash}); "
        f"rank ms prefill {res['ms'][0]:.3f}, decode "
        f"{[round(x, 3) for x in res['ms'][1:]]}; the ranks' wall "
        f"{secs:.1f} s")
    for r, res in enumerate(ranks):
        log(f"[serve-tp] {card()}: rank {r} max_memory_allocated "
            f"{res['peak']} bytes ({res['peak'] / gb:.3f} GiB; after "
            f"drawing its blocks {res['built_peak'] / gb:.3f} GiB, its "
            f"blocks {res['held'] / gb:.3f} GiB); the dry run's (1, 2) "
            f"reckoning {reckon / gb:.3f} GiB (prefill "
            f"{mem['prefill']['peak_per_device_gb']}, decode "
            f"{mem['decode']['peak_per_device_gb']}) + the one-process "
            f"route's activations {max(one['act']) / gb:.3f} GiB + "
            f"{SERVE_TP_SLACK >> 20} MiB = bound {bound / gb:.3f} GiB; "
            f"the whole layer's tree {one['tree'] / gb:.3f} GiB (rank at "
            f"{res['peak'] / one['tree']:.3f} of it)")
    if bad:
        raise AssertionError(f"serve tp ranks {arch}: {bad[:8]}")
    return totals


def phase_serve_mesh(dev):
    """Phase 11, serving under a mesh: (a), (b), (c) and (d). Returns the
    launches."""
    totals = {}
    t0 = time.perf_counter()
    _add(totals, phase_serve_mesh_one_rank(dev))
    _add(totals, phase_serve_mesh_ranks(dev))
    log(f"[time] phase 11 (a, b) {time.perf_counter() - t0:.1f} s")
    for arch in SERVE_TP_ARCHS:
        t1 = time.perf_counter()
        _add(totals, phase_serve_mesh_tp(dev, arch))
        log(f"[time] phase 11 ({_serve_tp_phase(arch)}) "
            f"{time.perf_counter() - t1:.1f} s")
    log(f"[time] phase 11 serving under a mesh "
        f"{time.perf_counter() - t0:.1f} s")
    return totals


# ---------------------------------------------------------------------------
# Phase 12: the analysis suite on the card
# ---------------------------------------------------------------------------

#: what phase 12's audits inside phases 5, 10 and 11 leave: each site's
#: report, their seconds and their launches
ANALYSIS = {"donation": [], "seconds": 0.0, "launches": {}}
#: the memcheck contract run over two gloo ranks on the card
MEMCHECK_CARD = dict(aggregator="rfa", K=8, ranks=2)


def _audit(name, kind, call, dev):
    """One state contract of phase 12 (``repro_torch.analysis.donation``)
    on a call of an earlier phase at full width: a finding raises, the
    report (the bytes allocated during the call, its bound) joins
    ANALYSIS."""
    from repro_torch.analysis import donation
    from repro_torch.analysis.findings import render
    t0 = time.perf_counter()
    findings, report = donation.check_call(name, kind, call, dev)
    ANALYSIS["seconds"] += time.perf_counter() - t0
    if findings:
        raise AssertionError(f"phase 12 donation {name}:\n"
                             f"{render(findings)}")
    ANALYSIS["donation"].append(report)


def _analysis_serving(engine, dev):
    """Phase 12 on phase 5's Llama-3.2-1B engine (full width and depth, 8
    slots, a 544-entry ring): an insert and a tick on a fresh slot state,
    each in place (every cache buffer at its address, no allocation of a
    buffer's size). The request's prefill launches flash 16 times."""
    import numpy as np
    from repro_torch.analysis.donation import (IN_PLACE, Call, buffers,
                                               smallest_block)
    from repro_torch.kernels import dispatch
    from repro_torch.serving.request import Request
    t0 = time.perf_counter()
    dispatch.reset_launches()
    state = engine.init_state()
    first, row, total = engine.prefill_request(Request(
        uid=0, max_new=8, tokens=np.arange(1, 17, dtype=np.int32)))
    bound = smallest_block(state.cache)
    ANALYSIS["seconds"] += time.perf_counter() - t0
    _audit("serving_insert", IN_PLACE, Call(
        lambda: engine.insert(state, 0, row, first, total, 8),
        buffers(state.cache), lambda r: buffers(r.cache), bound), dev)
    _audit("serving_tick", IN_PLACE, Call(
        lambda: engine.tick(state), buffers(state.cache),
        lambda r: buffers(r[0].cache), bound), dev)
    _add(ANALYSIS["launches"], dispatch.launch_counts())


def _analysis_fed_step(cfg, fed, state, batch, mask, dev):
    """Phase 12 on phase 10's tree state at full width (the window's last
    state: K = 4, 2 layers, 26 GB): one step of ``make_fed_step`` on a
    one-rank (1, 1) mesh (c = 0, which reads every field), its result let
    go: no input's ``_version`` moved and every leaf's checksum, summed on
    the card (no host copy of the state), unchanged."""
    from repro_torch.analysis.donation import FUNCTIONAL, Call, one_rank_mesh
    from repro_torch.core.engine import seed_generator
    from repro_torch.distributed.fed_trainer import fed_noise, make_fed_step
    t0 = time.perf_counter()
    noise = fed_noise(seed_generator(FED_SEED + 1, dev), fed, state, FED_BYZ)
    with one_rank_mesh(dev.type) as mesh:
        step = make_fed_step(cfg, fed, mesh, large=False,
                             per_agent_batch=FED_BATCH, seq_len=FED_SEQ)[0]
        ANALYSIS["seconds"] += time.perf_counter() - t0
        _audit("make_fed_step", FUNCTIONAL, Call(
            lambda: step(state, batch, mask, noise),
            (state, batch, mask, noise)), dev)


def _analysis_serve_decode(fns, params, tok, cache, dev):
    """Phase 12 on phase 11 (a)'s kept cache (Llama-3.2-1B at full width
    and depth through ``make_serve_fns`` on a one-rank mesh, after its
    comparisons): one more decode step, in place, its result let go."""
    from repro_torch.analysis.donation import (IN_PLACE, Call, buffers,
                                               smallest_block)
    from repro_torch.kernels import dispatch
    dispatch.reset_launches()
    _audit("serving_decode", IN_PLACE, Call(
        lambda: fns.decode(params, tok, cache), buffers(cache),
        lambda r: buffers(r[1]), smallest_block(cache)), dev)
    _add(ANALYSIS["launches"], dispatch.launch_counts())


def phase_analysis(dev):
    """Phase 12: the passes that mean something on the card, in process
    (``repro_torch.analysis``, ``--device cuda``): keycheck's entry points on
    the CUDA generator ((seed, offset) states), retrace's config audit
    and its swept grid's build-once, the donation sites at their small
    sizes (the full-width ones ran inside phases 5, 10 and 11), and one
    memcheck contract over two gloo ranks on the card (gathers staged
    through the host). A finding raises. Returns the launches of phase
    12, its audits in the earlier phases included."""
    from repro_torch.analysis import donation, keycheck, memcheck, retrace
    from repro_torch.analysis.findings import render
    from repro_torch.kernels import dispatch
    t_all = time.perf_counter()
    dispatch.reset_launches()
    found, secs = [], {}
    small, ranks = [], []
    for name, run in (
            ("keycheck", lambda: keycheck.run(dev)),
            ("retrace", lambda: retrace.run(dev)),
            ("donation", lambda: donation.run(dev, report=small)),
            ("memcheck", lambda: memcheck.run(
                dev, table=[memcheck.MemContract(**MEMCHECK_CARD)],
                report=ranks))):
        t0 = time.perf_counter()
        found += run()
        secs[name] = round(time.perf_counter() - t0, 1)
    _add(ANALYSIS["launches"], dispatch.launch_counts())
    if found:
        raise AssertionError(f"phase 12 analysis:\n{render(found)}")
    for where, reports in (("full width", ANALYSIS["donation"]),
                           ("small", small)):
        for r in reports:
            bound = "" if r["bound"] is None else f" < bound {r['bound']}"
            log(f"[analysis] {card()}: donation {r['site']} ({r['kind']}, "
                f"{where}): allocated during the call {r['peak']} bytes"
                f"{bound}")
    for r in ranks:
        log(f"[analysis] {card()}: memcheck {r['contract']} rank "
            f"{r['rank']}: arguments {r['args']} <= {r['arg_bound']}, peak "
            f"{r['peak']} <= {r['temp_bound']}, all_gathers {r['gathers']}"
            f" <= {r['gather_bound']} bytes each")
    here = time.perf_counter() - t_all
    log(f"[time] phase 12 analysis {here + ANALYSIS['seconds']:.1f} s "
        f"(here {here:.1f}: {secs}; audits in phases 5, 10 and 11 "
        f"{ANALYSIS['seconds']:.1f})")
    return ANALYSIS["launches"]


#: phase 13: the seven scripts of ``examples_torch/`` as a user runs them,
#: each at its own widths (K, N, B, horizon, policy, model configuration)
#: with only its depth cut: (script, arguments before ``--device``)
EXAMPLES = (
    ("quickstart", ["--iters", "3", "--seeds", "1"]),
    ("byzpg_centralized", ["--iters", "3", "--seeds", "1"]),
    ("federation_speedup", ["--iters", "3", "--seeds", "1"]),
    ("topology_resilience", ["--iters", "3", "--seeds", "1"]),
    ("attack_strength_sweep", ["--iters", "3", "--seeds", "1",
                               "--sigmas", "10,200"]),
    ("serve_decode", []),
    ("serve_decode", ["--offline"]),
    # Common-Sample's coins at seed 0, p 0.25: 1 0 0 1, so both PAGE
    # branches run on each trainer (phase 13 asserts it)
    ("federated_llm", ["--steps", "4"]),
    ("federated_llm", ["--steps", "2", "--tree"]),
)
#: the kernels the examples' paths must launch inside phase 13: RFA's
#: (examples 1-5 and 7) and the serving prefill's flash attention
EXAMPLE_KERNELS = ("gram", "weiszfeld", "wsum", "flash_attention")


def _load_example(name: str):
    import importlib.util
    path = ROOT / "examples_torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example_values(out) -> list:
    """The numbers an example's ``main`` returns: every float array of an
    ``ExperimentResult``'s summaries, a ``ServeReport``'s summary, or the
    federated run's (coin, loss, diameter) rows."""
    import numpy as np
    from repro_torch.serving import ServeReport
    if isinstance(out, ServeReport):
        return [float(v) for v in out.summary().values()]
    if isinstance(out, list):                               # federated_llm
        return [x for _, loss, diam in out for x in (loss, diam)]
    vals = []
    for _, summary in out.items():
        for v in summary.values():
            a = np.asarray(v)
            if a.dtype.kind == "f":
                vals.extend(a.ravel().tolist())
    return vals


def phase_examples(dev):
    """Phase 13: each of :data:`EXAMPLES` through its ``main`` in this
    process on ``dev``, its report printed with an ``[examples]`` prefix
    and its wall: every number it returns finite, every request of a
    serving run given its budget, each federated run's coins both PAGE
    branches, and :data:`EXAMPLE_KERNELS` each launched inside the phase
    (the counts set to 0 just before it and read just after). The
    ``--offline`` serving run serves the seed's parameters drawn on the
    CPU, and the same run on the CPU (outside the counted launches) holds
    its streams under the margin rule (``hold_policy_streams``). Returns
    the phase's launches."""
    import io
    import math
    from repro_torch import make_env, obs, resolve
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import dispatch
    from repro_torch.serving import make_traffic, policy_params
    t_all = time.perf_counter()
    serve_mod = _load_example("serve_decode")
    env = make_env("cartpole(horizon=32)")
    policy = resolve("policy", serve_mod.policy_spec("llama3.2-1b"),
                     env=env)
    cpu_params = policy_params(policy, key=0, device="cpu")
    # the example's traffic at its defaults: 32 requests, seed 0, 200
    # req/s, budgets up to 16, CartPole's 4-float observations
    traffic = make_traffic(32, seed=0, rate_rps=200.0, max_new=16,
                           obs_dim=env.obs_dim)
    card_offline = None
    dispatch.reset_launches()
    for name, argv in EXAMPLES:
        offline = name == "serve_decode" and "--offline" in argv
        params = tree_map(lambda t: t.to(dev), cpu_params) if offline \
            else None
        buf = io.StringIO()
        obs.get_recorder().clear()     # each starts as a fresh process
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = _load_example(name).main(argv + ["--device", dev.type],
                                           **({"params": params} if offline
                                              else {}))
        secs = time.perf_counter() - t0
        label = " ".join([f"examples_torch/{name}.py", *argv])
        for line in buf.getvalue().splitlines():
            log(f"[examples] {label}: {line}")
        vals = _example_values(out)
        if not vals or not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"phase 13 {label}: non-finite output "
                                 f"{vals}")
        if name == "serve_decode":
            _check_served(f"phase 13 {label}", out, traffic, env.n_actions)
        if name == "federated_llm" and {c for c, _, _ in out} != {True,
                                                                  False}:
            raise AssertionError(f"phase 13 {label}: coins "
                                 f"{[c for c, _, _ in out]} miss a PAGE "
                                 f"branch")
        log(f"[examples] {card()}: {label} --device {dev.type}: wall "
            f"{secs:.1f} s")
        if offline:
            card_offline = out
    counts = dispatch.launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        cpu_report = serve_mod.main(["--offline", "--device", "cpu"],
                                    params=cpu_params)
    compared = hold_policy_streams(
        "phase 13 serve_decode.py --offline", policy.model_cfg, cpu_params,
        env, traffic, {r.uid: r.tokens for r in cpu_report.results},
        {r.uid: r.tokens for r in card_offline.results}, 1e-4)
    log(f"[check] card vs CPU, examples_torch/serve_decode.py --offline "
        f"(seed 0's parameters drawn on the CPU): streams equal over "
        f"{compared} of {sum(r.max_new for r in traffic)} tokens under the "
        f"margin rule (tol 1e-4)")
    missing = [k for k in EXAMPLE_KERNELS if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"phase 13: {missing} never launched by the "
                             f"examples; launches {counts}")
    log(f"[examples] launches in the phase {counts}")
    log(f"[time] phase 13 examples {time.perf_counter() - t_all:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# Phase 14: one rank per card over NCCL
# ---------------------------------------------------------------------------

#: phase 14 (b): the serving route's depth (Llama-3.2-1B at full width)
NCCL_SERVE_LAYERS = 2
#: phase 14 (c): the cards it spreads two ranks over, one rank a card
NCCL_CARDS = 2


class _HostCopies:
    """While active, records every operator that takes a CUDA tensor and
    gives a CPU one (``aten::_to_copy`` to the host, ``copy_`` into a
    host tensor): what a host-staged collective would run."""

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_flatten
        seen = self.copies = []

        def tensors(tree):
            return [t for t in tree_flatten(tree)[0]
                    if isinstance(t, torch.Tensor)]

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                if any(t.is_cuda for t in tensors((args, kwargs))) and any(
                        t.device.type == "cpu" for t in tensors(out)):
                    seen.append(str(func))
                return out

        self.mode = Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


def _same_bits(a, b) -> bool:
    """Nested dicts, lists and tuples of tensors and numbers, equal bit for
    bit (tensors by dtype, shape and every element)."""
    import torch
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_bits(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same_bits(x, y) for x, y in zip(a, b)))
    return a == b


def _nccl_gathers(dev, mesh) -> None:
    """Phase 14 (a)'s collectives on the joined one-rank group: one
    ``columns.gather_over`` on each mesh dimension (no size-1 shortcut:
    the backend runs an ``all_gather`` of one part), bit-equal to its
    input, on the rank's card, with no copy to the host and each gather
    seen by ``GatherWatch``; and one ``gather_over`` from a tensor hook in
    a backward, which on CUDA autograd runs on its device thread."""
    import threading
    import torch
    from repro_torch.analysis.memcheck import GatherWatch
    from repro_torch.carriers import columns
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    x = torch.randn((13, 386), generator=gen, device=dev)
    with _HostCopies() as host, GatherWatch() as watch:
        parts = [columns.gather_over(x, mesh, d) for d in range(mesh.ndim)]
    bad = [f"dim {d}: {len(p)} parts on {p[0].device}" for d, p in
           enumerate(parts) if len(p) != 1 or p[0].device != x.device
           or not torch.equal(p[0], x)]
    if host.copies or watch.gathers != [x.nbytes] * mesh.ndim:
        bad.append(f"host copies {host.copies}, gathers {watch.gathers}")
    seen = {}

    def hook(g):
        seen["thread"] = threading.current_thread().name
        seen["device"] = torch.cuda.current_device() if g.is_cuda else None
        seen["part"] = columns.gather_over(g, mesh, mesh.ndim - 1)[0]
        return seen["part"]

    w = x.clone().requires_grad_()
    y = w * 2
    y.register_hook(hook)
    y.sum().backward()
    if not (torch.equal(w.grad, torch.full_like(x, 2.0))
            and torch.equal(seen["part"], torch.ones_like(x))):
        bad.append("the backward's gather")
    if bad:
        raise AssertionError(f"phase 14 (a) gathers: {bad}")
    log(f"[nccl] gather_over on each of the {mesh.ndim} mesh dimensions: "
        f"bit-equal to its (13, 386) input on {parts[0][0].device}, "
        f"all_gathers seen {watch.gathers} bytes, copies to the host "
        f"{len(host.copies)}; from a backward hook on thread "
        f"{seen['thread']!r} (card {seen['device']}): bit-equal")


def _nccl_host_objects(dev) -> None:
    """Phase 14 (a)'s host objects: ``gather_rows`` and the sweep's
    ``broadcast_object`` over ``host_group()`` (the gloo group beside an
    NCCL world), their objects intact."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import sharding
    group = sharding.host_group()
    want = "nccl" if dev.type == "cuda" else "gloo"
    if (group is None) != (want == "gloo") or (
            group is not None and dist.get_backend(group) != "gloo"):
        raise AssertionError(f"phase 14 (a): host group {group} under "
                             f"{dist.get_backend()}")
    used = []
    orig = dist.all_gather_object, dist.broadcast_object_list

    def spy(fn):
        def call(*args, **kwargs):
            used.append(kwargs.get("group"))
            return fn(*args, **kwargs)
        return call

    dist.all_gather_object, dist.broadcast_object_list = map(spy, orig)
    try:
        rows = {"returns": np.arange(6.0).reshape(3, 2),
                "theta": torch.arange(12.0, device=dev).reshape(3, 4)}
        got = sharding.gather_rows(sharding.LaneMesh(1, 0), rows)
        carry = {"window": 3, "rows": [0, 1, 2], "state": b"\x00\x01"}
        back = sharding.broadcast_object(carry)
    finally:
        dist.all_gather_object, dist.broadcast_object_list = orig
    if not (np.array_equal(got["returns"], rows["returns"])
            and torch.equal(got["theta"], rows["theta"].cpu())
            and back == carry and used == [group, group]):
        raise AssertionError(f"phase 14 (a) host objects: {got}, {back}, "
                             f"groups {used}")
    where = "the gloo world itself" if group is None else \
        f"the gloo group beside the {dist.get_backend()} world"
    log(f"[nccl] gather_rows and the sweep's broadcast over {where}: rows "
        f"and objects intact")


def _nccl_flat_rfa(dev, mesh) -> dict:
    """Phase 14 (b): 10c (b)'s D-sharded flat steps with RFA on the
    one-rank ``mesh`` against the one-process route from the same state:
    θ and the losses bit for bit, the same launches per step, ``gram``,
    ``weiszfeld`` and ``wsum`` among them. Returns both runs' launches."""
    cases = {"rfa": FED_RANK_CASES["rfa"]}
    one = _fed_rank_runs(dev, "one process", cases=cases)["rfa"]
    ranked = _fed_rank_runs(dev, "the one-rank mesh", mesh,
                            cases=cases)["rfa"]
    totals = {}
    for counts in one["launches"] + ranked["launches"]:
        _add(totals, counts)
    per_step = [{k: n for k, n in c.items() if n}
                for c in ranked["launches"]]
    if not (_same_bits(ranked["theta"], one["theta"])
            and ranked["losses"] == one["losses"]
            and ranked["launches"] == one["launches"]
            and all(set(c) == {"gram", "weiszfeld", "wsum"}
                    for c in per_step)):
        raise AssertionError(f"phase 14 (b) flat rfa: launches {per_step} "
                             f"vs {one['launches']}, losses "
                             f"{ranked['losses']} vs {one['losses']}")
    log(f"[nccl] {card()}: 10c (b)'s flat steps with RFA (reduced "
        f"{FED_ARCH}, D={one['theta'].shape[1]}, K={FED_K}, sharded=True) on "
        f"the one-rank mesh: theta and losses bit-equal to the one-process "
        f"route, launches per step {per_step}; ms/step "
        f"{[round(x, 3) for x in ranked['ms']]} (one process "
        f"{[round(x, 3) for x in one['ms']]})")
    return totals


def _nccl_fed_step(dev, mesh) -> None:
    """Phase 14 (b): ``make_fed_step`` on the one-rank mesh (reduced
    Llama-3.2-1B, K = FED_K, RFA under the attack, coin 1 then 0), each
    step from the one-process chain's state (``_fed_chain``): losses, v
    and θ bit-equal to the one-process steps, no kernel launch."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed import fed_trainer as ft
    cfg = reduced(get_config(FED_ARCH))
    fed = ft.FedConfig(aggregator="rfa", **FED_KW)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 32, 2, FED_K, seed=1),
                         device=dev)
    mask = torch.arange(FED_K, device=dev) < FED_BYZ
    recs = {}
    for who, m, est in (("one", None, "_estimate"),
                        ("mesh", mesh, "_estimate_placed")):
        recs[who] = {}
        _fed_chain(cfg, fed, dev, FED_K, m, (True, False), pipe.batch, mask,
                   FED_SEED, _fed_recorder(dev, recs[who], est))
    one, ranked = recs["one"], recs["mesh"]
    keys = ("losses", "v", "theta")
    bad = [k for k in keys if not _same_bits(
        [[b for _, b, _ in x] for x in ranked[k]] if k != "losses"
        else ranked[k],
        [[b for _, b, _ in x] for x in one[k]] if k != "losses"
        else one[k])]
    if any(any(c.values()) for c in one["launches"] + ranked["launches"]):
        bad.append(f"kernel launches {ranked['launches']}")
    if bad:
        raise AssertionError(f"phase 14 (b) make_fed_step: {bad} differ")
    log(f"[nccl] {card()}: make_fed_step on the one-rank mesh (reduced "
        f"{FED_ARCH}, K={FED_K}, rfa, coins 1 then 0, from the one-process "
        f"chain's state): losses {ranked['losses']}, v and theta bit-equal "
        f"to fed_train_step; ms/step {[round(x, 3) for x in ranked['ms']]} "
        f"(one process {[round(x, 3) for x in one['ms']]})")


def _serve_gaps(mesh_out, plain) -> list:
    """Where the mesh route's logits, tokens and cache differ from
    ``_plain_serve``'s, bit for bit."""
    import torch
    from repro_torch.carriers import placed
    from repro_torch.core.tree import tree_paths
    bad = [i for i, (a, b) in enumerate(zip(mesh_out["logits"],
                                            plain["logits"]))
           if not torch.equal(placed.local(a), b)]
    bad += [f"token {i}" for i, (a, b) in enumerate(
        zip(mesh_out["tokens"], plain["tokens"]))
        if not torch.equal(placed.local(a), b)]
    bad += [p for (p, a), (_, b) in zip(tree_paths(mesh_out["cache"]),
                                        tree_paths(plain["cache"]))
            if not torch.equal(placed.local(a), b)]
    return bad


def _nccl_serve(dev, mesh) -> dict:
    """Phase 14 (b): ``make_serve_fns`` on the one-rank mesh for
    Llama-3.2-1B at full width, NCCL_SERVE_LAYERS layers, against
    ``model.prefill``/``decode_step``: logits, tokens and every cache leaf
    bit for bit, one flash launch a layer on each (held against the plain
    version on its own inputs). Returns the mesh run's launches."""
    from repro_torch.kernels import dispatch
    from repro_torch.models.model import init_params
    cfg = _serve_mesh_cfg(NCCL_SERVE_LAYERS)
    params = init_params(cfg, SERVE_MESH_SEED, device=dev)
    tokens = _serve_mesh_tokens(cfg, dev)
    out = _serve_one_rank(cfg, params, tokens, dev, mesh)
    dispatch.reset_launches()
    plain = _plain_serve(cfg, params, tokens, SERVE_MESH_STEPS)
    plain_flash = dispatch.launch_counts()["flash_attention"]
    bad = _serve_gaps(out, plain)
    flash = out["launches"]["flash_attention"]
    if bad or not flash == plain_flash == cfg.n_layers:
        raise AssertionError(f"phase 14 (b) serving: differs at {bad}; "
                             f"flash {flash}, plain {plain_flash}")
    log(f"[nccl] {card()}: make_serve_fns on the one-rank mesh "
        f"({SERVE_MESH_ARCH} full width, {cfg.n_layers} layers, "
        f"B={SERVE_MESH_B} x S={SERVE_MESH_S}, {SERVE_MESH_STEPS} greedy "
        f"steps): logits, tokens and every cache leaf bit-equal to "
        f"model.prefill/decode_step, flash launches {flash}; prefill "
        f"{out['prefill_ms']:.3f} ms, decode median "
        f"{_median(out['ms']):.3f} ms")
    return {k: n for k, n in out["launches"].items() if n}


def _flat_bits(r) -> dict:
    return {a: {k: v[k] for k in ("theta", "losses", "launches")}
            for a, v in r.items()}


def _flat_ms(r) -> list:
    return [x for v in r.values() for x in v["ms"]]


def _flat_launches(r) -> list:
    return [c for v in r.values() for c in v["launches"]]


def _block_bits(r) -> dict:
    return {"losses": r["losses"], "launches": r["launches"],
            **{k: [[blk for _, blk, _ in x] for x in r[k]]
               for k in ("v", "theta")}}


def _tp_bits(r) -> dict:
    return {k: r[k] for k in ("logits", "tokens", "launches")}


def _nccl_multi_card(dev) -> dict:
    """Phase 14 (c): 10c (b), 10e and 11 (c) over NCCL_CARDS cards, one
    rank a card, over gloo (host-staged) and over NCCL from the same
    inputs: each rank's results bit-equal between the two, both held
    against the one-process route (run once, beside the gloo ranks) by
    the phase's own checks and tolerances, each rank's peak within its
    reckoning among them; the ranks' ms per step logged beside the one
    process's. Returns the launches."""
    routes = {"10c (b)": (_fed_two_ranks_spawn, phase_fed_two_ranks, (),
                          _flat_bits, _flat_ms, _flat_launches),
              "10e": (_fed_blocks_spawn, phase_fed_blocks, ("10e",),
                      _block_bits, lambda r: r["ms"],
                      lambda r: r["launches"]),
              "11 (c)": (_serve_tp_spawn, phase_serve_mesh_tp,
                         (SERVE_TP_ARCHS[0],), _tp_bits, lambda r: r["ms"],
                         lambda r: [r["launches"]])}
    totals = {}
    for label, (spawn, phase, extra, bits, ms, counts) in routes.items():
        t0 = time.perf_counter()
        runs = {"gloo": spawn(dev, *extra, "gloo")}
        # the NCCL ranks are held against the same one-process run
        runs["nccl"] = runs["gloo"][:-2] + spawn(
            dev, *extra, "nccl", one_process=False)[-2:]
        differ = [r for r, (a, b) in enumerate(zip(runs["gloo"][-2],
                                                   runs["nccl"][-2]))
                  if not _same_bits(bits(a), bits(b))]
        if differ:
            raise AssertionError(f"phase 14 (c) {label}: ranks {differ} "
                                 f"differ between gloo and NCCL")
        # the gloo check counts the one-process run's launches and its
        # ranks'; the NCCL ranks' are added here
        _add(totals, phase(dev, *extra, "gloo", runs["gloo"]) or {})
        phase(dev, *extra, "nccl", runs["nccl"])
        for r in runs["nccl"][-2]:
            for c in counts(r):
                _add(totals, c)
        steps = {b: [[round(x, 3) for x in ms(r)] for r in run[-2]]
                 for b, run in runs.items()}
        log(f"[nccl] {card()}: multi-card {label}, one rank a card on "
            f"{NCCL_CARDS} cards: each rank bit-equal over gloo and NCCL; "
            f"rank ms per step NCCL {steps['nccl']}, gloo {steps['gloo']}, "
            f"one process {[round(x, 3) for x in ms(runs['gloo'][0])]}; "
            f"the ranks' wall NCCL {runs['nccl'][-1]:.1f} s, gloo "
            f"{runs['gloo'][-1]:.1f} s; {time.perf_counter() - t0:.1f} s")
    return totals


def phase_nccl(dev) -> dict:
    """Phase 14: (a) a one-rank group joined through ``init_distributed``
    in this process (NCCL on the card, on cuda:0), a ("data", "model") =
    (1, 1) mesh on it: ``gather_over`` on each mesh dimension and from a
    backward, and the host objects over the gloo group beside it; (b) on
    that group, 10c (b)'s flat RFA steps, ``make_fed_step`` and
    ``make_serve_fns`` bit-equal to the one-process route; (c) with two
    cards or more, :func:`_nccl_multi_card`, else one line saying it did
    not run. Returns the launches."""
    import torch
    import torch.distributed as dist
    from repro_torch.analysis.memcheck import free_port
    from repro_torch.distributed import init_distributed
    from repro_torch.launch.mesh import make_debug_mesh
    t0 = time.perf_counter()
    rank_dev = init_distributed(f"localhost:{free_port()}", 1, 0,
                                timeout_s=FED_RANK_TIMEOUT_S,
                                device=dev.type, group_of_one=True)
    totals = {}
    try:
        backend = dist.get_backend()
        log(f"[nccl] the rank's device: {rank_dev}")
        log(f"[nccl] the group's backend: {backend}")
        cuda = dev.type == "cuda"
        if (backend, rank_dev) != (("nccl", torch.device("cuda", 0)) if cuda
                                   else ("gloo", torch.device("cpu"))):
            raise AssertionError(f"phase 14 (a): {backend} on {rank_dev}")
        mesh = make_debug_mesh(1, 1, device_type=dev.type)
        _nccl_gathers(rank_dev, mesh)
        _nccl_host_objects(rank_dev)
        _add(totals, _nccl_flat_rfa(rank_dev, mesh))
        _nccl_fed_step(rank_dev, mesh)
        _add(totals, _nccl_serve(rank_dev, mesh))
    finally:
        _leave_rank()
    log(f"[time] phase 14 (a, b) {time.perf_counter() - t0:.1f} s")
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cards < NCCL_CARDS:
        log(f"[nccl] multi-card: not run ({cards} card"
            f"{'s' if cards != 1 else ''})")
        return totals
    t0 = time.perf_counter()
    _add(totals, _nccl_multi_card(dev))
    log(f"[time] phase 14 (c) {time.perf_counter() - t0:.1f} s")
    return totals


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file() \
            or not (ROOT / "examples_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} or "
              f"{ROOT / 'examples_torch'} is missing; run from a checkout "
              f"of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    from repro_torch.analysis.retrace import BuildWatch
    watch = BuildWatch().__enter__()        # build-once, over the script
    phase_card()
    phase_build()
    t0 = time.perf_counter()
    rows = phase_kernels(dev)
    rows.update(phase_cw_kernels(dev))
    log(f"[time] phase 3 aggregation kernels {time.perf_counter() - t0:.1f} "
        f"s")
    t0 = time.perf_counter()
    rows.update(phase_flash(dev))
    log(f"[time] phase 3 flash {time.perf_counter() - t0:.1f} s")
    log_kernel_rows(rows)
    t0 = time.perf_counter()
    phase_train_attention(dev)
    lm_totals = phase_lm_loss_full_width(dev)
    log(f"[time] phase 3b {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fed_totals = phase_fed(dev)
    log(f"[time] phase 10 federated training {time.perf_counter() - t0:.1f} "
        f"s")
    totals = phase_main_path(dev)
    _add(totals, lm_totals)
    _add(totals, fed_totals)
    phase_cpu_agreement(dev)
    byzpg_totals, byzpg_out = phase_byzpg(dev)
    _add(totals, byzpg_totals)
    phase_byzpg_cpu_agreement(dev)
    t0 = time.perf_counter()
    _add(totals, phase_transformer_policy(dev))
    log(f"[time] phase 6b {time.perf_counter() - t0:.1f} s")
    exp_totals, exp_cells = phase_experiment(dev)
    _add(totals, exp_totals)
    _add(totals, phase_sweep(dev, exp_cells["fig5_byzpg"]))
    _add(totals, phase_lanes(dev))
    _add(totals, phase_telemetry(dev))
    t0 = time.perf_counter()
    _add(totals, phase_serving(dev))
    log(f"[time] phase 5 serving runs {time.perf_counter() - t0:.1f} s")
    phase_serving_cpu_agreement(dev)
    _add(totals, phase_serve_mesh(dev))
    t0 = time.perf_counter()
    phase_moe_cpu_agreement(dev)
    log(f"[time] MoE/MLA card-vs-CPU check {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_recurrent_cpu_agreement(dev)
    log(f"[time] recurrent card-vs-CPU check {time.perf_counter() - t0:.1f} "
        f"s")
    _add(totals, phase_checkpoint(dev, byzpg_out))
    _add(totals, phase_analysis(dev))
    _add(totals, phase_examples(dev))
    _add(totals, phase_nccl(dev))
    watch.__exit__(None, None, None)
    found = watch.findings(dev, "chip_smoke.py")
    if found:
        from repro_torch.analysis.findings import render
        raise AssertionError(f"phase 12 build-once:\n{render(found)}")
    log(f"[analysis] build-once over the script: build() calls "
        f"{watch.builds} (seconds of nvcc each, 0.0 where the library was "
        f"found built), library loads {watch.loads}")
    from repro_torch.kernels import dispatch
    missing = [name for name in dispatch.kernels()
               if totals.get(name, 0) <= 0]
    if missing or set(dispatch.kernels()) != set(REPLACES):
        raise AssertionError(f"kernels never launched on a path: {missing}; "
                             f"registered {sorted(dispatch.kernels())}")
    for m in ("jax", "repro"):
        if m in sys.modules:
            raise AssertionError(f"{m} was imported")
    kernels = []
    for name in REPLACES:
        head = rows[(name, HEADLINE[name])]
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCES.get(name, SOURCE),
            "replaces": REPLACES[name], "launches": totals[name],
            "max_abs_err": max(r["err"] for (n, _), r in rows.items()
                               if n == name and not r["large"]),
            "ms": head["ms"], "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library_device_ms": head["library_device_ms"]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fed-rank"]:
        sys.exit(fed_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--fed-tree-rank"]:
        sys.exit(fed_tree_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--fed-block-rank"]:
        sys.exit(fed_block_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--serve-rank"]:
        sys.exit(serve_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--serve-tp-rank"]:
        sys.exit(serve_tp_rank_main(sys.argv[2:]))
    sys.exit(main())
