"""Drive the PyTorch/H100 port (ray_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a card. Phases, each
printing its own lines; any failure raises and exits non-zero before the last
line:

1. device: the card's name and power limit (nvidia-smi) and torch's name.
2. build: nvcc builds the flash-attention kernels from ops/csrc (time and
   -Xptxas -v output), then each bf16 kernel's registers, shared memory and
   blocks per SM at the main head width, and each f32 kernel's at every
   head width, as the card's runtime reports them.
3. kernels vs plain: each kernel against its plain PyTorch version on the same
   inputs, bf16 and f32 at the main path's shapes plus edge cases, with the
   port's own bars (ops/attention.py MATCH_TOL); the forward without LSE
   (the no-grad path) must give the same output as with it, and a second
   backward on the same inputs the same dq, dk and dv bit for bit (no
   atomics).
4. main path: the flagship transformer at full width (bench.py's TPU config,
   ~168M params, random weights from a seed) trains on one fixed batch through
   init_params / adamw / make_train_step; the loss must be finite and fall and
   every kernel must have been launched 8 times per step. Three more steps
   run under torch.profiler: each flash kernel's device time per step and the
   device-busy share of a step. Then the config's defaults (fused loss,
   remat): a warm-up step, three timed steps and one profiled step.
5. timings: each kernel, its plain version and one PyTorch library call for
   the same function, with CUDA events, beside the card's bound.
6. serve: the serving path (models/generate.py, serve/llm) at the flagship
   config. bf16 function checks: ragged prefill's last-row logits against
   forward (the flash kernel) on each row's own prompt, and the paged decode
   chunk against the dense one on the same cache contents, both within the
   kernel bars. f32 engine exactness: at full width and 2 layers, with a pool
   small enough to preempt, every greedy request's tokens equal generate()'s.
   bf16 traffic at full width and depth: 16 closed-loop streams over 8 slots
   until 48 requests finish (a shared 64-token system prefix, seeded
   suffixes, geometric output lengths, a quarter sampled); prints output
   tokens/s, TTFT p50/p99, TPOT, the decode tick, the prefix hits,
   preemptions, KV pool and peak memory, then profiles ~20 decode ticks with
   every slot busy (device-busy share, by kind of kernel). Every greedy
   request is then teacher-forced through forward: each emitted token's
   logit must lie within SERVE_LOGIT_BAR of its row's maximum.
7. trainer: the port's runtime and trainer drive the main path's train step
   in a worker process: ray_tpu_torch.init(num_cpus=4, num_gpus=1), then
   TorchTrainer(train_loop, ScalingConfig(num_workers=1, use_gpu=True)).fit()
   with the flagship loop (ray_tpu_torch/train/flagship_loop.py, the port of
   bench.py's train_loop) at the main path's config, weights from seed 0 and
   the batch from seed 1: two warm-up steps, then ABBA-ordered raw and
   framework chunks of 8 steps, then 3 steps under torch.profiler in the
   worker. Prints the worker's card, its own kernel launch counts, its first
   loss beside the main path's, framework and raw tokens/s and their ratio,
   its device ms per step by kind and its device-busy share (the profiled
   device time over the raw step), its peak memory and the time from init()
   to its first report; fails unless the card is the driver's, each kernel
   ran 8x per step in the worker, the first loss is the main path's within
   TRAINER_LOSS_RTOL, the loop ran in a process of its own, and shutdown()
   leaves neither that process nor any other worker behind. In the same
   cluster, "moe trainer": the loop at the moe train phase's config for a
   few steps, with the same checks against that phase's first loss.
8. moe train: the flagship widths with 8 experts (top-1, capacity factor
   1.25: 160 slots per row and expert; ~653M params, ~554M of them expert
   weights), bf16, batch 12 x 1024, unfused loss, no remat. The first loss,
   forward only on the initial weights, with the kernels and with their plain
   versions on the card: the two within MOE_LOSS_RTOL, and the share of
   (token, layer) expert choices that agree printed and held to
   MOE_ROUTING_AGREE. Then 2 warm-up, 8 timed and 3 profiled steps: step ms,
   tokens/s, peak memory, 8 launches per kernel per step, device ms by kind
   and for each part of the expert layer (route, dispatch, experts, combine,
   weight casts; forward and backward).
9. moe serve: the serve phase's functions at the moe config: prefill and
   paged decode in f32 (bf16 rounding flips near-tied expert choices, which
   no bar on logits survives), the f32 engine against generate(), and bf16
   traffic cut to MOE_TRAFFIC_REQUESTS requests; its teacher-forced check
   counts the tokens beyond SERVE_LOGIT_BAR and holds their share to
   MOE_SERVE_BEYOND.
10. zoo: ViT-B/16 inference (224^2, batch 64, bf16; 12 forward-kernel
   launches a batch), its logits against the same model on the kernels'
   plain versions, images/s; the forward kernel at ViT's shape (B 64, T 197,
   H 12, D 64, non-causal) timed against its plain version and SDPA, beside
   its bound; ResNet-50 inference (224^2, batch 64, bf16, eval), images/s;
   and a few MNIST-MLP train steps.
11. parallel: parallel/ on a one-card mesh (a world-1 NCCL group; one card
   allows no mesh of more ranks). Ring attention's chunk function at sp = 4's
   offsets on the flagship's attention (chunks of B 12 x 256 x H 8 x D 128,
   bf16): the diagonal (causal) and a chunk below it (non-causal, with the
   LSE) through the forward kernel against the plain chunk under MATCH_TOL,
   the masked chunk launching nothing; that non-causal LSE launch timed
   against its plain version and aten's flash attention with its LSE, beside
   its bound. Then, counted as the phase's path: ring_attention (causal and
   not) and ulysses_attention forward and backward at sp = 1 on the full
   [12, 1024, 8, 128] against flash_attention; the flagship dense train step
   on the mesh (make_train_step(mesh=...), params placed by their logical
   axes), its first loss against the main path's within SHARDED_LOSS_RTOL
   and 8 launches per kernel per step, its step ms beside the main path's;
   pipeline_apply at pp = 1 with one flagship layer as the stage, equal to
   the layer; save_sharded and restore_sharded of the trained params and
   AdamW state, equal bit for bit. (The trainer phase also runs the loop on
   the worker's session.get_mesh(): "mesh trainer".)

12. a10: collectives, device objects and compiled graphs in one cluster,
   ray_tpu_torch.init(num_cpus=4, num_gpus=1). An actor forms a world-1
   NCCL group (util/collective, backend "nccl"): allreduce, allgather,
   reducescatter, broadcast and barrier on 4M-element bf16 and f32 CUDA
   tensors, each result on cuda and equal to its input, ms per call. Weight
   sync: a holder actor returns the flagship's parameters (seed 0, 168.3M)
   as one 673 MB f32 CUDA tensor under tensor_transport="collective"; its
   own resolve is the same data_ptr; device_object.broadcast over a 2-member
   group, then the consumer's get; one broadcast over a 3-member group to
   two consumers, then their gets; each copy's bits checked on the card by
   checksums (no host copy in the driver), on cuda; the store's used bytes
   flat and no host transfer or host-sync fallback in any process; seconds
   and GB/s of each handoff. Spill and restore under
   devobj_resident_limit_bytes (256 MiB), bit for bit. Then the MPMD
   pipeline (parallel/mpmd_pipeline.py): 2 stage actors of 4 flagship layers
   each (bf16), the embedding of 16 seeded sequences of 1024 tokens in
   microbatches of 2, at M = 8 and M = 2: output equal to the driver's
   in-process composition of the stage function bit for bit, 4 x M
   forward-kernel launches per stage (each stage's own counters),
   microbatches/s, bubble fraction, each stage's busy, stall and other
   (emit) ms and its device span (CUDA events around each run), a hop's
   bytes and ms, stage_devobj_stats(); no store bytes or host transfers in a
   steady run; stage 0 alone on one microbatch (issue and finish ms, its
   kernels' device ms under torch.profiler); teardown leaves no resident
   device object. An "a10: {...}" line (with each section's seconds); the
   kernels line's forward row gets "mpmd_launches".

13. serve app: the serve phase's model and engine (bf16, 8 slots, blocks of
   16, prefill chunks of 128; weights from seed 0 in every process) behind
   ray_tpu_torch.serve in one cluster, init(num_cpus=4, num_gpus=1), then
   serve.start(). (a) A monolithic LLMDeployment at half the card, route
   /llm: 4 greedy prompts over SSE, one at a time, equal to an in-process
   LLMEngine on the same card; the first again buffered ("stream": false)
   equal to its SSE twin; the traffic's first 24 requests from 16
   closed-loop SSE clients (output tokens/s, TTFT p50/p99 and TPOT on the
   client's clock, beside the serve phase's in-process numbers; the
   replica's get_stats()); a client that closes its socket after 3 tokens
   frees its slot and blocks (the pool idle again); every greedy token
   teacher-forced through forward under SERVE_LOGIT_BAR. (b) After
   serve.delete, disaggregated_llm_app: a prefill and a decode replica at
   half the card each, cluster_prefix on; an engine in this process first
   publishes the shared 64-token prefix (4 blocks) to the cluster tier.
   Two of (a)'s prompts again, one at a time (tokens equal to (a)'s; TTFT
   and the gap between tokens beside (a)'s), then the traffic's first 12
   requests: each greedy request's tokens equal the monolithic app's, every
   request's first token too (sampled ones included: it is the prefill
   replica's), every request handed off (imports = exports, none failed),
   the prefill replica's prefix-import hits > 0, the object store's used
   bytes unchanged, each handoff's blocks, bytes and ms (from the
   llm_kv_handoff flight events), the teacher-forced check; the handoff
   again in this process (a plain, a prefill-role and a decode-role engine,
   each sampling row recorded): the imported blocks equal the plain
   engine's bit for bit, and the token and the logits row where the two
   runs part are printed (the decode side computes the first token's row
   through a one-row prefill chunk where the monolithic engine runs the
   decode step: sampled tokens may part there; ROADMAP C7). After
   serve.shutdown(): no llmprefix/ row in the GCS KV, no Serve process (the
   controller, the proxy, the replicas) alive, no resident device object in
   this process. A "serve app: {...}" line with each part's seconds.

14. data: ray_tpu_torch.data on the card, in one cluster,
   init(num_cpus=4, num_gpus=1). (a) Ingest: 192 seeded token sequences of
   1,025 tokens (seed 1) from_numpy in 8 blocks, map_batches splitting
   inputs and targets, random_shuffle(seed=0), passed as
   TorchTrainer(datasets={"train": ...}) to a GPU worker running
   flagship_loop.dataset_loop at the main path's config (weights from seed
   0): one epoch of iter_torch_batches(batch_size=12, drop_last=True), 16
   steps. Fails unless every batch arrived on the worker's card, each
   kernel ran 8 times a step in the worker's counters, the first loss is the
   driver's in-process step on take_batch(12) of the same dataset within
   TRAINER_LOSS_RTOL, 192 distinct rows were consumed, and no worker
   outlives shutdown(). Prints the step's median ms (CUDA events), tokens/s
   and the ms per step spent in next() on the iterator, beside the trainer
   phase's raw step. (b) Batch inference: ViT-B/16 (224^2, bf16 on f32
   weights from seed 0) in a Checkpoint; 256 seeded uint8 images in 4
   blocks, normalised by map_batches, scored by BatchPredictor(TorchPredictor)
   in batches of 64 by one actor holding the card. Fails unless the logits
   equal the in-process ViT's on the same images within VIT_LOGIT_RTOL, the
   forward kernel ran 12 times a batch in the actor (48), and the object
   store's used bytes are back where they started once the predictions are
   released. Prints images/s end to end and in the actor, beside the zoo
   phase's. A "data: {...}" line with each part's seconds; the kernels
   line's rows get "data_launches".

15. rllib: ray_tpu_torch.rllib on the card. (a) PPO on the port's numpy
   CartPole-v1 at tests/test_rllib.py's config (2 rollout workers x 4 envs
   on the CPU, train_batch_size 2048, minibatches of 256, 8 SGD iterations,
   lr 3e-4, entropy_coeff 0.01, seed 0) in one cluster, init(num_cpus=4,
   num_gpus=1), with one learner actor holding the card
   (.resources(num_learners=1, num_gpus_per_learner=1)). The first round by
   hand: one sample, then every minibatch update on the learner actor and on
   an in-process learner on this card from the same weights (total_loss,
   grad_norm and kl within RLLIB_ROUND_RTOL, the weights after the round
   compared); then Algorithm.step to the reference's bar (episode_reward_mean
   120 within 20 iterations), compute_single_action in {0, 1}, and no worker
   left after shutdown(). Prints env steps/s, sample ms, the learner round and
   the ms of a minibatch update (actor and in-process), the weight sync and
   the iterations to the bar. (b) The learner at the Atari module's shape
   (RLModuleSpec.from_spaces(Box(0, 1, (84, 84, 4)), Discrete(6)): convs
   (16, 8, 4), (32, 4, 2), (64, 3, 1), hiddens (64, 64)) in this process on
   one seeded synthetic batch of 2000 rows (226 MB of f32 frames): one PPO
   round of 8 SGD iterations of minibatches of 128, with TF32 switched on
   around it (the learner's scoped flag keeps its update in full f32); the
   first minibatch's metrics against the same learner on the CPU within
   RLLIB_ATARI_RTOL and its gradients within RLLIB_ATARI_GRAD_RTOL, and a
   control with TF32 allowed whose gradients must part by more than that; ms a minibatch update, samples/s, peak memory, and one
   profiled update's device ms by kind. (c) The Decision Transformer at
   tests/test_rllib_algorithms.py's settings (batch 64, context 20, embed 64,
   2 layers, 2 heads, 150 updates an iteration, seed 0), f32 on the card, on
   the scripted-expert data written with the port's JsonWriter: one forward
   and backward of its loss on the kernels against their plain versions
   (MATCH_TOL's f32 bars over the loss and every gradient) launching each
   kernel twice, then training to the reference's bar (120 within 4
   iterations) with every launch counted (2 of each kernel an update, 2
   forwards an evaluation step), ms an update; and the forward kernel at DT's
   shape (f32 B 64, T 60, H 2, D 32, causal, with LSE) against its plain
   version, SDPA in f32 and its bound at the f32-accurate rate of its route
   (3xTF32, every f32 kernel's: a third of the TF32 tensor-core peak), and
   the dK/dV and dQ kernels there likewise (beside
   the plain backward and SDPA's backward in f32, each computing dq, dk and
   dv), each on the device (a CUDA graph of 50 calls replayed: a call at
   this shape takes its wrapper's host time, longer than its kernel) and a
   call at a time; then the three f32 kernels at the main path's shape (B
   12, T 1024, H 8, D 128) the same way. An "rllib: {...}" line; the
   kernels line gains rows "flash_fwd_dt", "flash_bwd_dkv_dt",
   "flash_bwd_dq_dt", "flash_fwd_f32", "flash_bwd_dkv_f32" and
   "flash_bwd_dq_f32"; the "_dt" rows
   carry DT's launches as "launches" and "rllib_launches" (the f32 kernels'),
   the "_f32" rows none (no path runs the f32 kernels at the main path's
   shape), and the other rows' "rllib_launches" are 0. In (a)'s cluster,
   init(num_cpus=12, num_gpus=1), before DT: (d) the Podracer weight sync:
   IMPALA on CartPole with weight_sync="device_broadcast" from a learner
   actor holding the card, 2 CPU samplers, 3 iterations, a resize to 4 and
   back to 2 (two iterations after each); fails unless the sync is ready, the
   holder's bcast_sends rise by one or more an iteration, every sampler's
   bcast_recvs rise and its host_sync_fallbacks stay flat (after the first
   post-resize iteration), every sampler's packed weights hash to the
   learner's, and the roster lists exactly the live ranks; prints a sync's
   ms on each transport, then the Atari module's packed weights (on the card)
   broadcast to 4 host-pinned members of a weight group beside 4 host ships
   of its params tree (ms, bytes, bit-equal on the CPU). (e) DQN at
   DQNConfig's defaults for 2 iterations on the card (env steps/s, ms an
   update), one double-Q prioritized update at the Atari module's shape
   (batch 32) against the CPU with RLLIB_ATARI_RTOL and
   RLLIB_ATARI_GRAD_RTOL and the TF32 control, then SimpleQ for an
   iteration, its loss finite. (f) R2D2 at R2D2Config's defaults for an
   iteration, its first update's loss and gradients against the CPU at the
   same bars, ms an update. (g) Ape-X DQN (2 explorers, 2 shards), PG, A2C
   and A3C (the learner or the apply step on the card) and DD-PPO (2 CPU
   workers, digests equal), built together on threads (their worker
   processes start at once), then an iteration each. (h) The continuous
   family at each config's defaults (RLLIB_CONTINUOUS): SAC on the port's
   Pendulum-v1 for 2 iterations (env steps/s, ms acting a step, ms an
   update), its first update on the card against the same update on the CPU
   from the same weights, batch and draws (RLLIB_ATARI_RTOL on the metrics,
   RLLIB_ATARI_GRAD_RTOL on the gradients, TF32 switched on around it, and
   the TF32 control outside the gradient bar); TD3 for 2 iterations, the
   actor, its Adam moments and the targets moving on every second update
   only; CQL (200 updates) on a Pendulum dataset written by the port's env,
   its first update held to the CPU's likewise, both terms finite; CRR (exp
   weights) on 60/40 expert/random CartPole data, losses finite, greedy
   reward; Ape-X DDPG with 2 explorers pinned to the host and the learner on
   the card for 2 iterations, the first learner step with non-uniform
   importance weights (its weighted critic loss, TD errors and gradients)
   held to the CPU's likewise, the explorers' packed weights hashing to the
   learner's after a sync; MADDPG on a 2-agent 1-D spread for 2 iterations,
   its first update held to the CPU's likewise. (i) The model-based and
   meta-learning family at each config's defaults (RLLIB_MODEL_BASED):
   DreamerV3 on Pendulum-v1 and on CartPole-v1 for 3 iterations (env steps/s,
   ms acting a step, ms an update by CUDA events), its first update on the
   card held to the same update on the CPU from the same weights, batch and
   draws (the metrics, the world model's, actor's and critic's gradients;
   TF32 control); MAML on PointGoalEnv with 2 CPU rollout actors, its first
   second-order meta-update held to the CPU's likewise, ms a meta-update;
   MBMPO, its first ensemble update held likewise, one imagined rollout
   against the CPU's within RLLIB_ATARI_GRAD_RTOL, ms an ensemble update and
   an imagined batch; a "(i): {...}" line. (j) The lighter algorithms at
   the reference tests' configs (RLLIB_LIGHT): BC and MARWIL on
   tests/test_rllib.py's offline data written by the port's JsonWriter, the
   learner on the card, its first update held to the CPU's (TF32 control),
   ms an update, the expert's action on 50 probes after 60 and 80
   iterations (bars 45 and 40); QMIX on the two-step game, its first train
   step held likewise, ms a train step, the best reward within 15 iterations
   (bar 7.5); SlateQ on SlateRecEnv for 3 iterations, its first update held
   likewise, one replay batch's greedy slates on the card against the CPU's
   (near-ties counted, no other row may differ), ms an update and an acting
   step; ES and ARS with 2 CPU worker actors pinned to the host for 2
   iterations (s an iteration, env steps/s), compute_single_action on the card
   against the CPU forward (equal actions, logits within RLLIB_ATARI_RTOL);
   LinUCB and LinTS on a 2-arm context bandit in a process that sees no card
   and cannot import gymnasium (mean reward > 0.8); a "(j): {...}" line. (k) The MCTS family
   at the reference tests' configs (RLLIB_MCTS): AlphaZero on CartPole-v1,
   LeelaChessZero on tic-tac-toe and the AlphaStar league on
   rock-paper-scissors for 2 iterations each, each first update on the card
   held to the same update on the CPU (the Atari check's bars, the TF32
   control), LC0's masked forward against the CPU's, ms of a search
   expansion's forward and read (host clock and CUDA events), ms an update,
   self-play env steps/s; then the profiler probe of ROADMAP O3 (adds
   under torch.profiler on this thread and a fresh one, device events
   counted); a "(k): {...}" line. (l) The external path (RLLIB_EXTERNAL): a
   PolicyServerInput serving DQN's compute_single_action on the card to 2
   PolicyClient threads playing the port's CartPole-v1 (get_action/s, ms a
   get_action, the served actions equal to a CPU copy's greedy ones), DQN
   trained on those episodes, and `python -m ray_tpu_torch.rllib train --run
   PPO --env CartPole-v1 --stop-iters 1` in a subprocess (exit 0); a
   "(l): {...}" line. Every flash launch in this process over (d)-(l) is
   counted: the kernels line's rows carry the count as
   "rllib_families_launches" (0: these paths compute no attention).

16. tune: ray_tpu_torch.tune on the card, in a cluster of its own,
   init(num_cpus=8, num_gpus=1). (a) Tuner(TorchTrainer) over the flagship
   loop at the trainer phase's config (bf16, batch 12 x 1024) and the moe
   trainer's depth (2 warm-up steps, one round of 4-step chunks), a grid
   of param_seed 0 and 1, each trial's worker holding half the card
   (ScalingConfig(num_workers=1, use_gpu=True, resources_per_worker={"GPU":
   0.5})): fails unless both trials finish on this card, each launched its
   steps x 8 of every kernel, param_seed 0's first loss is the main path's
   within TRAINER_LOSS_RTOL and the two loops overlap in time; prints each
   trial's framework and raw tokens/s beside the trainer phase's raw rate
   alone and its seconds from fit() to its last step. (b) PBT of the
   flagship at full width: a function trainable (pbt_trainable) trains
   chunks of 8 steps on the fixed batch with AdamW at its trial's lr and
   every second iteration writes a directory checkpoint (the parameters and
   AdamW's state through torch.save, every tensor's bit checksums and a
   forward's loss in its metadata); population 4 (lr ~ loguniform(1e-4,
   3e-3), searcher seed 1), resources_per_trial {"CPU": 1, "GPU": 0.5} and
   max_concurrent_trials 2 (two trials at a time; an exploited trial
   restarts in its own half), PopulationBasedTraining(perturbation_interval=2,
   quantile_fraction=0.25, seed 0), stop at iteration 6; checkpoints no
   trial holds are deleted as the sweep goes. Fails unless an exploit
   happens, after each the restored tensors' checksums equal the donor's and
   the first forward loss equals the donor's within TRAINER_LOSS_RTOL,
   every loss is finite, the best trial's last loss is below its first, and
   each trial process's launches, read from its last result (the one that
   meets the stop included), equal its steps x 8 (flash_fwd: 8 more for
   each forward outside a step, a checkpoint's or the restore's) with its
   steps its results x 8; prints the sweep's seconds, each trial's tokens/s and peak memory, the
   exploits, a checkpoint's bytes and save and load seconds, each restart's
   seconds (exploit to the restarted trial's first result) and the
   controller's host ms a result. (c) Tuner(PPO) on CartPole-v1 at
   tests/test_rllib.py's test_ppo_under_tune config (an lr grid of 2, 2
   iterations, 1 rollout worker x 2 envs) with each trial's learner actor
   holding half the card: 2 results, a best result, both learners on cuda.
   No worker outlives shutdown(). A "tune: {...}" line; the kernels line's
   rows get "tune_launches" (the trials' launches through each process's
   last result: the bf16 rows at the main path's shape carry them, the other
   rows 0; the chunk an exploited trial's process runs ahead of the
   controller is killed part-way and no result counts it).

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Without a card it exits 1 and prints neither.
Phases run in the order 1-6, 8, 9, 7 (the trainer runs in one cluster), 10,
11, 12, 13, 14, 15, 16.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import http.client
import itertools
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak, at 700 W
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core peak, at 700 W
MAIN = dict(B=12, T=1024, H=8, D=128)  # attention shapes of the main path
STEPS = 10  # timed train steps, after one warm-up step
PROFILED = 3  # further steps under torch.profiler, after the timed ones
KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
# Which design each kernel's numbers belong to, so a row that keeps an
# earlier time can be told apart: the bf16 functions, and the f32 ones.
DESIGNS = {"flash_fwd": "mma.sync-cp.async", "flash_bwd_dkv": "mma.sync-cp.async",
           "flash_bwd_dq": "mma.sync-cp.async"}
F32_DESIGNS = {"flash_fwd": "3xtf32-mma.sync-cp.async", "flash_bwd_dkv": "3xtf32-mma.sync-cp.async",
               "flash_bwd_dq": "3xtf32-mma.sync-cp.async"}
# The least time of an f32 function's work on the route its kernel takes:
# three TF32 tensor-core products for each f32 one (3xTF32).
F32_PEAKS = {"flash_fwd": PEAK_TF32_FLOPS / 3, "flash_bwd_dkv": PEAK_TF32_FLOPS / 3,
             "flash_bwd_dq": PEAK_TF32_FLOPS / 3}
F32_MAIN_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")  # timed at the main path's shape in f32 too
# Kinds of device work in a train step, by words in the kernel's name (the
# first group that matches; "other" for none).
PROFILE_GROUPS = (
    ("flash attention", ("rtt::",)),
    ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
    ("softmax", ("SoftMax", "softmax")),
    ("optimizer", ("multi_tensor", "Adam", "adam")),
    ("copy/cast", ("copy",)),
    ("elementwise/reduce", ("elementwise", "reduce")),
)


# The serving phase. bench.py's TPU config, as the main path (bench.py:44-72).
SERVE_CFG = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=8, n_kv_heads=8, d_ff=2816, max_seq_len=1024)
# Teacher-forced check of the bf16 traffic: the largest amount (in logits) by
# which forward's logit of an emitted greedy token may fall short of its
# row's maximum. Both sides' logits are bf16 products (the top ones, ~4 std
# above 0, lie on a grid of 2**-5); sound runs read one grid step, 0.03125.
# The bar is four steps. It is a sanity check only: it was set from sound
# runs and never read on a planted fault, and with random weights a token
# depends weakly on its context, so subtle scheduling faults may stay under
# it. The f32 exactness run (tokens equal to generate(), through prefix hits
# and preemptions at the traffic run's geometry) is the check for those.
SERVE_LOGIT_BAR = 0.125
TRAFFIC = dict(streams=16, requests=48, slots=8, block_size=16, prefill_chunk=128, prefix=64,
               suffix=(32, 448), mean_new=64, new=(8, 256), sampled_every=4)
# The f32 exactness run: prompts of the shared prefix + 32..192 tokens, 32..128
# new tokens each, and a pool (block 0 is the null block) small enough that
# decode runs it dry.
EXACT = dict(requests=8, suffix=(32, 193), new=(32, 129), num_blocks=65)
PROFILED_TICKS = 20
# The trainer phase: bench.py's loop shape at the main path's config
# (bench.py:44-71, as main_path_phase), a few rounds of 8-step chunks.
TRAINER = dict(warmup=2, rounds=4, chunk=8, lag=4, profile_steps=3)
# The worker's first loss against main_path_phase's: the same program on the
# same inputs in another process, so they differ only where a library picks
# another reduction order.
TRAINER_LOSS_RTOL = 1e-3
# The mixture-of-experts phases: SERVE_CFG's widths with 8 experts, top-1.
MOE = dict(num_experts=8, expert_capacity_factor=1.25)
MOE_TRAIN = dict(warmup=2, steps=8, profiled=3)
# The first loss with the kernels against the same forward on their plain
# versions (bf16): the attention outputs differ by the kernels' rounding, and
# a near-tied expert choice can flip between the two. Set from the card's
# readings: a relative difference of 1.84e-6, and 99.77% of the 98,304
# (token, layer) choices equal; the bars sit ~10x and ~4x away.
MOE_LOSS_RTOL = 2e-5
MOE_ROUTING_AGREE = 0.99  # least share of (token, layer) expert choices equal in the two runs
MOE_TRAFFIC_REQUESTS = 24  # the dense traffic's 48, cut to hold the script's wall time
# bf16 serving under experts: the engine's decode and forward's recomputation
# may route a near-tied token to different experts, so some emitted tokens
# fall short of forward's maximum by more than SERVE_LOGIT_BAR; the greatest
# share of greedy tokens that may. Readings: none of 928 on the card (the
# largest shortfall at the bar itself), 1 of 928 in a CPU run at a small width.
MOE_SERVE_BEYOND = 0.01
TRAINER_MOE = dict(warmup=2, rounds=1, chunk=4, lag=4, profile_steps=0)
# The zoo phase: batch 64 at 224^2 in bf16.
ZOO = dict(batch=64, image=224, batches=10, mlp_steps=20, mlp_batch=256)
VIT = dict(B=64, T=197, H=12, D=64)  # the forward kernel's shape in ViT-B/16
# ViT-B/16's logits on the kernel against the same model on the plain
# attention: rel_l2 over the [64, 1000] logits. Each of the 12 layers adds the
# kernel's bf16 rounding (rel_l2 ~2.3e-3 at this shape); the card read
# 1.13e-2, ~4x below the bar.
VIT_LOGIT_RTOL = 5e-2
# The parallel phase: ring chunks of the main shape at sp = 4 (rank 2's
# offsets), and the sharded step's first loss against the main path's: the
# same program on a world-1 mesh, whose collectives move nothing.
RING = dict(sp=4, rank=2)
SHARDED = dict(warmup=2, steps=5)  # the sharded step: warm-up steps (DTensor's first dispatches), then timed ones
SHARDED_LOSS_RTOL = 1e-6
TRAINER_MESH = dict(warmup=2, rounds=0, chunk=1, lag=1, profile_steps=0, mesh=True)
# The serve app phase: the serve phase's model and engine behind serve.run and
# HTTP. `exact` greedy prompts of `exact_new` tokens against an in-process
# engine; the traffic's first `requests` specs (the serve phase's 48, cut to
# hold the script's wall time) from `clients` SSE clients, the first
# `disagg_requests` of them again through the disaggregated pair.
SERVE_APP = dict(exact=4, exact_new=32, requests=24, disagg_requests=12, clients=16, replica_gpus=0.5,
                 disconnect_after=3)
# The data phase: `rows` token sequences of `seq` + 1 tokens (seed 1) in
# `blocks` blocks, batches of `batch` (one epoch: rows / batch steps); then
# `images` uint8 images (seed `seed`) in `image_blocks` blocks, scored in
# batches of `predict_batch`.
DATA = dict(rows=192, seq=1024, blocks=8, batch=12, images=256, image_blocks=4, predict_batch=64, seed=3)
# The rllib phase. (a) PPO on CartPole-v1 at tests/test_rllib.py's config
# (BASELINE.json's "RLlib PPO CartPole-v1": CPU rollout workers, the learner on
# the accelerator): the reference test's reward bar and iteration budget.
# (b) The learner at the Atari module's shape (84 x 84 x 4 frames, Pong's 6
# actions) on one synthetic batch of PPOConfig's default train_batch_size.
# (c) The Decision Transformer at tests/test_rllib_algorithms.py's settings,
# on its scripted-expert data (`dt_episodes` episodes).
RLLIB = dict(ppo_iters=20, ppo_bar=120.0, workers=2, envs=4, train_batch=2048, minibatch=256, sgd_iters=8,
             atari_rows=2000, atari_minibatch=128, atari_sgd_iters=8, dt_iters=4, dt_bar=120.0, dt_episodes=25,
             dt_updates=150, dt_timed=20)
# The Atari-shaped update on the card against the same update on the CPU: the
# learner runs its f32 convolutions and matmuls in full f32 inside a scoped
# flag (core/learner.py full_f32), so f32 summation order is the only
# difference. Two bars: the first minibatch's metrics (total_loss, grad_norm,
# policy_loss, vf_loss: relative difference) and its gradients (rel_l2 over
# all of them). A control computes the same gradients with TF32 allowed, not
# through the learner's flag: it must part from the CPU by more than the
# gradient bar, or the check could not tell TF32 from full f32. On an H100
# (PERF.md) the learner's update read at most 6.6e-7 on the metrics and 2.5e-7
# on the gradients; the TF32 control 1.5e-5 to 3.2e-5 and 5.9e-4. The batch
# means damp TF32's rounding, so the metrics' bar sits far below TF32's ~1e-3.
RLLIB_ATARI_RTOL = 3e-6
RLLIB_ATARI_GRAD_RTOL = 1e-5
# The remote learner's round against the in-process learner's on the same card,
# weights and minibatches: the same code on the same device.
RLLIB_ROUND_RTOL = 1e-5
DT_SHAPE = dict(B=64, T=60, H=2, D=32)  # DT's attention: batch 64, 3 x context 20, 2 heads of 32
# The rllib phase's Podracer, value-based and policy-gradient sections, in the
# PPO section's cluster. (d) IMPALA on CartPole with weight_sync=
# "device_broadcast" from a learner actor holding the card: `podracer_iters`
# iterations on 2 samplers, a resize to `podracer_grow` and back to 2 (two
# iterations after each); then the Atari module's packed weights broadcast to
# `atari_members` host-pinned members of a weight group of the same kind,
# beside as many host ships of its params tree (`atari_reps` rounds each).
# (e) DQN (DQNConfig's defaults, 2 iterations); one double-Q prioritized
# update at the Atari module's shape (batch 32, DQNConfig's default) against
# the CPU; SimpleQ at tests/test_rllib_new_families.py's config for one
# iteration. (f) R2D2 at R2D2Config's defaults for one iteration, its first
# update against the CPU. (g) Ape-X DQN (2 explorers, 2 shards, learning from
# `apex_learning_starts` rows), PG and A2C (1 rollout worker each), A3C and
# DD-PPO (2 CPU workers each), built together, one iteration each.
RLLIB_FAMILIES = dict(podracer_iters=3, podracer_grow=4, atari_members=4, atari_reps=5, sync_reps=5,
                      dqn_iters=2, atari_dqn_rows=256, atari_dqn_timed=20, apex_learning_starts=200)
# The rllib phase's continuous-action section (h), in the same cluster, each
# algorithm at its config's defaults: SAC on the port's Pendulum-v1 for
# `sac_iters` iterations (1000 env steps each, learning from step 1500), TD3
# for `td3_iters` (one iteration at the defaults makes no update: learning
# starts at step 1500), CQL for one iteration of 200 updates on `cql_rows`
# rows of Pendulum written by the port's env and seeded numpy, CRR (exp
# weights) for one iteration on `crr_rows` of tests/test_rllib_ars_crr.py's
# 60/40 expert/random CartPole data, Ape-X DDPG (2 explorers pinned to the
# host) for `apex_iters`, MADDPG on a 2-agent 1-D spread for `maddpg_iters`
# (its first update at step 1000). The first update of SAC, CQL and MADDPG on
# the card, and Ape-X DDPG's first weighted critic step, is held to the same
# update on the CPU (same weights, batch and draws) at the Atari check's
# bars, with its TF32 control; `timed_updates`
# updates are timed after each run.
RLLIB_CONTINUOUS = dict(sac_iters=2, td3_iters=2, cql_rows=2000, crr_rows=6000, apex_iters=2, maddpg_iters=2,
                        timed_updates=50, delay_checked=6)
# The rllib phase's model-based and meta-learning section (i), in the same
# cluster, each algorithm at its config's defaults: DreamerV3 (deter 128, 8x8
# latents, hiddens (128,), batch 8 x 16, horizon 10; learning from 500 rows)
# on Pendulum-v1 and on CartPole-v1 for `dreamer_iters` iterations of 250 env
# steps (the third the first with updates), then `dreamer_timed` updates timed
# with CUDA events; MAML on PointGoalEnv (meta-batch 10, 10 episodes a task,
# 2 CPU rollout actors, 5 meta-updates an iteration) for `maml_iters`, then
# `maml_timed` meta-updates timed; MBMPO (5 members of (64, 64), batch 256, 30
# epochs) for `mbmpo_iters`, then `mbmpo_timed` ensemble updates and imagined
# batches timed. DreamerV3's first update, MAML's first (second-order)
# meta-update and MBMPO's first ensemble update on the card are held to the
# same computation on the CPU (same weights, data and draws) at the Atari
# check's bars with the TF32 control; one imagined MBMPO rollout (20 starts,
# the horizon of 20) on the card against the CPU's within
# RLLIB_ATARI_GRAD_RTOL (rel_l2 over its five columns).
RLLIB_MODEL_BASED = dict(dreamer_iters=3, dreamer_timed=20, maml_iters=1, maml_timed=10, mbmpo_iters=1,
                         mbmpo_timed=20)
# The rllib phase's section (j), the lighter algorithms, in the same cluster at
# the reference tests' configs: BC on 2,000 expert rows and MARWIL (beta 2) on
# 3,000 mixed rows (tests/test_rllib.py), written by the port's JsonWriter,
# for the reference's `bc_iters` and `marwil_iters` iterations; QMIX on the
# two-step game (tests/test_rllib_multiagent.py) up to `qmix_iters`
# iterations, stopping at its bar; SlateQ on SlateRecEnv
# (tests/test_rllib_slateq.py) for `slateq_iters` iterations (updates from
# step 400), then the greedy slates of `slate_rows` replay rows on the card
# against the CPU's and `act_steps` greedy acting steps timed; ES and ARS on
# CartPole-v1 (tests/test_rllib_algorithms.py, tests/test_rllib_ars_crr.py)
# with 2 CPU worker actors each for `es_iters` iterations, then
# compute_single_action on `act_obs` observations against the CPU forward;
# LinUCB and LinTS on a 2-arm context bandit for `bandit_iters` iterations of
# 200 steps. The first learner update of BC, MARWIL, QMIX and SlateQ on the
# card is held to the same update on the CPU (same weights and batch) at the
# Atari check's bars with the TF32 control; `timed_updates` updates of each
# are timed with CUDA events after its run.
RLLIB_LIGHT = dict(bc_iters=60, marwil_iters=80, qmix_iters=15, slateq_iters=3, slate_rows=256, act_steps=200,
                   es_iters=2, act_obs=64, bandit_iters=5, timed_updates=20)
# The rllib phase's section (k), the MCTS family, in the same cluster at the
# reference tests' configs: AlphaZero on CartPole-v1 (tests/
# test_rllib_alpha_zero.py: 25 simulations, 3 episodes and 30 updates an
# iteration), LeelaChessZero on tic-tac-toe (tests/test_rllib_lc0.py: 25
# simulations, 8 games, 6 updates of 128) and the AlphaStar league on
# rock-paper-scissors with the rock-heavy seed (tests/test_rllib_league.py: 24
# rounds, 6 episodes a slot), `iters` iterations each. Each first update on
# the card is held to the same update on the CPU (same weights and batch) at
# the Atari check's bars with the TF32 control; LC0's masked forward over
# `lc0_rows` replay positions against the CPU's; `timed` expansions, acting
# steps and updates of each timed after its run. Then the profiler probe of
# ROADMAP O3: `probe_adds` adds of 2^20 f32 under torch.profiler, on this
# thread and on a fresh one, their device events counted.
RLLIB_MCTS = dict(iters=2, lc0_rows=128, timed=200, timed_updates=20, probe_adds=5)
# Section (l), the external path: a PolicyServerInput in this process serves
# DQN's greedy compute_single_action on the card to `clients` PolicyClient
# threads, each playing `episodes` episodes of the port's CartPole-v1; the
# served actions are held to a CPU copy's greedy actions; then DQN trains
# `updates` updates on those episodes. Then `python -m ray_tpu_torch.rllib
# train --run PPO --env CartPole-v1 --stop-iters 1` in a subprocess.
RLLIB_EXTERNAL = dict(clients=2, episodes=10, updates=32, cli_timeout=300)
# The R2D2 update on the card against the CPU's (full f32 on both): the loss
# within RLLIB_ATARI_RTOL and the gradients within RLLIB_ATARI_GRAD_RTOL, the
# Atari check's bars.
# Kinds of device work in a learner update (convolutions first: cuDNN's
# kernel names also carry "xmma").
RLLIB_PROFILE_GROUPS = (("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit")),
                        ("host-to-device copy", ("Memcpy HtoD",))) + PROFILE_GROUPS

# The tune phase (16): the cluster's CPUs (two trial actors, and in (c) each
# trial's rollout worker and learner actor beside them, with room to spare
# so no trial waits on another's CPUs); (b)'s PBT sweep: a population of 4 at
# lr ~ loguniform(1e-4, 3e-3), drawn by the searcher's seed 1 (1.6e-4,
# 1.8e-3, 1.3e-3, 2.4e-4: the first two trials on the card at once part
# widely, so the worse one is in the bottom quantile when the better holds
# a checkpoint), 6 iterations of 8 steps, PBT's own seed 0; (c) 2 PPO
# iterations (tests/test_rllib.py's test_ppo_under_tune).
TUNE = dict(num_cpus=8, population=4, lr_range=(1e-4, 3e-3), searcher_seed=1, pbt_seed=0, iters=6, chunk=8,
            ppo_iters=2)


def _phase(name):
    print(f"== {name}", flush=True)


def device_phase(torch):
    _phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}: {name}, "
          f"{torch.cuda.device_count()} device(s), capability {torch.cuda.get_device_capability(0)}")
    if torch.cuda.get_device_capability(0) != (9, 0):
        raise RuntimeError("the kernels are built for sm_90a (Hopper)")
    # f32 products of the plain versions in full f32, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi, name


def build_phase():
    _phase("build")
    from ray_tpu_torch.ops._build import load_kernels
    from ray_tpu_torch.ops.attention import HEAD_DIMS

    k = load_kernels()
    print(f"built {k.path} in {k.seconds:.1f} s" if k.seconds else f"cached {k.path}")
    for line in k.log.splitlines():
        print("  " + line.strip())
    info = {name: k.info(name, MAIN["D"]) for name in KERNELS}
    # The f32 functions at every head width (DT's, the f32 path's user, is 32).
    f32_info = {(name, D): k.info(name, D, bf16=False) for D in HEAD_DIMS for name in KERNELS}
    for (name, dt, D), i in [((n, "bf16", MAIN["D"]), x) for n, x in info.items()] + [
            ((n, "f32", D), x) for (n, D), x in f32_info.items()]:
        print(f"{name} {dt} D{D}: {i['regs']} registers/thread, {i['smem_bytes']} B shared memory/block, "
              f"{i['threads']} threads/block, {i['blocks_per_sm']} block(s)/SM "
              f"({i['blocks_per_sm'] * i['threads'] // 32} warps), {i['local_bytes']} B local/thread")
    return info, f32_info


def _inputs(torch, seed, dtype, B, Tq, Tk, H, D):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda T: torch.randn(B, T, H, D, generator=g, device="cuda").to(dtype)
    return mk(Tq), mk(Tk), mk(Tk), mk(Tq)  # q, k, v, dout


def kernels_phase(torch):
    _phase("kernels vs plain")
    from ray_tpu_torch.ops import attention as A

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    cases = [  # name, dtype, B, Tq, Tk, H, D, causal, window
        ("main", "bf16", MAIN["B"], MAIN["T"], MAIN["T"], MAIN["H"], MAIN["D"], True, 0),
        ("main", "f32", MAIN["B"], MAIN["T"], MAIN["T"], MAIN["H"], MAIN["D"], True, 0),
        ("tq<tk", "bf16", 2, 512, 1024, 8, 128, True, 0),
        ("window256", "bf16", 2, 1024, 1024, 8, 128, True, 256),
        ("non-causal", "bf16", 2, 1024, 1024, 8, 128, False, 0),
        ("ragged1000", "bf16", 2, 1000, 1000, 8, 128, True, 0),
        ("ragged1000", "f32", 2, 1000, 1000, 8, 128, True, 0),
        ("d64", "bf16", 2, 1024, 1024, 8, 64, True, 0),
        ("d32-window", "bf16", 2, 512, 512, 4, 32, True, 100),
        # more ragged lengths, and Tq < Tk with a bottom-right offset (832) that is no multiple of 128
        ("ragged960", "bf16", 2, 960, 960, 8, 128, True, 0),
        ("tq192<tk", "bf16", 2, 192, 1024, 8, 128, True, 0),
        # ViT-B/16's attention: 196 patches + the class token, non-causal
        ("vit", "bf16", VIT["B"], VIT["T"], VIT["T"], VIT["H"], VIT["D"], False, 0),
        # The Decision Transformer's (rllib phase): f32, T 60 below one tile, D 32; and its bf16 twin
        ("dt", "f32", DT_SHAPE["B"], DT_SHAPE["T"], DT_SHAPE["T"], DT_SHAPE["H"], DT_SHAPE["D"], True, 0),
        ("dt", "bf16", DT_SHAPE["B"], DT_SHAPE["T"], DT_SHAPE["T"], DT_SHAPE["H"], DT_SHAPE["D"], True, 0),
    ]
    errs, failures = {}, []
    for i, (name, dt, B, Tq, Tk, H, D, causal, window) in enumerate(cases):
        q, k, v, dout = _inputs(torch, i, dtypes[dt], B, Tq, Tk, H, D)
        scale = D**-0.5
        out_ref, lse_ref = A._plain_flash_fwd(q, k, v, causal, scale, window)
        dq_ref, dk_ref, dv_ref = A._plain_flash_bwd(q, k, v, out_ref, lse_ref, dout, causal, scale, window)
        out, lse = A.flash_fwd_cuda(q, k, v, causal, scale, window, save_lse=True)
        out_primal, _ = A.flash_fwd_cuda(q, k, v, causal, scale, window, save_lse=False)
        dq, dk, dv = A.flash_bwd_cuda(q, k, v, out_ref, lse_ref, dout, causal, scale, window)
        again = A.flash_bwd_cuda(q, k, v, out_ref, lse_ref, dout, causal, scale, window)
        torch.cuda.synchronize()
        if not torch.equal(out_primal, out):
            failures.append(f"{name}/{dt}: the forward without LSE differs from the forward with it")
        failures += [f"{name}/{dt}: a second backward gives another {w}"
                     for w, x, y in zip(("dq", "dk", "dv"), (dq, dk, dv), again) if not torch.equal(x, y)]
        m = {}
        for what, got, want in (("out", out, out_ref), ("lse", lse, lse_ref), ("dq", dq, dq_ref),
                                ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
            m[what] = A.mismatch(got, want)
            failures += [f"{name}/{dt} {what}: {x}" for x in A.over_tolerance(m[what], dtypes[dt])]
        print(f"{name:>11} {dt:>4} B{B} Tq{Tq} Tk{Tk} H{H} D{D} causal={int(causal)} window={window}: "
              + " ".join(f"{w} rel_l2={r['rel_l2']:.2e} elem={r['elem']:.2e} max_abs={r['max_abs']:.2e}"
                         for w, r in m.items()), flush=True)
        if (name, dt) == ("main", "bf16"):
            errs.update({"flash_fwd": (m["out"], m["lse"]), "flash_bwd_dkv": (m["dk"], m["dv"]),
                         "flash_bwd_dq": (m["dq"],)})
        if name == "vit":
            errs["flash_fwd_vit"] = (m["out"],)
        if (name, dt) == ("dt", "f32"):
            errs.update({"flash_fwd_dt": (m["out"], m["lse"]), "flash_bwd_dkv_dt": (m["dk"], m["dv"]),
                         "flash_bwd_dq_dt": (m["dq"],)})
        if (name, dt) == ("main", "f32"):
            errs.update({"flash_fwd_f32": (m["out"], m["lse"]), "flash_bwd_dkv_f32": (m["dk"], m["dv"]),
                         "flash_bwd_dq_f32": (m["dq"],)})
        del q, k, v, dout, out_ref, lse_ref, dq_ref, dk_ref, dv_ref, out, out_primal, lse, dq, dk, dv, again
    if failures:
        raise AssertionError("kernel disagrees with its plain version: " + "; ".join(failures))
    print(f"all {len(cases)} cases within the bars {A.MATCH_TOL}")
    return errs


def moe_parts(prof, steps):
    """ms per step of each part of the expert layer, from the ``moe/...``
    ranges of ``parallel/moe.py`` and ``models/transformer.py``: forward, the
    kernels launched inside a range; backward, those of the autograd nodes
    that the range's forward ops recorded (matched by sequence number).
    Returns {part: (forward ms, backward ms)}, and prints each part's
    busiest forward kernels."""
    events = prof.events()
    part_of, fwd, bwd, kernels = {}, {}, {}, {}
    for e in events:
        if not e.name.startswith("moe/"):
            continue
        fwd[e.name] = fwd.get(e.name, 0.0) + e.device_time_total / 1e3 / steps
        stack = list(e.cpu_children)
        while stack:
            c = stack.pop()
            if c.sequence_nr >= 0:
                part_of[c.sequence_nr] = e.name
            for k in c.kernels:
                by_name = kernels.setdefault(e.name, {})
                by_name[(c.name, k.name)] = by_name.get((c.name, k.name), 0.0) + k.duration / 1e3 / steps
            stack.extend(c.cpu_children)
    for part, by_name in sorted(kernels.items()):
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        print(f"  {part} forward, busiest: " + "; ".join(f"{op} {ms:.2f} ms ({k[:60]})" for (op, k), ms in top))
    for e in events:
        if e.name.startswith("autograd::engine::evaluate_function") and e.sequence_nr in part_of:
            part = part_of[e.sequence_nr]
            bwd[part] = bwd.get(part, 0.0) + e.device_time_total / 1e3 / steps
    return {p: (fwd[p], bwd.get(p, 0.0)) for p in sorted(fwd)}


def _profile(run, steps, launches, parts=False):
    """`steps` more train steps under torch.profiler. Prints each flash
    kernel's device time per step and the busiest device kernels (and, with
    ``parts``, the expert layer's parts); returns (device ms per step of
    every kernel, {flash kernel: ms per step}, {kind: ms per step}, {part:
    (forward, backward) ms per step} or None, ms per step of the layer slices'
    gradients), or None when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
    # Device work only: kernels, copies and sets, not the annotations of
    # CPU ranges on the device's timeline (the optimizer step's, for one).
    us = {e.key: e.self_device_time_total for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)}
    total_ms = sum(us.values()) / 1e3 / steps
    if total_ms <= 0:
        print("in-step: not measured (the profiler recorded no device time)")
        return None
    flash = {n: sum(t for key, t in us.items() if n in key) / 1e3 / steps for n in KERNELS}
    for n, ms in flash.items():
        print(f"in-step {n}: {ms:.3f} ms per step, {ms / launches[n]:.4f} ms per launch")
    kinds = _kinds(us, steps)
    print(f"in-step device time: {total_ms:.1f} ms per step; by kind: "
          + ", ".join(f"{g} {ms:.1f} ms" for g, ms in kinds.items()))
    # Each layer reads its weights as a slice w[i] of the [L, ...] stack; the
    # slice's backward writes a full-size zero gradient and the engine adds
    # the L of them up.
    slices_ms = sum(e.device_time_total for e in prof.events()
                    if e.name == "autograd::engine::evaluate_function: SelectBackward0") / 1e3 / steps
    print(f"of which the layer slices' gradients (SelectBackward0 nodes: zero-filled full-size gradients and "
          f"their sum over layers): {slices_ms:.1f} ms per step")
    part_ms = None
    if parts:
        part_ms = moe_parts(prof, steps)
        print("of which the expert layer's parts, ms per step (forward + backward): "
              + ", ".join(f"{p[4:]} {f:.2f} + {b:.2f}" for p, (f, b) in part_ms.items()))
    print("busiest:")
    for key, t in sorted(us.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {t / 1e3 / steps:8.3f} ms  {key[:110]}")
    return total_ms, flash, kinds, part_ms, slices_ms


def _batch(torch, vocab_size, batch_size):
    """The fixed training batch: [batch_size, T + 1] tokens from seed 1."""
    g = torch.Generator(device="cuda").manual_seed(1)
    return {"tokens": torch.randint(0, vocab_size, (batch_size, MAIN["T"] + 1), generator=g, device="cuda")}


def _train(torch, tt, A, cfg, steps, batch_size, label, profiled=0, warmup=1, parts=False):
    """`warmup` steps + `steps` timed steps + `profiled` steps under the
    profiler, on one fixed batch, from the weights of seed 0; returns
    (losses, timed step ms, launch counts, peak memory, profile)."""
    params = tt.init_params(cfg, seed=0)
    opt = tt.adamw(params)
    step = tt.make_train_step(cfg, opt)
    batch = _batch(torch, cfg.vocab_size, batch_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()  # the main path starts here ...
    losses, ms = [], []
    for _ in range(warmup + steps):
        t0 = time.perf_counter()
        loss = step(params, batch).item()  # .item() waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    prof = None
    if profiled:
        # remat recomputes each layer's forward in the backward: 2 forward launches per layer.
        launches = {n: cfg.n_layers * (2 if n == "flash_fwd" and cfg.remat else 1) for n in KERNELS}
        prof = _profile(lambda: losses.append(step(params, batch).item()), profiled, launches, parts)
    counts = A.launch_counts()  # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: {tt.num_params(params) / 1e6:.1f}M params, losses {[round(x, 4) for x in losses]}")
    del params, opt, step, batch
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall ({losses[0]} -> {losses[-1]})")
    return losses, ms[warmup:], counts, peak, prof


def main_path_phase(torch, card):
    _phase("main path")
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.ops import attention as A

    # bench.py's TPU config (bench.py:44-72): full width, bf16 activations,
    # f32 params, remat off, unfused loss, batch 12, T 1024.
    cfg = tt.TransformerConfig(
        vocab_size=32000, d_model=1024, n_layers=8, n_heads=8, n_kv_heads=8, d_ff=2816,
        max_seq_len=1024, dtype=torch.bfloat16, param_dtype=torch.float32, remat=False,
        fused_loss=False, scan_unroll=8,
    )
    B, L = MAIN["B"], cfg.n_layers
    losses, ms, counts, peak, prof = _train(torch, tt, A, cfg, STEPS, B, "bench config", profiled=PROFILED)
    n_steps = 1 + STEPS + PROFILED
    want = {n: n_steps * L for n in counts}
    print(f"launches over {n_steps} steps: {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"main path did not launch every kernel {L}x per step: {counts}")
    med = sorted(ms)[len(ms) // 2]
    print(f"bench config on {card}: step {med:.1f} ms median of {STEPS} "
          f"(min {min(ms):.1f}, max {max(ms):.1f}), {B * MAIN['T'] / med * 1e3:.0f} tokens/s, "
          f"max_memory_allocated {peak / 2**30:.2f} GiB")
    if prof is not None:
        print(f"device-busy share of the median step: {prof[0] / med:.1%} ({prof[0]:.1f} ms of kernels)")

    cfg2 = dataclasses.replace(cfg, fused_loss=True, remat=True)
    _, ms2, counts2, peak2, prof2 = _train(torch, tt, A, cfg2, 3, B, "defaults (fused loss, remat)", profiled=1)
    n2 = 1 + 3 + 1
    # remat recomputes each layer's forward in the backward: 2 forward launches per layer.
    want2 = {"flash_fwd": n2 * 2 * L, "flash_bwd_dkv": n2 * L, "flash_bwd_dq": n2 * L}
    print(f"launches over {n2} steps: {counts2} (expected {want2})")
    if counts2 != want2:
        raise AssertionError(f"defaults run launched {counts2}, expected {want2}")
    med2 = sorted(ms2)[1]
    print(f"defaults on {card}: step {med2:.1f} ms median of 3 (min {min(ms2):.1f}, max {max(ms2):.1f}), "
          f"{B * MAIN['T'] / med2 * 1e3:.0f} tokens/s, max_memory_allocated {peak2 / 2**30:.2f} GiB")
    if prof2 is not None:
        print(f"defaults: device-busy share of the median step: {prof2[0] / med2:.1%} ({prof2[0]:.1f} ms of kernels)")
    # in-step ms per launch of each flash kernel (empty when not measured)
    return counts, ({n: t / L for n, t in prof[1].items()} if prof else {}), losses[0], med


@contextlib.contextmanager
def _plain_attention(A):
    """Inside, flash_attention runs its kernels' plain versions on the card's
    tensors too (the reference runs; no kernel launches)."""
    on_cuda = A._on_cuda
    A._on_cuda = lambda t: False
    try:
        yield
    finally:
        A._on_cuda = on_cuda


@contextlib.contextmanager
def _record_routing(tm, log):
    """Inside, each top_k_routing call appends its tokens' first choice of
    expert ([B, T], the argmax of the gate's probabilities) to ``log``."""
    route = tm.top_k_routing

    def recording(gate_logits, *args, **kw):
        log.append(gate_logits.softmax(-1).argmax(-1))
        return route(gate_logits, *args, **kw)

    tm.top_k_routing = recording
    try:
        yield
    finally:
        tm.top_k_routing = route


def moe_train_phase(torch, card):
    """The flagship widths with 8 experts: the first loss on the kernels
    against their plain versions, then the timed and profiled train steps;
    returns (launch counts, first loss, median step ms)."""
    _phase("moe train")
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.parallel import moe as tm

    cfg = tt.TransformerConfig(**SERVE_CFG, **MOE, dtype=torch.bfloat16, param_dtype=torch.float32, remat=False,
                               fused_loss=False)
    B, L, run = MAIN["B"], cfg.n_layers, MOE_TRAIN
    capacity = max(1, int(cfg.expert_capacity_factor * MAIN["T"] / cfg.num_experts))
    params = tt.init_params(cfg, seed=0)
    n_params = tt.num_params(params)
    n_expert = sum(params["layers"][n].numel() for n in ("wi_e", "wg_e", "wo_e"))
    batch = _batch(torch, cfg.vocab_size, B)
    routes, routes_plain = [], []
    with torch.no_grad():
        with _record_routing(tm, routes):
            loss_kernel = tt.loss_fn(params, batch, cfg).item()
        with _record_routing(tm, routes_plain), _plain_attention(A):
            loss_plain = tt.loss_fn(params, batch, cfg).item()
    agree = torch.cat([(a == b).flatten() for a, b in zip(routes, routes_plain)]).float().mean().item()
    loss_rel = abs(loss_kernel - loss_plain) / abs(loss_plain)
    del params, batch, routes, routes_plain
    torch.cuda.empty_cache()
    print(f"moe config: {n_params / 1e6:.1f}M params ({n_expert / 1e6:.1f}M expert weights), {cfg.num_experts} "
          f"experts, top-1, capacity {capacity} per (row, expert); first loss on the kernels {loss_kernel:.6f}, on "
          f"their plain versions {loss_plain:.6f} (relative difference {loss_rel:.2e}, bar {MOE_LOSS_RTOL}); "
          f"expert choices equal in the two runs: {agree:.4%} of {B * MAIN['T'] * L} (bar {MOE_ROUTING_AGREE:.0%})")

    losses, ms, counts, peak, prof = _train(torch, tt, A, cfg, run["steps"], B, "moe config",
                                            profiled=run["profiled"], warmup=run["warmup"], parts=True)
    n_steps = run["warmup"] + run["steps"] + run["profiled"]
    want = {n: n_steps * L for n in KERNELS}
    med = sorted(ms)[len(ms) // 2]
    print(f"launches over {n_steps} steps: {counts} (expected {want})")
    print(f"moe config on {card}: step {med:.1f} ms median of {run['steps']} (min {min(ms):.1f}, max {max(ms):.1f}), "
          f"{B * MAIN['T'] / med * 1e3:.0f} tokens/s, max_memory_allocated {peak / 2**30:.2f} GiB; "
          f"first loss {losses[0]:.6f} (the forward's {loss_kernel:.6f})")
    failures = []
    if counts != want:
        failures.append(f"launched {counts}, not {L} per step")
    if not loss_rel <= MOE_LOSS_RTOL:
        failures.append(f"first loss on the kernels {loss_kernel} is not the plain versions' {loss_plain}")
    if not agree >= MOE_ROUTING_AGREE:
        failures.append(f"only {agree:.2%} of expert choices agree with the plain run")
    if not abs(losses[0] - loss_kernel) <= TRAINER_LOSS_RTOL * abs(loss_kernel):
        failures.append(f"the train step's first loss {losses[0]} is not the forward's {loss_kernel}")
    res = {"params": n_params, "expert_params": n_expert, "capacity": capacity, "step_ms_median": med,
           "tokens_per_s": B * MAIN["T"] / med * 1e3, "peak_memory_gib": peak / 2**30, "launches": counts,
           "first_loss": losses[0], "first_loss_plain": loss_plain, "routing_agreement": agree}
    if prof is not None:
        res.update(device_ms_per_step=prof[0], device_busy_share=prof[0] / med, device_ms_by_kind=prof[2],
                   moe_parts_ms=prof[3], layer_slice_grad_ms=prof[4])
        print(f"device-busy share of the median step: {prof[0] / med:.1%} ({prof[0]:.1f} ms of kernels)")
    print("moe train: " + json.dumps(res))
    if failures:
        raise AssertionError("moe train: " + "; ".join(failures))
    return counts, losses[0], med


def _time_ms(torch, fn, iters):
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(torch, fn, calls, replays, stream=None):
    """The device's ms a call of `fn`: `calls` calls captured in one CUDA
    graph, replayed `replays` times between events. Where a call's kernels
    take less time than its host code (a Python wrapper, PyTorch's dispatch),
    _time_ms measures the host; this measures the kernels. The warm-up and
    the capture run on `stream` (a new side stream if None)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graph asks
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / replays / calls
    del graph
    return ms


def timings_phase(torch, card, counts, errs, info, in_step):
    _phase("timings")
    watts = float(card.rsplit(",", 1)[1].strip().split()[0])  # "name, 700.00 W"
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as A

    B, T, H, D = MAIN["B"], MAIN["T"], MAIN["H"], MAIN["D"]
    scale = D**-0.5
    q, k, v, dout = _inputs(torch, 100, torch.bfloat16, B, T, T, H, D)
    out, lse = A.flash_fwd_cuda(q, k, v, True, scale, 0, save_lse=True)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()

    # Library yardstick (never called by the port): SDPA in its [B, H, T, D] layout.
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v, dout))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    with torch.no_grad():
        lib_fwd = _time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 20)
    lib_bwd = _time_ms(torch, lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True), 20)
    plain_fwd = _time_ms(torch, lambda: A._plain_flash_fwd(q, k, v, True, scale, 0), 5)
    plain_bwd = _time_ms(torch, lambda: A._plain_flash_bwd(q, k, v, out, lse, dout, True, scale, 0), 5)
    fwd = _time_ms(torch, lambda: A.flash_fwd_cuda(q, k, v, True, scale, 0, save_lse=True), 20)
    dkv = _time_ms(torch, lambda: A.flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, True, scale, 0), 20)
    dq = _time_ms(torch, lambda: A.flash_bwd_dq_cuda(q, k, v, dout, lse, delta, True, scale, 0), 20)

    # Least time for the same work: FLOPs over visible (q, k) pairs at the bf16
    # tensor-core peak, bytes with each input read and each output written once.
    pairs = B * H * int(A._visible(T, T, True, 0, "cuda").sum().item())
    tensor = B * T * H * D * 2  # one bf16 [B, T, H, D] tensor
    rows = B * H * T * 4  # one f32 [B, H, T] vector (lse, delta)
    work = {  # name: (FLOPs, bytes)
        "flash_fwd": (4 * D * pairs, 3 * tensor + tensor + rows),  # QK^T, PV | q k v -> out, lse
        "flash_bwd_dkv": (8 * D * pairs, 4 * tensor + 2 * rows + 2 * tensor),  # S, dP, dV, dK
        "flash_bwd_dq": (6 * D * pairs, 4 * tensor + 2 * rows + tensor),  # S, dP, dQ
    }
    measured = {"flash_fwd": (fwd, plain_fwd, lib_fwd), "flash_bwd_dkv": (dkv, plain_bwd, lib_bwd),
                "flash_bwd_dq": (dq, plain_bwd, lib_bwd)}
    # What the timed plain and library calls compute: the backward rows' calls
    # compute all of dq, dk and dv, not only the row's kernel's share.
    covers = {"flash_fwd": ("out+lse", "out"), "flash_bwd_dkv": ("dq+dk+dv", "dq+dk+dv"),
              "flash_bwd_dq": ("dq+dk+dv", "dq+dk+dv")}
    sources = {
        "flash_fwd": ("ray_tpu_torch/ops/csrc/flash_fwd.cu", "ray_tpu/ops/attention.py:57"),
        "flash_bwd_dkv": ("ray_tpu_torch/ops/csrc/flash_bwd.cu", "ray_tpu/ops/attention.py:320"),
        "flash_bwd_dq": ("ray_tpu_torch/ops/csrc/flash_bwd.cu", "ray_tpu/ops/attention.py:366"),
    }
    rows_out = []
    print(f"bf16 B{B} T{T} H{H} D{D} causal, on {card}; bounds at the published H100 SXM peaks "
          f"({PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, {PEAK_BYTES / 1e12:.2f} TB/s), which assume 700 W. "
          f"plain_ms and library_ms of both backward rows are one call computing dq, dk and dv together; "
          f"the two backward kernels take {dkv + dq:.3f} ms together.")
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        ms, plain_ms, lib_ms = measured[name]
        row = {
            "name": name, "route": "cuda", "design": DESIGNS[name], "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": counts[name], "max_abs_err": max(m["max_abs"] for m in errs[name]),
            "rel_l2_err": max(m["rel_l2"] for m in errs[name]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "plain_covers": covers[name][0], "library_covers": covers[name][1],
            "in_step_ms": in_step.get(name),
            "regs": info[name]["regs"], "smem_bytes": info[name]["smem_bytes"],
            "blocks_per_sm": info[name]["blocks_per_sm"],
        }
        rows_out.append(row)
        print(f"{name}: {ms:.3f} ms (bound {row['bound_ms']:.4f} ms by {row['bound_by']}: "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; {row['bound_ms'] / ms:.1%} of bound), "
              f"plain {plain_ms:.3f} ms, library {lib_ms:.3f} ms, {flops / ms / 1e9:.1f} TFLOP/s")
        if watts < 700:
            # A rough restatement: the tensor-core clock, and so the compute
            # peak, scaled by the power limit; memory bandwidth unchanged.
            print(f"  at the card's {watts:.0f} W limit: bound ~{max(t_ops * 700 / watts, t_bytes):.4f} ms")
    return rows_out


def _percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q / 100 * len(xs)) - 1))]


def _kinds(us: dict, per: float, kinds=PROFILE_GROUPS) -> dict:
    groups = {}
    for key, t in us.items():
        group = next((g for g, words in kinds if any(w in key for w in words)), "other")
        groups[group] = groups.get(group, 0.0) + t / 1e3 / per
    return dict(sorted(groups.items(), key=lambda kv: -kv[1]))


def _lossless(cfg):
    """cfg whose forward routes as inference does: every token gets an
    expert slot (capacity factor = the number of experts)."""
    return dataclasses.replace(cfg, expert_capacity_factor=float(cfg.num_experts)) if cfg.num_experts else cfg


def serve_functions(torch, tt, tg, A, cfg, params, device="cuda"):
    """Function checks in cfg's dtype: ragged prefill against forward per
    row, and the paged decode chunk against the dense one on the same cache
    contents."""
    rng = np.random.default_rng(0)
    B, T, q, bs = 4, 512, 8, 16
    lens = rng.integers(64, T + 1, B)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (B, T)), device=device)
    cache = tg.init_cache(cfg, B, cfg.max_seq_len, device=device)
    logits, cache, pos = tg.prefill(params, tokens, cache, cfg, prompt_lens=torch.tensor(lens, device=device))
    failures, worst = [], {}
    with torch.no_grad():
        for b in range(B):
            ref = tt.forward(params, tokens[b : b + 1, : lens[b]], _lossless(cfg))[0][0, -1]
            m = A.mismatch(logits[b], ref)
            failures += [f"prefill row {b} (length {lens[b]}): {x}" for x in A.over_tolerance(m, cfg.dtype)]
            worst = {k: max(worst.get(k, 0.0), v) for k, v in m.items()}
    print(f"prefill B{B} T{T} prompt_lens {lens.tolist()}: last-row logits against forward, worst "
          + " ".join(f"{k}={v:.2e}" for k, v in worst.items()))
    # The paged copy of the dense cache, through shuffled block tables.
    L, S = cfg.n_layers, cfg.max_seq_len
    n_max = S // bs
    tables = torch.tensor(rng.permutation(np.arange(1, 1 + B * n_max)).reshape(B, n_max), device=device)
    paged = tg.init_paged_cache(cfg, 1 + B * n_max, bs, device=device)
    for name in ("k", "v"):
        for b in range(B):
            paged[name][:, tables[b]] = cache[name][:, b].reshape(L, n_max, bs, cfg.n_kv_heads, cfg.head_dim)
    extra = torch.tensor(rng.integers(0, cfg.vocab_size, (B, q)), device=device)
    dense, _ = tg.decode_chunk(params, extra, cache, pos, cfg)
    got, _ = tg.paged_decode_chunk(params, extra, paged, tables, pos, cfg)
    m = A.mismatch(got, dense)
    failures += [f"paged decode chunk: {x}" for x in A.over_tolerance(m, cfg.dtype)]
    print(f"paged_decode_chunk q{q} (shuffled tables) against decode_chunk: "
          + " ".join(f"{k}={v:.2e}" for k, v in m.items()))
    if failures:
        raise AssertionError("serve functions disagree: " + "; ".join(failures))
    del cache, paged


def serve_engine_exact(torch, tt, tg, LLMEngine, cfg, device="cuda"):
    """f32 at full width, 2 layers, with the traffic run's slots, block size,
    prefill chunk and shared system prefix, and a pool that forces
    preemption: every greedy request's tokens equal generate()'s, through
    prefix-cache hits and preemptions."""
    tr, ex = TRAFFIC, EXACT
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    params = tt.init_params(cfg32, seed=0, device=device)
    rng = np.random.default_rng(1)
    system = rng.integers(0, cfg.vocab_size, tr["prefix"]).tolist()
    reqs = [(system + rng.integers(0, cfg.vocab_size, rng.integers(*ex["suffix"])).tolist(),
             int(rng.integers(*ex["new"]))) for _ in range(ex["requests"])]
    eng = LLMEngine(params, cfg32, num_slots=tr["slots"], block_size=tr["block_size"],
                    num_blocks=ex["num_blocks"], prefill_chunk=tr["prefill_chunk"])
    try:
        t0 = time.perf_counter()
        handles = [eng.submit(*reqs[0])]
        # The others arrive once the first has prefilled, so its system-prefix blocks are in the cache.
        while handles[0].t_first is None and time.perf_counter() - t0 < 300:
            time.sleep(0.002)
        handles += [eng.submit(p, max_new_tokens=n) for p, n in reqs[1:]]
        outs = [h.result(timeout=300) for h in handles]
        wall = time.perf_counter() - t0
        stats = eng.stats()
    finally:
        eng.shutdown()
    wrong = []
    for i, ((prompt, n), out) in enumerate(zip(reqs, outs)):
        want = tg.generate(params, torch.tensor([prompt], device=device), cfg32, max_new_tokens=n)[0].tolist()
        if out != want:
            first = next((j for j, (a, b) in enumerate(zip(out, want)) if a != b), min(len(out), len(want)))
            wrong.append(f"request {i}: first differs at token {first} of {n}")
    print(f"engine f32 (2 layers, {tr['slots']} slots, {ex['num_blocks'] - 1} usable blocks of {tr['block_size']}, "
          f"prefill chunk {tr['prefill_chunk']}, a shared {tr['prefix']}-token prefix): {len(reqs)} greedy requests "
          f"in {wall:.1f} s, preemptions {stats['preemptions']}, prefix hits {stats['prefix_hit_blocks']} blocks, "
          f"evictions {stats['evicted_blocks']}; {len(reqs) - len(wrong)} of {len(reqs)} equal to generate()")
    if wrong:
        raise AssertionError("engine tokens differ from generate(): " + "; ".join(wrong))
    if stats["preemptions"] < 1:
        raise AssertionError("the small pool forced no preemption")
    if stats["prefix_hit_blocks"] < 2 * (len(reqs) - 1):
        raise AssertionError(f"the shared prefix was hit for only {stats['prefix_hit_blocks']} blocks")
    del params


def _record_ticks(eng, log, step_log):
    """Wraps the engine's decode tick: appends (ms, active slots) to `log` for
    every tick that ran a step, and the host ms of the step's call (the
    launches, before the logits are copied back) to `step_log`."""
    tick, step = eng._decode_tick, eng._decode_fn

    def timed_step(*args):
        t0 = time.perf_counter()
        out = step(*args)
        step_log.append((time.perf_counter() - t0) * 1e3)
        return out

    def timed():
        n = sum(r is not None and r._sched_state == "decode" for r in eng._slots)
        t0 = time.perf_counter()
        ran = tick()
        if ran and n:
            log.append(((time.perf_counter() - t0) * 1e3, n))
        return ran

    eng._decode_tick, eng._decode_fn = timed, timed_step


def _traffic_specs(cfg, requests):
    """The serving traffic's shared system prefix and its first `requests`
    (prompt, new tokens, sampling) specs, from seed 2."""
    tr = TRAFFIC
    rng = np.random.default_rng(2)
    system = rng.integers(0, cfg.vocab_size, tr["prefix"]).tolist()
    specs = []
    for i in range(requests):
        suffix = rng.integers(0, cfg.vocab_size, rng.integers(tr["suffix"][0], tr["suffix"][1] + 1)).tolist()
        new = int(np.clip(rng.geometric(1 / tr["mean_new"]), *tr["new"]))
        sampled = i % tr["sampled_every"] == tr["sampled_every"] - 1
        specs.append((system + suffix, new, dict(temperature=0.8, top_k=50, seed=1234) if sampled else {}))
    return system, specs


def serve_traffic(torch, A, LLMEngine, cfg, params, card, device="cuda", requests=TRAFFIC["requests"]):
    """Closed-loop streams over the engine at the flagship config until
    `requests` finish, then (on the card) profiled decode ticks; returns the
    numbers it prints."""
    tr = TRAFFIC
    system, specs = _traffic_specs(cfg, requests)
    eng = LLMEngine(params, cfg, num_slots=tr["slots"], block_size=tr["block_size"],
                    max_model_len=cfg.max_seq_len, prefill_chunk=tr["prefill_chunk"])
    ticks, steps = [], []
    _record_ticks(eng, ticks, steps)
    pool_mb = sum(t.numel() * t.element_size() for t in eng._cache.values()) / 1e6
    try:
        eng.submit(system + specs[0][0][-100:], max_new_tokens=16).result(timeout=300)  # warm-up
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        before, n_warm, s_warm = eng.stats(), len(ticks), len(steps)
        A.reset_launch_counts()  # the serving path starts here ...
        order, done, errors = itertools.count(), [None] * len(specs), []

        def stream():
            try:
                while (i := next(order)) < len(specs):
                    prompt, new, kw = specs[i]
                    req = eng.submit(prompt, max_new_tokens=new, **kw)
                    done[i] = (req, req.result(timeout=600))
            except BaseException as e:  # noqa: BLE001 — reported after the join
                errors.append(e)

        threads = [threading.Thread(target=stream, name=f"stream{j}") for j in range(tr["streams"])]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        counts = A.launch_counts()  # ... and ends here
        if errors or any(t.is_alive() for t in threads) or None in done:
            raise AssertionError(f"traffic run failed: {errors[:3]}")
        after = eng.stats()
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        window = ticks[n_warm:]
        out_tokens = sum(len(toks) for _, toks in done)
        ttft = [(r.t_first - r.t_submit) * 1e3 for r, _ in done]
        tpot = [(r.t_done - r.t_first) * 1e3 / (len(toks) - 1) for r, toks in done if len(toks) > 1]
        tick_ms = sorted(ms for ms, _ in window)
        step_ms = sorted(steps[s_warm:])
        res = {
            "requests": len(done), "output_tokens": out_tokens,
            "prompt_tokens": sum(len(r.prompt) for r, _ in done), "wall_s": wall,
            "output_tokens_per_s": out_tokens / wall,
            "ttft_ms_p50": _percentile(ttft, 50), "ttft_ms_p99": _percentile(ttft, 99),
            "tpot_ms_mean": sum(tpot) / len(tpot),
            "decode_tick_ms_median": tick_ms[len(tick_ms) // 2], "decode_ticks": len(window),
            "decode_launch_ms_median": step_ms[len(step_ms) // 2],
            "decode_slots_mean": sum(n for _, n in window) / len(window),
            "prefix_hit_blocks": after["prefix_hit_blocks"] - before["prefix_hit_blocks"],
            "prefix_miss_blocks": after["prefix_miss_blocks"] - before["prefix_miss_blocks"],
            "preemptions": after["preemptions"] - before["preemptions"],
            "kv_pool_mb": pool_mb, "peak_memory_gib": peak / 2**30, "serve_launches": counts,
        }
        print(f"traffic on {card}: {res['requests']} requests ({res['prompt_tokens']} prompt, {out_tokens} output "
              f"tokens) from {tr['streams']} closed-loop streams over {tr['slots']} slots in {wall:.2f} s: "
              f"{res['output_tokens_per_s']:.1f} output tokens/s; TTFT p50 {res['ttft_ms_p50']:.1f} ms, "
              f"p99 {res['ttft_ms_p99']:.1f} ms (of {len(ttft)}); TPOT {res['tpot_ms_mean']:.2f} ms mean; "
              f"decode tick {res['decode_tick_ms_median']:.2f} ms median of {len(window)} "
              f"({res['decode_slots_mean']:.2f} slots on average), of which {res['decode_launch_ms_median']:.2f} ms "
              f"median issuing the step's launches on the host")
        print(f"traffic: prefix hits {res['prefix_hit_blocks']} blocks, misses {res['prefix_miss_blocks']}; "
              f"preemptions {res['preemptions']}; KV pool {pool_mb:.1f} MB ({eng.num_blocks} blocks); "
              f"max_memory_allocated {res['peak_memory_gib']:.2f} GiB; flash kernel launches {counts}")
        if any(counts.values()):
            raise AssertionError(f"the serving path launched flash kernels: {counts}")
    finally:
        eng.shutdown()
    if device == "cuda":
        res.update(_profile_decode(torch, LLMEngine, cfg, params, specs))
    return res, done


def _profile_decode(torch, LLMEngine, cfg, params, specs):
    """Decode ticks with every slot busy: PROFILED_TICKS timed on the host
    clock, then as many under torch.profiler for the device ms a tick by
    kind; the device-busy share is the second over the first (the profiler's
    own cost on the host would inflate a profiled tick). The profiler records
    the launches of the thread that started it, so the ticks run on this
    thread: an engine of the traffic run's shape whose own scheduler thread
    is stopped, driven as the engine's white-box tests drive it (the same
    tick code, without the thread's wake-ups)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    tr = TRAFFIC
    eng = LLMEngine(params, cfg, num_slots=tr["slots"], block_size=tr["block_size"],
                    max_model_len=cfg.max_seq_len, prefill_chunk=tr["prefill_chunk"])
    eng.shutdown()
    eng._crashed = None  # re-open submits; this thread runs the scheduler
    for i in range(eng.num_slots):
        eng.submit(specs[i][0][:128], max_new_tokens=256)
    for _ in range(eng.num_slots * 8):  # admit and prefill every prompt
        if not eng._waiting and all(r is not None and r._sched_state == "decode" for r in eng._slots):
            break
        eng._admit()
        eng._prefill_tick()
    else:
        raise AssertionError("the profiled engine did not reach a full decode batch")
    for _ in range(3):  # warm-up
        eng._decode_tick()
    torch.cuda.synchronize()
    n = PROFILED_TICKS
    t0 = time.perf_counter()
    for _ in range(n):
        eng._decode_tick()
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) * 1e3 / n
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng._decode_tick()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / n
    del eng
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    us = {e.key: e.self_device_time_total for e in events}
    device_ms = sum(us.values()) / 1e3
    if device_ms <= 0:
        print("decode ticks: device-busy share not measured (the profiler recorded no device time)")
        return {"device_busy_share": None}
    kinds, launches = _kinds(us, n), sum(e.count for e in events) / n
    print(f"decode ticks, {tr['slots']} slots busy, driven on this thread: {tick_ms:.2f} ms a tick over {n} "
          f"(under the profiler {profiled_ms:.2f}); {device_ms / n:.2f} ms of kernels and {launches:.0f} device "
          f"operations a tick: device busy {device_ms / n / tick_ms:.1%} of a tick; by kind, ms a tick: "
          + ", ".join(f"{g} {ms:.3f}" for g, ms in kinds.items()))
    print("busiest:")
    for key, t in sorted(us.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {t / 1e3 / n:8.4f} ms a tick  {key[:110]}")
    return {"device_busy_share": device_ms / n / tick_ms, "profiled_thread_tick_ms": tick_ms,
            "tick_ms_under_profiler": profiled_ms, "device_ops_per_tick": launches,
            "device_ms_per_tick": device_ms / n, "device_ms_per_tick_by_kind": kinds}


def serve_check(torch, tt, cfg, params, done, device="cuda"):
    """Teacher-forces every greedy request's prompt + emitted tokens through
    forward: each emitted token's logit must lie within SERVE_LOGIT_BAR of
    its row's maximum; under experts, the share of tokens beyond it must not
    pass MOE_SERVE_BEYOND."""
    worst, agree, total, over, beyond = 0.0, 0, 0, [], 0
    with torch.no_grad():
        for req, toks in done:
            if req.temperature > 0:
                continue
            P = len(req.prompt)
            seq = torch.tensor([req.prompt + toks[:-1]], device=device)
            logits = tt.forward(params, seq, _lossless(cfg))[0][0, P - 1 :]  # row j predicts toks[j]
            emitted = torch.tensor(toks, device=device)
            short = logits.max(-1).values - logits[torch.arange(len(toks), device=device), emitted]
            worst = max(worst, short.max().item())
            agree += (logits.argmax(-1) == emitted).sum().item()
            total += len(toks)
            beyond += (short > SERVE_LOGIT_BAR).sum().item()
            if short.max().item() > SERVE_LOGIT_BAR:
                over.append(f"{req.id}: {short.max().item():.3f} at token {short.argmax().item()}")
            logit_std = logits.std().item()
    print(f"teacher-forced check: {total} greedy tokens, {agree / total:.2%} are forward's argmax; "
          f"largest shortfall from the row maximum {worst:.4f} (bar {SERVE_LOGIT_BAR}; logits' std ~{logit_std:.2f}); "
          f"{beyond} tokens ({beyond / total:.2%}) beyond the bar")
    if cfg.num_experts:
        if beyond > MOE_SERVE_BEYOND * total:
            raise AssertionError(f"{beyond} of {total} emitted tokens beyond the bar (at most {MOE_SERVE_BEYOND:.0%})")
    elif over:
        raise AssertionError("emitted tokens beyond the bar: " + "; ".join(over))
    return {"greedy_tokens": total, "argmax_share": agree / total, "max_shortfall": worst,
            "beyond_bar_share": beyond / total}


def serve_phase(torch, card, moe=False):
    """The serving path at the flagship config, or (``moe``) at the moe train
    phase's: function checks (bf16; f32 under experts), the f32 engine's
    exactness, bf16 traffic and its teacher-forced check."""
    label = "moe serve" if moe else "serve"
    _phase(label)
    from ray_tpu_torch.models import generate as tg
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = tt.TransformerConfig(**SERVE_CFG, **(MOE if moe else {}), dtype=torch.bfloat16,
                               param_dtype=torch.float32, remat=False)
    params = tt.init_params(cfg, seed=0)
    serve_functions(torch, tt, tg, A, dataclasses.replace(cfg, dtype=torch.float32) if moe else cfg, params)
    serve_engine_exact(torch, tt, tg, LLMEngine, cfg)
    res, done = serve_traffic(torch, A, LLMEngine, cfg, params, card,
                              requests=MOE_TRAFFIC_REQUESTS if moe else TRAFFIC["requests"])
    res.update(serve_check(torch, tt, cfg, params, done))
    print(f"{label}: " + json.dumps(res))
    del params
    torch.cuda.empty_cache()
    return res


def _alive(pid: int) -> bool:
    """True while `pid` runs (a zombie counts as gone)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def trainer_phase(torch, card, main_first_loss, main_step_ms, moe_first_loss):
    """The main path's train step, then the moe train phase's, each in a GPU
    worker actor through the port's init() and TorchTrainer, in one cluster;
    returns the two workers' launch counts."""
    _phase("trainer")
    import ray_tpu_torch as rt
    from ray_tpu_torch.air.config import RunConfig, ScalingConfig
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.train.flagship_loop import train_loop
    from ray_tpu_torch.train.torch import TorchTrainer

    model = dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=8, n_kv_heads=8, d_ff=2816,
                 max_seq_len=1024, remat=False, fused_loss=False, scan_unroll=8)
    common = dict(dtype="bfloat16", batch=MAIN["B"], seq=MAIN["T"], param_seed=0, batch_seed=1)
    runs = [("trainer", dict(model=model, **common, **TRAINER), main_first_loss, main_step_ms),
            ("moe trainer", dict(model=dict(model, **MOE), **common, **TRAINER_MOE), moe_first_loss, None),
            ("mesh trainer", dict(model=model, **common, **TRAINER_MESH), main_first_loss, None)]
    storage = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    t0 = time.time()
    rt.init(num_cpus=4, num_gpus=1)
    results, pids = [], set()
    try:
        print(f"init: {time.time() - t0:.2f} s; cluster resources {rt.cluster_resources()}")
        for _, config, _, _ in runs:
            A.reset_launch_counts()
            t_fit = time.time()
            result = TorchTrainer(
                train_loop, train_loop_config=config,
                scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                run_config=RunConfig(storage_path=storage),
            ).fit()
            results.append((result.metrics, t_fit, A.launch_counts()))
            # The raylet's workers and, whether or not it is still listed, the
            # process the loop reported it ran in.
            pids |= {w.pid for w in rt._global_node.raylet.workers.values() if w.pid} | {result.metrics["pid"]}
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    deadline = time.monotonic() + 30
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = sorted(p for p in pids if _alive(p))
    print(f"worker pids {sorted(pids)}, {len(left)} left after shutdown()")
    failures = [f"worker processes {left} outlived shutdown()"] if left else []
    counts_out = []
    for n, ((label, config, first_loss, step_ms), (m, t_fit, driver_counts)) in enumerate(zip(runs, results)):
        if config.get("mesh"):
            failures += _mesh_trainer_report(torch, label, config, m, first_loss, driver_counts)
            continue
        start, since = (t0, "init()") if n == 0 else (t_fit, "fit()")
        failures += _trainer_report(torch, card, label, config, m, first_loss, step_ms, driver_counts, start, since)
        counts_out.append(m["launches"])
    if failures:
        raise AssertionError("trainer phase: " + "; ".join(failures))
    return counts_out, MAIN["B"] * MAIN["T"] / results[0][0]["tokens_per_sec_raw"] * 1e3


def _mesh_trainer_report(torch, label, config, m, first_loss, driver_counts):
    """The loop on the worker's session.get_mesh(): a one-card mesh, its
    sharded steps' launches and first loss; returns its failures."""
    steps, counts, L = m["steps"], m["launches"], config["model"]["n_layers"]
    rel = abs(m["first_loss"] - first_loss) / abs(first_loss)
    print(f"{label}: session.get_mesh() in the worker: {m.get('mesh')}; device {m['device_name']}; launches over "
          f"{steps} sharded steps {counts} (expected {steps * L} each); first loss {m['first_loss']:.6f}, main path "
          f"{first_loss:.6f} (relative difference {rel:.2e}, bar {TRAINER_LOSS_RTOL})")
    failures = []
    if m.get("mesh") != {"dp": 1}:
        failures.append(f"{label}: the worker's mesh is {m.get('mesh')}, not one dp axis of one card")
    if m["device_name"] != torch.cuda.get_device_name(0) or m["pid"] == os.getpid():
        failures.append(f"{label}: the loop did not run in a worker on this process's card")
    if counts != {n: steps * L for n in KERNELS} or any(driver_counts.values()):
        failures.append(f"{label}: the worker launched {counts} (this process {driver_counts}), not {L} per step")
    if not rel <= TRAINER_LOSS_RTOL:
        failures.append(f"{label}: first loss {m['first_loss']} is not the main path's {first_loss}")
    return failures


def _trainer_report(torch, card, label, config, m, first_loss, step_ms, driver_counts, start, since):
    """Prints one trainer run's lines and its JSON line; returns its failures."""
    steps, counts, L = m["steps"], m["launches"], config["model"]["n_layers"]
    tok = MAIN["B"] * MAIN["T"]
    raw_ms = tok / m["tokens_per_sec_raw"] * 1e3
    n_prof = config["profile_steps"]
    device_ms = sum(m["device_us"].values()) / 1e3 / n_prof if n_prof else 0.0
    flash_ms = {n: sum(t for key, t in m["device_us"].items() if n in key) / 1e3 / n_prof for n in KERNELS} \
        if n_prof else {}
    rel = abs(m["first_loss"] - first_loss) / abs(first_loss)
    print(f"{label}: worker device {m['device_name']} (driver's card: {torch.cuda.get_device_name(0)}); the loop "
          f"ran in pid {m['pid']}")
    print(f"{label}: worker launches over {steps} steps: {counts} (expected {steps * L} each); "
          f"driver launches meanwhile: {driver_counts}")
    print(f"{label}: first loss: worker {m['first_loss']:.6f}, in-process {first_loss:.6f} "
          f"(relative difference {rel:.2e}, bar {TRAINER_LOSS_RTOL})")
    print(f"{label} on {card}: framework {m['tokens_per_sec_framework']:.0f} tokens/s, raw "
          f"{m['tokens_per_sec_raw']:.0f} tokens/s, ratio {m['ratio']:.4f} (raw time / framework time; "
          f"{config['rounds']} ABBA rounds of {config['chunk']}-step chunks); worker step "
          f"{raw_ms:.1f} ms raw, {tok / m['tokens_per_sec_framework'] * 1e3:.1f} ms framework"
          + (f" (in-process median {step_ms:.1f} ms)" if step_ms else "")
          + f"; worker max_memory_allocated {m['peak_memory_bytes'] / 2**30:.2f} GiB; {since} to first report "
          f"{m['first_report_time'] - start:.2f} s ({since} to the loop's start in the worker "
          f"{m['start_time'] - start:.2f} s, then set-up and the first step "
          f"{m['first_report_time'] - m['start_time']:.2f} s)")
    if device_ms > 0:
        print(f"{label}: worker, {n_prof} steps under torch.profiler: device time {device_ms:.1f} ms per step, "
              f"device busy {device_ms / raw_ms:.1%} of the raw step; by kind: "
              + ", ".join(f"{g} {ms:.1f} ms" for g, ms in _kinds(m["device_us"], n_prof).items())
              + "; flash kernels, ms per step: " + ", ".join(f"{n} {ms:.3f}" for n, ms in flash_ms.items()))
    else:
        print(f"{label}: worker device time: not measured" + (" (no step was profiled)" if not n_prof else
                                                               " (the profiler recorded no device time)"))
    failures = []
    if m["device_name"] != torch.cuda.get_device_name(0):
        failures.append(f"{label}: the worker ran on {m['device_name']!r}")
    if counts != {n: steps * L for n in KERNELS}:
        failures.append(f"{label}: the worker launched {counts}, not {L} per step")
    if not rel <= TRAINER_LOSS_RTOL:
        failures.append(f"{label}: first loss {m['first_loss']} is not the in-process {first_loss}")
    if m["pid"] == os.getpid():
        failures.append(f"{label}: the loop ran in the driver's process, not in a worker")
    if any(driver_counts.values()):
        failures.append(f"{label}: the driver launched kernels during the run: {driver_counts}")
    print(f"{label}: " + json.dumps({
        "device_name": m["device_name"], "steps": steps, "launches": counts, "first_loss": m["first_loss"],
        "in_process_first_loss": first_loss, "tokens_per_sec_framework": m["tokens_per_sec_framework"],
        "tokens_per_sec_raw": m["tokens_per_sec_raw"], "ratio": m["ratio"],
        "peak_memory_gib": m["peak_memory_bytes"] / 2**30,
        f"{since[:-2]}_to_first_report_s": m["first_report_time"] - start,
        f"{since[:-2]}_to_loop_start_s": m["start_time"] - start,
        "worker_device_ms_per_step": device_ms or None,
        "worker_device_busy_share": device_ms / raw_ms if device_ms else None,
    }))
    return failures


def zoo_phase(torch, card, errs):
    """ViT-B/16 and ResNet-50 inference, the forward kernel at ViT's shape
    against its plain version and SDPA, and MNIST-MLP train steps; returns
    the kernels line's row for the forward kernel at ViT's shape."""
    _phase("zoo")
    import torch.nn.functional as F

    from ray_tpu_torch.models import mlp as tmlp
    from ray_tpu_torch.models import resnet as tres
    from ray_tpu_torch.models import vit as tvit
    from ray_tpu_torch.ops import attention as A

    B, S, n = ZOO["batch"], ZOO["image"], ZOO["batches"]
    g = torch.Generator(device="cuda").manual_seed(3)
    images = torch.randn(B, S, S, 3, generator=g, device="cuda")

    def images_per_s(model):
        """n batches after a warm-up one, host clock to a synchronize."""
        model(images)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            out = model(images)
        torch.cuda.synchronize()
        return out, B * n / (time.perf_counter() - t0)

    failures = []
    torch.manual_seed(0)
    vit = tvit.ViT_B16(device="cuda").eval()
    with torch.no_grad():
        with _plain_attention(A):
            ref = vit(images)
        A.reset_launch_counts()  # the ViT path starts here ...
        logits, vit_rate = images_per_s(vit)
        vit_counts = A.launch_counts()  # ... and ends here
    m = A.mismatch(logits, ref)
    want = {"flash_fwd": (n + 1) * len(vit.blocks), "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    print(f"ViT-B/16 on {card}: batch {B} at {S}^2, bf16: {vit_rate:.1f} images/s; launches over {n + 1} batches "
          f"{vit_counts} (expected {want}); logits against the same model on the plain attention: "
          + " ".join(f"{k}={v:.2e}" for k, v in m.items()) + f" (bar rel_l2 {VIT_LOGIT_RTOL})")
    if vit_counts != want:
        failures.append(f"ViT launched {vit_counts}, expected {want}")
    if not m["rel_l2"] <= VIT_LOGIT_RTOL or logits.shape != (B, 1000):
        failures.append(f"ViT logits {tuple(logits.shape)} off the plain attention's: {m}")
    del vit, ref, logits

    # The forward kernel at ViT's shape, as the inference path launches it (no LSE).
    Bv, T, H, D = VIT["B"], VIT["T"], VIT["H"], VIT["D"]
    q, k, v, _ = _inputs(torch, 200, torch.bfloat16, Bv, T, T, H, D)
    scale = D**-0.5
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    with torch.no_grad():
        ms = _time_ms(torch, lambda: A.flash_fwd_cuda(q, k, v, False, scale, 0, save_lse=False), 50)
        plain_ms = _time_ms(torch, lambda: A._plain_flash_fwd(q, k, v, False, scale, 0), 10)
        lib_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), 50)
    flops, nbytes = 4 * D * Bv * H * T * T, 4 * Bv * T * H * D * 2  # QK^T, PV | q k v -> out
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    row = {"name": "flash_fwd_vit", "kernel": "flash_fwd", "route": "cuda", "design": DESIGNS["flash_fwd"],
           "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu", "replaces": "ray_tpu/ops/attention.py:57",
           "shape": f"bf16 B{Bv} T{T} H{H} D{D} non-causal, no LSE", "launches": vit_counts["flash_fwd"],
           "max_abs_err": max(e["max_abs"] for e in errs["flash_fwd_vit"]),
           "rel_l2_err": max(e["rel_l2"] for e in errs["flash_fwd_vit"]), "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": lib_ms, "plain_covers": "out+lse", "library_covers": "out"}
    print(f"flash_fwd at ViT's shape ({row['shape']}): {ms:.4f} ms (bound {row['bound_ms']:.4f} ms by "
          f"{row['bound_by']}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; {row['bound_ms'] / ms:.1%} of bound), "
          f"plain {plain_ms:.3f} ms, library (SDPA) {lib_ms:.4f} ms")
    del q, k, v, qt, kt, vt

    torch.manual_seed(0)
    resnet = tres.ResNet50(device="cuda").eval()
    with torch.no_grad():
        logits, resnet_rate = images_per_s(resnet)
    finite = bool(torch.isfinite(logits).all())
    print(f"ResNet-50 on {card}: batch {B} at {S}^2, bf16 convolutions, eval: {resnet_rate:.1f} images/s; "
          f"logits {tuple(logits.shape)}, finite: {finite}")
    if not finite or logits.shape != (B, 1000):
        failures.append(f"ResNet-50 logits {tuple(logits.shape)}, finite: {finite}")
    del resnet, logits, images

    params = tmlp.init_mlp(seed=0)
    opt = torch.optim.AdamW(params.values(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    batch = {"x": torch.randn(ZOO["mlp_batch"], 784, generator=g, device="cuda"),
             "y": torch.randint(0, 10, (ZOO["mlp_batch"],), generator=g, device="cuda")}
    losses = []
    for _ in range(ZOO["mlp_steps"]):
        opt.zero_grad(set_to_none=True)
        nll, acc = tmlp.mlp_loss(params, batch)
        nll.backward()
        opt.step()
        losses.append(nll.item())
    print(f"MNIST MLP: {ZOO['mlp_steps']} AdamW steps on one batch of {ZOO['mlp_batch']}: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, accuracy {acc.item():.3f}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        failures.append(f"MLP loss did not fall: {losses}")
    print("zoo: " + json.dumps({
        "vit_b16_images_per_s": vit_rate, "vit_launches": vit_counts, "vit_logits_vs_plain": m,
        "vit_kernel_ms": ms, "vit_kernel_plain_ms": plain_ms, "vit_kernel_sdpa_ms": lib_ms,
        "vit_kernel_bound_ms": row["bound_ms"], "resnet50_images_per_s": resnet_rate,
        "mlp_losses": [losses[0], losses[-1]]}))
    if failures:
        raise AssertionError("zoo: " + "; ".join(failures))
    return row, vit_rate


def _ring_chunk_checks(torch, A, R):
    """The ring's chunk function at sp = 4's offsets (rank RING['rank']) on
    the main shape's chunk: the diagonal and a chunk below it through the
    kernel against the plain chunk, the masked chunk launching nothing.
    Returns the readings of the non-causal (below-diagonal) chunk."""
    B, H, D = MAIN["B"], MAIN["H"], MAIN["D"]
    Tc = MAIN["T"] // RING["sp"]
    q, k, v, _ = _inputs(torch, 300, torch.bfloat16, B, Tc, Tc, H, D)
    scale = D**-0.5
    q_start = RING["rank"] * Tc
    failures, below = [], None
    for label, k_start, want_launches in (("masked", q_start + Tc, 0), ("diagonal", q_start, 1), ("below", 0, 1)):
        A.reset_launch_counts()
        out, lse = R._flash_chunk(q, k, v, q_start, k_start, scale)
        torch.cuda.synchronize()
        n = A.launch_counts()["flash_fwd"]
        want_out, want_lse = R._xla_chunk(q, k, v, q_start, k_start, True, scale)
        if n != want_launches:
            failures.append(f"ring chunk {label}: {n} launches, expected {want_launches}")
        if not want_launches:
            ok = not out.any() and bool(R._empty(lse).all())
            print(f"ring chunk {label} (k_start {k_start} > q_start {q_start}): {n} launches, zeros and an empty "
                  f"LSE: {ok}")
            failures += [] if ok else [f"ring chunk {label}: not zeros and an empty LSE"]
            continue
        m = {"out": A.mismatch(out, want_out), "lse": A.mismatch(lse, want_lse)}
        for what, r in m.items():
            failures += [f"ring chunk {label} {what}: {x}" for x in A.over_tolerance(r, torch.bfloat16)]
        print(f"ring chunk {label} (bf16 B{B} T{Tc} H{H} D{D}, q_start {q_start}, k_start {k_start}, "
              f"{'causal' if k_start == q_start else 'non-causal'}, LSE): {n} launch; "
              + " ".join(f"{w} rel_l2={r['rel_l2']:.2e} elem={r['elem']:.2e} max_abs={r['max_abs']:.2e}"
                         for w, r in m.items()))
        if label == "below":
            below = m
    if failures:
        raise AssertionError("parallel: " + "; ".join(failures))
    return q, k, v, below


def _ring_chunk_row(torch, A, q, k, v, errs, launches):
    """The kernels line's row for the forward kernel at the ring chunk's
    shape, non-causal with its LSE: kernel, plain and library ms, bound."""
    B, Tc, H, D = q.shape
    scale = D**-0.5
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    flash_lse = torch.ops.aten._scaled_dot_product_flash_attention  # returns (out, lse, ...)
    with torch.no_grad():
        ms = _time_ms(torch, lambda: A.flash_fwd_cuda(q, k, v, False, scale, 0, save_lse=True), 50)
        plain_ms = _time_ms(torch, lambda: A._plain_flash_fwd(q, k, v, False, scale, 0), 10)
        lib_ms = _time_ms(torch, lambda: flash_lse(qt, kt, vt, 0.0, False, False, scale=scale), 50)
    flops = 4 * D * B * H * Tc * Tc  # QK^T, PV
    nbytes = 4 * B * Tc * H * D * 2 + B * H * Tc * 4  # q k v -> out (bf16), lse (f32)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    row = {"name": "flash_fwd_ring_chunk", "kernel": "flash_fwd", "route": "cuda", "design": DESIGNS["flash_fwd"],
           "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu", "replaces": "ray_tpu/ops/attention.py:57",
           "shape": f"bf16 B{B} T{Tc} H{H} D{D} non-causal, LSE (a ring chunk below the diagonal)",
           "launches": launches, "max_abs_err": max(e["max_abs"] for e in errs.values()),
           "rel_l2_err": max(e["rel_l2"] for e in errs.values()), "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": lib_ms, "plain_covers": "out+lse", "library_covers": "out+lse"}
    print(f"flash_fwd at the ring chunk's shape ({row['shape']}): {ms:.4f} ms (bound {row['bound_ms']:.4f} ms by "
          f"{row['bound_by']}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; {row['bound_ms'] / ms:.1%} of bound), "
          f"plain {plain_ms:.3f} ms, library (aten._scaled_dot_product_flash_attention) {lib_ms:.4f} ms")
    return row


def _attention_paths(torch, A, mesh):
    """ring_attention (causal and not) and ulysses_attention at sp = 1 on the
    main shape, forward and backward, against flash_attention on the same
    inputs; returns (failures, each path's own launches)."""
    from ray_tpu_torch.parallel.ring_attention import ring_attention
    from ray_tpu_torch.parallel.ulysses import ulysses_attention

    B, T, H, D = MAIN["B"], MAIN["T"], MAIN["H"], MAIN["D"]
    q0, k0, v0, dout = _inputs(torch, 301, torch.bfloat16, B, T, T, H, D)
    failures, launches = [], {}
    for label, causal, fn in (("ring causal", True, ring_attention), ("ring non-causal", False, ring_attention),
                              ("ulysses causal", True, ulysses_attention)):
        def run(attend):
            q, k, v = (x.clone().requires_grad_() for x in (q0, k0, v0))
            out = attend(q, k, v)
            out.backward(dout)
            return out.detach(), q.grad, k.grad, v.grad

        want = run(lambda q, k, v: A.flash_attention(q, k, v, causal=causal))
        before = A.launch_counts()
        got = run(lambda q, k, v: fn(q, k, v, mesh, causal=causal).to_local())
        launches[label] = {n: A.launch_counts()[n] - before[n] for n in KERNELS}
        torch.cuda.synchronize()
        m = {w: A.mismatch(a, b) for w, a, b in zip(("out", "dq", "dk", "dv"), got, want)}
        for w, r in m.items():
            failures += [f"{label} {w}: {x}" for x in A.over_tolerance(r, torch.bfloat16)]
        print(f"{label} at sp = 1, bf16 B{B} T{T} H{H} D{D}, against flash_attention: "
              + " ".join(f"{w} rel_l2={r['rel_l2']:.2e} max_abs={r['max_abs']:.2e}" for w, r in m.items())
              + f"; output equal bit for bit: {torch.equal(got[0], want[0])}; launches {launches[label]}")
    return failures, launches


def parallel_phase(torch, card, main_first_loss, main_step_ms):
    """parallel/ on a one-card mesh (module doc, phase 11); returns the
    kernels line's ring-chunk row and the phase's launch counts."""
    _phase("parallel")
    import torch.distributed as dist

    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.parallel import ring_attention as R
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.parallel.multichip import _free_port
    from ray_tpu_torch.parallel.pipeline import pipeline_apply
    from ray_tpu_torch.train.torch.checkpointing import restore_sharded, save_sharded

    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0, world_size=1)
    storage = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        mesh = create_mesh(MeshConfig(), device_type="cuda")
        print(f"mesh: {mesh}, DeviceMesh {mesh.device_mesh}, backend {dist.get_backend()}")
        q, k, v, below = _ring_chunk_checks(torch, A, R)
        failures = []

        # The phase's path: each part's own launches (not those of the references it is held to).
        bad, path_counts = _attention_paths(torch, A, mesh)
        failures += bad

        cfg = tt.TransformerConfig(
            vocab_size=32000, d_model=1024, n_layers=8, n_heads=8, n_kv_heads=8, d_ff=2816,
            max_seq_len=1024, dtype=torch.bfloat16, param_dtype=torch.float32, remat=False, fused_loss=False)
        params = tt.shard_params(tt.init_params(cfg, seed=0), cfg, mesh)
        opt = tt.adamw(params)
        step = tt.make_train_step(cfg, opt, mesh=mesh)
        batch = {"tokens": tt.place_batch(_batch(torch, cfg.vocab_size, MAIN["B"])["tokens"], mesh)}
        before = A.launch_counts()
        losses, ms = [], []
        for _ in range(SHARDED["warmup"] + SHARDED["steps"]):
            t = time.perf_counter()
            losses.append(step(params, batch).item())
            ms.append((time.perf_counter() - t) * 1e3)
        step_counts = path_counts["sharded step"] = {n: A.launch_counts()[n] - before[n] for n in KERNELS}
        timed = ms[SHARDED["warmup"]:]
        med = sorted(timed)[len(timed) // 2]
        rel = abs(losses[0] - main_first_loss) / abs(main_first_loss)
        want = {n: len(ms) * cfg.n_layers for n in KERNELS}
        print(f"sharded step on {card} ({mesh}; params DTensors, the batch sharded over dp): losses "
              f"{[round(x, 4) for x in losses]}; first loss {losses[0]:.6f}, main path's {main_first_loss:.6f} "
              f"(relative difference {rel:.2e}, bar {SHARDED_LOSS_RTOL}); step {med:.1f} ms median of "
              f"{len(timed)} (min {min(timed):.1f}, max {max(timed):.1f}; warm-up {[round(x, 1) for x in ms[:SHARDED['warmup']]]}) "
              f"beside the main path's {main_step_ms:.1f} ms meshless; launches {step_counts} (expected {want})")
        if not rel <= SHARDED_LOSS_RTOL:
            failures.append(f"sharded step: first loss {losses[0]} is not the main path's {main_first_loss}")
        if step_counts != want:
            failures.append(f"sharded step launched {step_counts}, expected {want}")
        if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
            failures.append(f"sharded step: loss not finite or did not fall: {losses}")

        # pipeline_apply at pp = 1, one flagship layer as the stage, against the layer itself.
        layer = {n: w.to_local()[:1].detach() for n, w in params["layers"].items()}
        x0 = torch.randn(MAIN["B"] // 2, MAIN["T"], cfg.d_model, generator=torch.Generator(device="cuda").manual_seed(5),
                         device="cuda").to(torch.bfloat16)
        cos, sin = tt._rope_tables(torch.arange(MAIN["T"], device="cuda")[None], cfg.head_dim, cfg.rope_theta)
        stage = lambda lp, h: tt._layer(lp, h, cos, sin, cfg)[0]  # noqa: E731
        before = A.launch_counts()
        x = x0.clone().requires_grad_()
        y = pipeline_apply(stage, layer, x, mesh)
        y.float().square().mean().backward()
        pipe_counts = path_counts["pipeline"] = {n: A.launch_counts()[n] - before[n] for n in KERNELS}
        x_ref = x0.clone().requires_grad_()
        y_ref = stage({n: w[0] for n, w in layer.items()}, x_ref)
        y_ref.float().square().mean().backward()
        same = torch.equal(y, y_ref) and torch.equal(x.grad, x_ref.grad)
        print(f"pipeline_apply at pp = 1 (1 stage, 1 microbatch; one flagship layer, bf16 [{MAIN['B'] // 2}, "
              f"{MAIN['T']}, {cfg.d_model}]): output and input gradient equal to the layer's bit for bit: {same}; "
              f"launches {pipe_counts}")
        if not same:
            failures.append("pipeline_apply at pp = 1 differs from the layer")
        counts = {n: sum(c[n] for c in path_counts.values()) for n in KERNELS}
        del x, y, x_ref, y_ref

        # The checkpoint of the trained params and AdamW state, on the card.
        names = {id(p): n for n, p in (list((k2, v2) for k2, v2 in params.items() if k2 != "layers")
                                       + [(f"layers.{k2}", v2) for k2, v2 in params["layers"].items()])}
        tree = {"params": params, "opt": {names[id(p)].replace(".", "/"): dict(opt.state[p]) for p in opt.state}}
        t_ck = time.perf_counter()
        path = save_sharded(os.path.join(storage, "ck"), tree)
        got = restore_sharded(path, like=tree)
        ck_s = time.perf_counter() - t_ck

        def leaves(t):
            return [y for v2 in t.values() for y in leaves(v2)] if isinstance(t, dict) else [t]

        pairs = list(zip(leaves(tree), leaves(got)))
        local = lambda t: t.to_local() if hasattr(t, "to_local") else t  # noqa: E731
        equal = all(torch.equal(local(a), local(b)) for a, b in pairs)
        nbytes = sum(a.numel() * a.element_size() for a, _ in pairs)
        print(f"checkpoint: save_sharded + restore_sharded of {len(pairs)} tensors ({nbytes / 2**30:.2f} GiB: params "
              f"and AdamW state) in {ck_s:.1f} s; equal bit for bit: {equal}")
        if not equal:
            failures.append("the restored checkpoint differs from the saved state")
        del params, opt, step, batch, tree, got, pairs
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(storage, ignore_errors=True)
    print(f"parallel phase launches: {counts} ({path_counts})")
    failures += [f"parallel phase never launched {n}" for n in KERNELS if not counts[n]]
    ring = [path_counts[p]["flash_fwd"] for p in ("ring causal", "ring non-causal")]
    if ring != [1, 1]:  # sp = 1: one chunk, the diagonal (causal) or a full block
        failures.append(f"ring attention launched the forward kernel {ring} times, not once a path")
    row = _ring_chunk_row(torch, A, q, k, v, below, sum(ring))
    print("parallel: " + json.dumps({
        "mesh": str(mesh), "sharded_first_loss": losses[0], "main_first_loss": main_first_loss,
        "sharded_step_ms": med, "main_step_ms": main_step_ms, "launches": counts, "checkpoint_s": ck_s,
        "checkpoint_bytes": nbytes, "phase_s": time.perf_counter() - t0}))
    if failures:
        raise AssertionError("parallel: " + "; ".join(failures))
    return row, counts


# The a10 phase: collectives, device objects and the MPMD pipeline of the
# flagship's layers (module doc, phase 12).
A10 = dict(coll_numel=1 << 22, coll_iters=5, stages=2, batch=16, microbatch=2, runs=(8, 2),
           spill_limit=256 << 20, actor_gpus=0.25, alone_iters=5)


def _bits_checksum(torch, t) -> list:
    """Two int64 sums of a tensor's bits on its own device (plain and
    position-weighted), so two processes can compare a large tensor without
    a host copy."""
    width = {4: torch.int32, 2: torch.int16}[t.element_size()]
    i = t.detach().reshape(-1).view(width).to(torch.int64)
    w = torch.arange(i.numel(), device=i.device, dtype=torch.int64) % 65521 + 1
    return [int(i.sum()), int((i * w).sum())]


def mpmd_stage(params, h, cfg):
    """One MPMD stage: the flagship's layers (models/transformer.py _layer)
    over its slice of the stacked layer weights, rotary tables from T."""
    import torch

    from ray_tpu_torch.models import transformer as tt

    # As the driver's device phase sets: f32 products in full f32, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    cos, sin = tt._rope_tables(torch.arange(h.shape[1], device=h.device)[None], cfg.head_dim, cfg.rope_theta)
    for i in range(next(iter(params.values())).shape[0]):
        h = tt._layer({n: w[i] for n, w in params.items()}, h, cos, sin, cfg)[0]
    return h


def _a10_actor_class(rt):
    @rt.remote(tensor_transport="collective")
    class A10Actor:
        """A collective-group member, a device-object holder and a consumer."""

        def __init__(self, device):
            import torch

            self.device = torch.device(device)
            if self.device.type == "cuda":
                torch.cuda.set_device(0)
            self.flat = None

        def pid(self):
            return os.getpid()

        def init_collective(self, world, rank, backend, group):
            from ray_tpu_torch.util import collective as col

            col.init_collective_group(world, rank, backend=backend, group_name=group)

        def collectives(self, group, numel, iters):
            """Each verb on bf16 and f32 tensors of this group's device (world
            1: every result equals its input); ms per call, the mean of
            ``iters`` after a first call."""
            import torch

            from ray_tpu_torch.util import collective as col

            rows = []
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn(numel, generator=torch.Generator(device=self.device).manual_seed(3),
                                device=self.device).to(dt)
                verbs = {
                    "allreduce": (lambda: col.allreduce(x, group), x),
                    "allgather": (lambda: col.allgather(x, group), x[None]),
                    "reducescatter": (lambda: col.reducescatter(x[None], group), x),
                    "broadcast": (lambda: col.broadcast(x, 0, group), x),
                    "barrier": (lambda: col.barrier(group), None),
                }
                for verb, (fn, want) in verbs.items():
                    out = fn()
                    if self.device.type == "cuda":
                        torch.cuda.synchronize()
                    t = time.perf_counter()
                    for _ in range(iters):
                        fn()
                    if self.device.type == "cuda":
                        torch.cuda.synchronize()
                    ms = (time.perf_counter() - t) * 1e3 / iters
                    ok = want is None or (torch.equal(out, want) and out.device == x.device)
                    rows.append({"verb": verb, "dtype": str(dt).removeprefix("torch."), "numel": numel, "ms": ms,
                                 "device": None if out is None else str(out.device), "ok": bool(ok)})
            return rows

        def make_weights(self, cfg):
            """The flagship's parameters from seed 0, flattened to one f32
            tensor: returned under tensor_transport, it stays here."""
            import torch

            from ray_tpu_torch.models import transformer as tt

            params = tt.init_params(cfg, seed=0, device=self.device)
            self.flat = torch.cat([p.detach().reshape(-1).float() for p in tt.param_leaves(params)])
            return self.flat

        def same_ptr(self, refs):
            return rt.get(refs[0]).data_ptr() == self.flat.data_ptr()

        def checksum(self):
            import torch

            return _bits_checksum(torch, self.flat)

        def take(self, refs):
            import torch

            t = time.perf_counter()
            v = rt.get(refs[0])
            if v.device.type == "cuda":
                torch.cuda.synchronize()
            return {"s": time.perf_counter() - t, "checksum": _bits_checksum(torch, v), "device": str(v.device),
                    "nbytes": v.numel() * v.element_size()}

        def spill_restore(self, freed, limit):
            """Put the weights again, this actor as their owner (a borrower
            would read a spilled copy from its node's arena directly), once
            the driver's ref ``freed`` is released here; lower the resident
            limit below them and put a small device object (they spill to
            the arena); then resolve them again (restored onto the device)."""
            import torch

            from ray_tpu_torch._private import worker_context
            from ray_tpu_torch.experimental.device_object import device_object_stats
            from ray_tpu_torch.experimental.device_object.manager import active_manager

            deadline = time.monotonic() + 30
            while active_manager().entry(freed) is not None and time.monotonic() < deadline:
                time.sleep(0.01)
            own = rt.put(self.flat, tensor_transport="collective")
            want = _bits_checksum(torch, self.flat)
            self.flat = None  # the manager's entry holds the only reference
            before = device_object_stats()
            cfg = worker_context.get_core_worker().cfg
            cfg.devobj_resident_limit_bytes = limit
            try:
                small = rt.put(torch.ones(1, device=self.device), tensor_transport="collective")
                spilled = device_object_stats()
                t = time.perf_counter()
                v = rt.get(own)
                if v.device.type == "cuda":
                    torch.cuda.synchronize()
                restore_s = time.perf_counter() - t
                del small
            finally:
                cfg.devobj_resident_limit_bytes = 0
            after = device_object_stats()
            return {"spilled_count": spilled["spilled_count"], "spills": spilled["spills"] - before["spills"],
                    "restores": after["restores"] - before["restores"], "restore_s": restore_s,
                    "equal": _bits_checksum(torch, v) == want, "device": str(v.device)}

        def stats(self):
            from ray_tpu_torch.experimental.device_object import device_object_stats
            from ray_tpu_torch.util.collective.p2p import COLL

            return {**device_object_stats(), "host_sync_fallbacks": COLL.host_sync_fallbacks,
                    "bcast_recvs": COLL.bcast_recvs}

    return A10Actor


def _a10_weight_sync(torch, rt, dobj, col, Actor, cfg, device, store, failures):
    """Collectives on a world-1 group, then the flagship's weights as one
    device object: holder resolve, one consumer, a two-consumer broadcast,
    spill and restore."""
    opts = {"num_gpus": A10["actor_gpus"]} if device == "cuda" else {}
    actors = [Actor.options(**opts).remote(device) for _ in range(3)]
    h, a, b = actors
    pids = set(rt.get([x.pid.remote() for x in actors], timeout=300))
    backend = "nccl" if device == "cuda" else "gloo"
    rt.get(h.init_collective.remote(1, 0, backend, "world1"), timeout=120)
    coll = rt.get(h.collectives.remote("world1", A10["coll_numel"], A10["coll_iters"]), timeout=300)
    for r in coll:
        print(f"{backend} world 1 {r['verb']:>13} {r['dtype']:>8} [{r['numel']}]: {r['ms']:.3f} ms, "
              f"result on {r['device']}, equal to the input: {r['ok']}")
    failures += [f"{backend} {r['verb']} {r['dtype']} differs or left {device}" for r in coll
                 if not r["ok"] or (r["device"] is not None and not r["device"].startswith(device))]
    col.create_collective_group([h, a], backend="cpu", group_name="pair")
    col.create_collective_group([h, a, b], backend="cpu", group_name="fan")
    ref = h.make_weights.remote(cfg)
    want = rt.get(h.checksum.remote(), timeout=300)
    same_ptr = rt.get(h.same_ptr.remote([ref]), timeout=60)
    used0 = store.usage()["used"]
    t = time.perf_counter()
    dobj.broadcast(ref, "pair", timeout=120)
    one = rt.get(a.take.remote([ref]), timeout=300)
    one_s = time.perf_counter() - t
    t = time.perf_counter()
    fan = dobj.broadcast(ref, "fan", timeout=120)
    two = rt.get([a.take.remote([ref]), b.take.remote([ref])], timeout=300)
    fan_s = time.perf_counter() - t
    store_bytes = store.usage()["used"] - used0
    stats = rt.get([x.stats.remote() for x in actors], timeout=60)
    nbytes = one["nbytes"]
    print(f"weights: {nbytes / 1e6:.1f} MB f32 ({nbytes // 4} params) held on the holder's {device}; holder resolve "
          f"returns the same data_ptr: {same_ptr}")
    print(f"one consumer (broadcast over a 2-member group, then get): {one_s:.3f} s, {nbytes / one_s / 1e9:.2f} GB/s "
          f"(of which the consumer's get {one['s']:.3f} s); bits equal: {one['checksum'] == want}, on {one['device']}")
    print(f"two consumers (one broadcast over a 3-member group, then two gets): {fan_s:.3f} s, "
          f"{2 * nbytes / fan_s / 1e9:.2f} GB/s delivered; ranks {fan.get('ok_ranks')}; bits equal: "
          f"{[x['checksum'] == want for x in two]}, on {[x['device'] for x in two]}")
    print(f"store bytes added over the handoffs: {store_bytes}; holder/consumers transfers_host "
          f"{[s['transfers_host'] for s in stats]}, host_sync_fallbacks {[s['host_sync_fallbacks'] for s in stats]}, "
          f"bcast_recvs {[s['bcast_recvs'] for s in stats]}")
    if not same_ptr:
        failures.append("the holder's own resolve is not the live tensor")
    if one["checksum"] != want or any(x["checksum"] != want for x in two):
        failures.append("a consumer's copy of the weights differs from the holder's")
    if not all(x["device"].startswith(device) for x in [one] + two):
        failures.append(f"a consumer's copy is not on {device}")
    if store_bytes != 0 or any(s["transfers_host"] or s["host_sync_fallbacks"] for s in stats):
        failures.append("a handoff went through the store or a host fallback")
    oid = ref.hex()
    del ref
    spill = rt.get(h.spill_restore.remote(oid, A10["spill_limit"]), timeout=300)
    print(f"spill and restore under devobj_resident_limit_bytes={A10['spill_limit']}: spilled {spill['spilled_count']} "
          f"({spill['spills']} spill), restored {spill['restores']} in {spill['restore_s']:.3f} s onto "
          f"{spill['device']}, bits equal: {spill['equal']}")
    if not (spill["spills"] == 1 and spill["restores"] == 1 and spill["equal"] and spill["device"].startswith(device)):
        failures.append(f"spill and restore: {spill}")
    for x in actors:
        rt.kill(x)
    return pids, {"collectives": coll, "bytes": nbytes, "one_s": one_s, "one_gbps": nbytes / one_s / 1e9,
                  "fan_s": fan_s, "fan_gbps": 2 * nbytes / fan_s / 1e9, "store_bytes": store_bytes,
                  "transfers_host": sum(s["transfers_host"] for s in stats),
                  "host_sync_fallbacks": sum(s["host_sync_fallbacks"] for s in stats),
                  "restore_s": spill["restore_s"]}


def _a10_mpmd(torch, rt, dobj, cfg, device, store, failures):
    """The flagship's 8 layers as a 2-stage MPMD pipeline, held to the
    in-process composition; returns the stages' forward-kernel launches."""
    import functools

    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.parallel.mpmd_pipeline import mpmd_pipeline

    S, T = A10["stages"], MAIN["T"]
    params = tt.init_params(cfg, seed=0, device=device)
    stacked = {n: w.reshape(S, cfg.n_layers // S, *w.shape[1:]) for n, w in params["layers"].items()}
    g = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (A10["batch"], T + 1), generator=g, device=device)[:, :T]
    x = params["embed"].to(cfg.dtype)[tokens]
    stage = functools.partial(mpmd_stage, cfg=cfg)
    t = time.perf_counter()
    pipe = mpmd_pipeline(stage, stacked, num_microbatches=A10["runs"][0], warmup_x=x[:A10["microbatch"]],
                         device=device)
    build_s = time.perf_counter() - t
    pids = set(rt.get([s.pid.remote() for s in pipe.stages], timeout=60))
    with torch.no_grad():
        per_stage = [{n: w[k] for n, w in stacked.items()} for k in range(S)]
        ref = []
        for xm in x.split(A10["microbatch"]):
            for p in per_stage:
                xm = stage(p, xm)
            ref.append(xm)
        ref = torch.cat(ref)
    pipe.apply(x[:2 * A10["microbatch"]], num_microbatches=2)  # the compiled loops' first iteration
    rt.get([s.time_device.remote(device == "cuda") for s in pipe.stages], timeout=60)
    runs, launches = [], 0
    for M in A10["runs"]:
        xs = x[:M * A10["microbatch"]]
        rt.get([s.reset_launch_counts.remote() for s in pipe.stages], timeout=60)
        pipe.reset_stage_stats()
        dev0, drv0, used0 = pipe.stage_devobj_stats(), dobj.device_object_stats(), store.usage()["used"]
        t = time.perf_counter()
        y = pipe.apply(xs, num_microbatches=M)
        if device == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t
        dev1, drv1, used1 = pipe.stage_devobj_stats(), dobj.device_object_stats(), store.usage()["used"]
        rows, bubble = pipe.stage_stats(), pipe.bubble_fraction()
        counts = [c["flash_fwd"] for c in rt.get([s.launch_counts.remote() for s in pipe.stages], timeout=60)]
        spans = rt.get([s.device_spans.remote() for s in pipe.stages], timeout=60)
        equal = torch.equal(y, ref[:xs.shape[0]])
        hop_bytes = xs[:A10["microbatch"]].numel() * xs.element_size()
        hop_ms = rows[-1]["resolve_ns"] / max(1, rows[-1]["iters"]) / 1e6
        host = sum(b["transfers_host"] - a["transfers_host"] for a, b in zip(dev0 + [drv0], dev1 + [drv1]))
        run = {"M": M, "s": dt, "microbatches_per_s": M / dt, "bubble": bubble,
               "stages": [{"busy_ms": r["busy_ns"] / 1e6, "stall_ms": r["stall_ns"] / 1e6,
                           "resolve_ms": r["resolve_ns"] / 1e6, "iters": r["iters"],
                           # The loop's time outside the stage call and its
                           # input reads: the output's emit (waiting for the
                           # kernels, the device-to-host copy, the frames).
                           "other_ms": dt * 1e3 - (r["busy_ns"] + r["stall_ns"]) / 1e6,
                           "device_span_ms": sum(sp) if sp else None, "device_spans": len(sp)}
                          for r, sp in zip(rows, spans)],
               "hop_bytes": hop_bytes, "hop_ms": hop_ms, "flash_fwd": counts, "equal": equal,
               "store_bytes": used1 - used0, "transfers_host": host, "devobj": dev1}
        runs.append(run)
        print(f"mpmd M={M} ({xs.shape[0]} x {T} tokens, microbatches of {A10['microbatch']}): {dt * 1e3:.1f} ms, "
              f"{M / dt:.1f} microbatches/s, bubble fraction {bubble:.3f}; stages busy/stall ms "
              f"{[(round(r['busy_ms'], 2), round(r['stall_ms'], 2)) for r in run['stages']]}; a hop {hop_bytes} B in "
              f"{hop_ms:.3f} ms (stage 1's resolve); forward-kernel launches per stage {counts}; output equal to "
              f"the in-process composition bit for bit: {equal}; store bytes added {used1 - used0}, host "
              f"transfers {host}")
        print(f"mpmd M={M} per stage, ms a microbatch: busy (issuing the stage) "
              f"{[round(r['busy_ms'] / M, 2) for r in run['stages']]}, stall "
              f"{[round(r['stall_ms'] / M, 2) for r in run['stages']]}, other (the output's emit: waiting for the "
              f"kernels, the device-to-host copy, the frames) {[round(r['other_ms'] / M, 2) for r in run['stages']]}; "
              f"device span of a run (CUDA events around it: first operation to last, gaps included) "
              f"{[None if r['device_span_ms'] is None else round(r['device_span_ms'] / r['device_spans'], 2) for r in run['stages']]}")
        print(f"mpmd M={M} stage_devobj_stats: {dev1}")
        if not equal:
            failures.append(f"mpmd M={M}: the pipeline's output differs from the in-process composition")
        want = [cfg.n_layers // S * M] * S if device == "cuda" else [0] * S
        if counts != want:
            failures.append(f"mpmd M={M}: stages launched the forward kernel {counts} times, expected {want}")
        if used1 != used0 or host:
            failures.append(f"mpmd M={M}: {used1 - used0} store bytes and {host} host transfers in a steady run")
        launches += sum(counts)
    rt.get([s.time_device.remote(False) for s in pipe.stages], timeout=60)
    # Stage 0 alone, stage 1 idle (both run the same shapes; a profiler's
    # start costs ~10 s in each process it runs in).
    t = time.perf_counter()
    alone = rt.get(pipe.stages[0].time_alone.remote(x[:A10["microbatch"]], A10["alone_iters"]), timeout=120)
    kernel = ("not measured" if alone["kernel_ms"] is None
              else f"{alone['kernel_ms']:.3f} ms ({alone['ops']:.0f} device operations)")
    print(f"mpmd stage 0 alone, {A10['alone_iters']} runs of one microbatch, each finished before the next: "
          f"issue {alone['issue_ms']:.3f} ms, finished {alone['wall_ms']:.3f} ms a run; kernels and copies under "
          f"torch.profiler {kernel} a run")
    alone_s = time.perf_counter() - t
    pipe.teardown(kill_actors=False)
    left = [s["resident_count"] for s in pipe.stage_devobj_stats()] + [dobj.device_object_stats()["resident_count"]]
    print(f"after teardown: resident device objects per stage and in the driver {left}")
    if any(left):
        failures.append(f"teardown left resident device objects {left}")
    for s in pipe.stages:
        rt.kill(s)
    return pids, launches, {"build_s": build_s, "runs": runs, "alone": alone, "alone_s": alone_s,
                            "resident_after_teardown": left}


def a10_phase(torch, device="cuda", cfg=None):
    """Collectives, device objects and the MPMD pipeline (module doc, phase
    12); returns the MPMD stages' forward-kernel launches."""
    _phase("a10")
    import ray_tpu_torch as rt
    from ray_tpu_torch.experimental import device_object as dobj
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.util import collective as col

    cfg = cfg or tt.TransformerConfig(
        vocab_size=32000, d_model=1024, n_layers=8, n_heads=8, n_kv_heads=8, d_ff=2816,
        max_seq_len=1024, dtype=torch.bfloat16, param_dtype=torch.float32, remat=False, fused_loss=False)
    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1 if device == "cuda" else 0, object_store_memory=2 << 30)
    failures, pids = [], set()
    try:
        store = rt._global_node.raylet.store
        marks = [time.perf_counter()]
        p1, sync = _a10_weight_sync(torch, rt, dobj, col, _a10_actor_class(rt), cfg, device, store, failures)
        marks.append(time.perf_counter())
        p2, launches, mpmd = _a10_mpmd(torch, rt, dobj, cfg, device, store, failures)
        marks.append(time.perf_counter())
        pids = p1 | p2
    finally:
        rt.shutdown()
    sections = {"init": marks[0] - t0, "weight_sync": marks[1] - marks[0], "mpmd": marks[2] - marks[1],
                "shutdown": time.perf_counter() - marks[2]}
    print("a10 sections, s: " + ", ".join(f"{k} {v:.1f}" for k, v in sections.items())
          + f" (mpmd: stage 0 alone {mpmd['alone_s']:.1f})")
    deadline = time.monotonic() + 30
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = sorted(p for p in pids if _alive(p))
    if left:
        failures.append(f"actor processes {left} outlived shutdown()")
    print("a10: " + json.dumps({"weight_sync": sync, "mpmd": mpmd, "mpmd_launches": launches,
                                "sections_s": sections, "phase_s": time.perf_counter() - t0}))
    if failures:
        raise AssertionError("a10: " + "; ".join(failures))
    return launches


def _llm_http(host, port, body, stop_after=None, timeout=600):
    """One /llm request over HTTP/1.1: (tokens, {"t0": the send, "stamps":
    each token's arrival, "done": whether [DONE] came}), on perf_counter's
    clock. SSE by default (``stop_after``: the client closes its socket after
    that many tokens); ``"stream": false`` buffers (no stamps)."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        info = {"t0": time.perf_counter(), "stamps": [], "done": False}
        conn.request("POST", "/llm", body=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"/llm answered {resp.status}: {resp.read()[:300]!r}")
        if not body.get("stream", True):
            return json.loads(resp.read())["tokens"], dict(info, done=True)
        toks, buf = [], b""
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                return toks, info
            buf += chunk
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                payload = event[len(b"data: "):]
                if payload == b"[DONE]":
                    info["done"] = True
                    return toks, info
                toks.append(json.loads(payload)["token"])
                info["stamps"].append(time.perf_counter())
                if stop_after is not None and len(toks) >= stop_after:
                    conn.sock.shutdown(socket.SHUT_RDWR)
                    return toks, info
    finally:
        conn.close()


def _http_traffic(host, port, specs, clients):
    """`clients` closed-loop SSE clients over `specs`; per spec
    `_llm_http`'s pair, and the wall seconds."""
    order, results, errors = itertools.count(), [None] * len(specs), []

    def client():
        try:
            while (i := next(order)) < len(specs):
                prompt, new, kw = specs[i]
                results[i] = _llm_http(host, port, dict(tokens=prompt, max_new_tokens=new, **kw))
        except BaseException as e:  # noqa: BLE001 — reported after the join
            errors.append(e)

    threads = [threading.Thread(target=client, name=f"client{j}") for j in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads) or None in results:
        raise AssertionError(f"HTTP traffic failed: {errors[:3]}")
    if not all(info["done"] for _, info in results):
        raise AssertionError("an SSE stream ended without [DONE]")
    return results, wall


def _http_summary(results, wall):
    """Output tokens/s, TTFT and TPOT on the client's clock; the gap from a
    request's first token to its second; and the share of second tokens that
    came after every request's first (for a batch sent at once: after the
    last prefill)."""
    stamps = [info["stamps"] for _, info in results]
    out = sum(len(s) for s in stamps)
    ttft = [(s[0] - info["t0"]) * 1e3 for s, (_, info) in zip(stamps, results)]
    tpot = [(s[-1] - s[0]) * 1e3 / (len(s) - 1) for s in stamps if len(s) > 1]
    seconds = [s[1] for s in stamps if len(s) > 1]
    last_first = max(s[0] for s in stamps)
    return {"requests": len(results), "output_tokens": out, "wall_s": wall, "output_tokens_per_s": out / wall,
            "ttft_ms_p50": _percentile(ttft, 50), "ttft_ms_p99": _percentile(ttft, 99),
            "tpot_ms_mean": sum(tpot) / len(tpot),
            "second_token_ms_p50": _percentile([(s[1] - s[0]) * 1e3 for s in stamps if len(s) > 1], 50),
            "second_after_last_first": sum(t > last_first for t in seconds) / len(seconds)}


def _sequential_gaps(infos):
    """Requests sent one at a time: their median TTFT and median gap between
    tokens after the first (one busy slot), ms."""
    gaps = [(b - a) * 1e3 for info in infos for a, b in zip(info["stamps"][1:], info["stamps"][2:])]
    ttft = [(info["stamps"][0] - info["t0"]) * 1e3 for info in infos]
    return {"ttft_ms_median": float(np.median(ttft)), "gap_ms_median": float(np.median(gaps))}


def _serve_pids(rt):
    """pid of every live Serve actor (controller, proxy, replicas) of this
    node, by name."""
    from ray_tpu_torch._private import worker_context

    actors = worker_context.get_core_worker().gcs.call("list_actors", {}, timeout=10)["actors"]
    ids = {a["actor_id"]: a.get("name") or "" for a in actors if a.get("state") != "DEAD"}
    return {ids[w.actor_id]: w.pid for w in rt._global_node.raylet.workers.values()
            if w.actor_id in ids and ids[w.actor_id].startswith("SERVE_")}


def _replica_stats(rt, serve, dep):
    return rt.get(serve.get_deployment_handle(dep).get_stats.remote(), timeout=60)


def _handoff_probe(torch, LLMEngine, cfg, params, engine_config, specs):
    """The handoff in this process, on `specs`: a plain engine, and a
    prefill-role engine whose sealed payload a decode-role engine imports,
    each sampling row recorded. Prints whether the imported prompt blocks
    equal the plain engine's bit for bit, the first token where the two
    runs part, and the first sampling row (token index) whose logits differ
    bitwise, with its largest difference."""
    out = []
    for prompt, new, kw in specs:
        engines = [LLMEngine(params, cfg, **engine_config, role=r) for r in ("both", "prefill", "decode")]
        rows = {"plain": {}, "handoff": {}}
        for eng, key in zip(engines, ("plain", "handoff", "handoff")):
            def recording(req, row, _sample=eng._sample, _rows=rows[key]):
                _rows[len(req._sched_generated)] = row.copy()
                return _sample(req, row)

            eng._sample = recording
        plain, pre, dec = engines
        try:
            want = plain.submit(prompt, max_new_tokens=new, **kw).result(timeout=300)
            req = pre.submit(prompt, max_new_tokens=new, **kw)
            req.result(timeout=300)
            desc = dict(req.handoff)
            tok0 = desc.pop("tok0")
            got = [tok0] + dec.submit(prompt, max_new_tokens=new, resume_tokens=[tok0], kv_import=desc,
                                      **kw).result(timeout=300)
            hashes = [h for h in dec._prefix if h in plain._prefix]
            equal = all(torch.equal(plain._cache[k][:, plain._prefix[h].bid], dec._cache[k][:, dec._prefix[h].bid])
                        for h in hashes for k in ("k", "v"))
        finally:
            for e in engines:
                e.shutdown()
        j = next((k for k, (x, y) in enumerate(zip(want, got)) if x != y), None)
        common = sorted(set(rows["plain"]) & set(rows["handoff"]))
        diffs = {k: float(np.abs(rows["plain"][k].astype(np.float64) - rows["handoff"][k]).max()) for k in common
                 if j is None or k <= j}
        first_row = next((k for k in sorted(diffs) if diffs[k] > 0), None)
        out.append({"prompt_tokens": len(prompt), "sampled": bool(kw), "blocks_compared": len(hashes),
                    "blocks_equal": equal, "first_token_difference": j, "first_row_difference": first_row,
                    "row_max_abs_diff": diffs.get(first_row, 0.0), "rows_compared": len(diffs)})
        print(f"  in-process handoff, a {len(prompt)}-token {'sampled' if kw else 'greedy'} request: {len(hashes)} "
              f"imported prompt blocks {'equal' if equal else 'NOT equal'} to the plain engine's bit for bit; tokens "
              + ("equal" if j is None else f"first differ at {j}") + "; sampling rows "
              + ("equal bit for bit" if first_row is None else
                 f"first differ at token {first_row} (largest difference {diffs[first_row]:.3g})")
              + f" of {len(diffs)} compared")
    return out


def serve_app_phase(torch, card, serve_res=None, device="cuda", cfg=None):
    """The serve phase's model behind serve.run and HTTP (module doc, phase
    13): a monolithic LLMDeployment, then a disaggregated prefill/decode pair
    on one card; returns the phase's numbers."""
    _phase("serve app")
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import flight_recorder, worker_context
    from ray_tpu_torch.experimental import device_object as dobj
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.serve.llm import LLMDeployment, LLMEngine, disaggregated_llm_app
    from ray_tpu_torch.serve.llm import kv_transfer
    from ray_tpu_torch.serve.llm.engine import block_hashes

    sa, tr = SERVE_APP, TRAFFIC
    cfg = cfg or tt.TransformerConfig(**SERVE_CFG, dtype=torch.bfloat16, param_dtype=torch.float32, remat=False)
    model_config = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for field in ("dtype", "param_dtype"):
        model_config[field] = str(model_config[field]).removeprefix("torch.")
    engine_config = dict(num_slots=tr["slots"], block_size=tr["block_size"], prefill_chunk=tr["prefill_chunk"])
    actor_options = {"num_gpus": sa["replica_gpus"]}
    system, specs = _traffic_specs(cfg, sa["requests"])
    rng = np.random.default_rng(3)
    exact = [system + rng.integers(0, cfg.vocab_size, rng.integers(32, 193)).tolist() for _ in range(sa["exact"])]
    failures, marks, res = [], {}, {}
    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1, object_store_memory=1 << 30)
    try:
        serve.start()
        host, port = serve.http_address()
        marks["init_s"] = time.perf_counter() - t0
        # ---- (a) monolithic ----
        t = time.perf_counter()
        app = serve.deployment(ray_actor_options=actor_options)(LLMDeployment).bind(
            model_config=model_config, engine_config=engine_config, init_seed=0, device=device)
        serve.run(app, name="mono", route_prefix="/llm")
        marks["mono_up_s"] = time.perf_counter() - t
        t = time.perf_counter()
        params = tt.init_params(cfg, seed=0, device=device)
        eng = LLMEngine(params, cfg, **engine_config)
        try:
            wrong, sse, infos = [], [], []
            for i, prompt in enumerate(exact):
                want = eng.submit(prompt, max_new_tokens=sa["exact_new"]).result(timeout=300)
                got, info = _llm_http(host, port, dict(tokens=prompt, max_new_tokens=sa["exact_new"]))
                sse.append(got)
                infos.append(info)
                if not info["done"] or got != want:
                    wrong.append(i)
        finally:
            eng.shutdown()
        mono_seq = _sequential_gaps(infos)
        twin = _llm_http(host, port, dict(tokens=exact[0], max_new_tokens=sa["exact_new"], stream=False))[0]
        print(f"monolithic app ({sa['replica_gpus']} of the card, one replica): {sa['exact'] - len(wrong)} of "
              f"{sa['exact']} greedy prompts of {sa['exact_new']} tokens over SSE equal to an in-process LLMEngine "
              f"on the same weights; the first again, buffered: {'equal' if twin == sse[0] else 'DIFFERENT'}")
        if wrong:
            failures.append(f"monolithic HTTP tokens differ from the in-process engine for prompts {wrong}")
        if twin != sse[0]:
            failures.append("the buffered request's tokens differ from its SSE twin's")
        marks["exact_s"] = time.perf_counter() - t
        t = time.perf_counter()
        results, wall = _http_traffic(host, port, specs, sa["clients"])
        mono = _http_summary(results, wall)
        mono["sequential"] = mono_seq
        stats = _replica_stats(rt, serve, "LLMDeployment")
        mono["replica_stats"] = stats
        print(f"monolithic app, HTTP traffic on {card}: {mono['requests']} requests from {sa['clients']} closed-loop "
              f"SSE clients in {wall:.2f} s: {mono['output_tokens_per_s']:.1f} output tokens/s; TTFT p50 "
              f"{mono['ttft_ms_p50']:.1f} ms, p99 {mono['ttft_ms_p99']:.1f} ms; TPOT {mono['tpot_ms_mean']:.2f} ms, the "
              f"second token {mono['second_token_ms_p50']:.1f} ms after the first (p50) "
              "(client clock)" + ("" if serve_res is None else
              f"; in process (serve phase, {serve_res['requests']} requests): {serve_res['output_tokens_per_s']:.1f} "
              f"tokens/s, TTFT p50 {serve_res['ttft_ms_p50']:.1f} / p99 {serve_res['ttft_ms_p99']:.1f} ms, TPOT "
              f"{serve_res['tpot_ms_mean']:.2f} ms"))
        print(f"monolithic replica get_stats(): {json.dumps(stats)}")
        marks["mono_traffic_s"] = time.perf_counter() - t
        t = time.perf_counter()
        before = _replica_stats(rt, serve, "LLMDeployment")
        _llm_http(host, port, dict(tokens=specs[0][0], max_new_tokens=tr["new"][1]), stop_after=sa["disconnect_after"])
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            st = _replica_stats(rt, serve, "LLMDeployment")
            if st["cancelled"] > before["cancelled"] and st["running"] == 0:
                break
            time.sleep(0.05)
        idle = st["free_blocks"] + st["cached_blocks"] == st["num_blocks"]
        print(f"client disconnect after {sa['disconnect_after']} tokens: cancelled {before['cancelled']} -> "
              f"{st['cancelled']}, running {st['running']}, free {st['free_blocks']} + cached {st['cached_blocks']} "
              f"of {st['num_blocks']} blocks ({'idle' if idle else 'NOT idle'}) "
              f"{(time.monotonic() - deadline + 60) * 1e3:.0f} ms after the close")
        if st["cancelled"] != before["cancelled"] + 1 or st["running"] or not idle:
            failures.append(f"a disconnected client's request was not freed: {st}")
        done = [(types.SimpleNamespace(id=f"http-{i}", prompt=p, temperature=kw.get("temperature", 0.0)), r[0])
                for i, ((p, _, kw), r) in enumerate(zip(specs, results))]
        mono["check"] = serve_check(torch, tt, cfg, params, done, device=device)
        marks["disconnect_and_check_s"] = time.perf_counter() - t
        serve.delete("LLMDeployment")
        deadline = time.monotonic() + 120
        while "LLMDeployment" in serve.status() and time.monotonic() < deadline:
            time.sleep(0.1)
        # ---- (b) disaggregated ----
        t = time.perf_counter()
        cw = worker_context.get_core_worker()
        # An engine in this process publishes the shared system prefix to the
        # cluster prefix tier; the prefill replica's first prompts miss its
        # own cache and import those blocks from here.
        pub = LLMEngine(params, cfg, cluster_prefix=True, **engine_config)
        pub.submit(system + specs[0][0][len(system):len(system) + 8], max_new_tokens=1).result(timeout=300)
        shared = block_hashes(system, tr["block_size"])[-1]
        while kv_transfer.lookup_prefix_row(cw, shared) is None and time.perf_counter() - t < 60:
            time.sleep(0.05)
        serve.run(disaggregated_llm_app(model_config, engine_config, name="llm", prefill_replicas=1,
                                        decode_replicas=1, cluster_prefix=True, ray_actor_options=actor_options,
                                        device=device))
        marks["disagg_up_s"] = time.perf_counter() - t
        t = time.perf_counter()
        store = rt._global_node.raylet.store
        used0, wall0 = store.usage()["used"], time.time()
        # The exactness prompts again, one at a time: no other prefill or
        # import overlaps a request's decode.
        seq = [_llm_http(host, port, dict(tokens=prompt, max_new_tokens=sa["exact_new"])) for prompt in exact[:2]]
        disagg_seq = _sequential_gaps([info for _, info in seq])
        print(f"one at a time, {len(seq)} greedy prompts of {sa['exact_new']} tokens: monolithic TTFT "
              f"{mono_seq['ttft_ms_median']:.1f} ms, a token every {mono_seq['gap_ms_median']:.2f} ms; "
              f"disaggregated {disagg_seq['ttft_ms_median']:.1f} ms, every {disagg_seq['gap_ms_median']:.2f} ms; "
              f"tokens equal to the monolithic app's: {[t for t, _ in seq] == sse[:2]}")
        if [t for t, _ in seq] != sse[:2]:
            failures.append("the disaggregated app's tokens differ from the monolithic app's one request at a time")
        n = sa["disagg_requests"]
        dresults, dwall = _http_traffic(host, port, specs[:n], sa["clients"])
        used1 = store.usage()["used"]
        disagg = _http_summary(dresults, dwall)
        disagg["sequential"] = disagg_seq
        dstats, pstats = _replica_stats(rt, serve, "llm"), _replica_stats(rt, serve, "llm--prefill")
        greedy = [i for i in range(n) if not specs[i][2]]
        differ = [i for i in greedy if dresults[i][0] != results[i][0]]
        sampled_equal = sum(dresults[i][0] == results[i][0] for i in range(n) if specs[i][2])
        handoffs = []
        for proc in flight_recorder.collect_dir(rt._global_node.session_dir):
            for ev in proc["events"]:
                if ev["type"] == "llm_kv_handoff" and ev["ts"] >= wall0 - 1.0:
                    oid, blocks, nbytes, ms = ev["detail"].split(":")[:4]
                    handoffs.append((int(blocks.removesuffix("blk")), int(nbytes.removesuffix("B")),
                                     float(ms.removesuffix("ms"))))
        disagg.update(decode_stats=dstats, prefill_stats=pstats, store_bytes=used1 - used0,
                      greedy_equal=len(greedy) - len(differ), greedy=len(greedy), sampled_equal=sampled_equal,
                      handoffs=[{"blocks": b, "bytes": nb, "ms": ms} for b, nb, ms in handoffs])
        print(f"disaggregated app (a prefill and a decode replica, {sa['replica_gpus']} of the card each, "
              f"cluster_prefix): {n} requests from {sa['clients']} SSE clients in {dwall:.2f} s: "
              f"{disagg['output_tokens_per_s']:.1f} output tokens/s; TTFT p50 {disagg['ttft_ms_p50']:.1f} ms, p99 "
              f"{disagg['ttft_ms_p99']:.1f} ms; TPOT {disagg['tpot_ms_mean']:.2f} ms, the second token "
              f"{disagg['second_token_ms_p50']:.1f} ms after the first (p50; the first is the prefill's, echoed; "
              f"{disagg['second_after_last_first']:.0%} of second tokens after every request's first); "
              "greedy tokens equal to the "
              f"monolithic app's {len(greedy) - len(differ)} of {len(greedy)}, sampled {sampled_equal} of "
              f"{n - len(greedy)}; store bytes {used1 - used0:+d}")
        print(f"handoffs: decode imported {dstats['handoffs']} (failed {dstats['handoff_failed']}), prefill exported "
              f"{pstats['handoff_exports']}; prefix imports on the prefill replica: hits "
              f"{pstats['prefix_import_hits']}, misses {pstats['prefix_import_misses']}, errors "
              f"{pstats['prefix_import_errors']}")
        for b, nb, ms in sorted(handoffs, key=lambda h: h[1]):
            print(f"  handoff {b} blocks, {nb} bytes ({nb / 2**20:.2f} MiB) in {ms:.2f} ms "
                  f"({nb / ms / 1e6:.3f} GB/s)")
        for i in differ:
            a, b = results[i][0], dresults[i][0]
            j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            with torch.no_grad():
                seq = torch.tensor([specs[i][0] + a[:j]], device=device)
                row = tt.forward(params, seq, _lossless(cfg))[0][0, -1].float()
            print(f"  greedy request {i}: first differs at token {j} of {len(a)}: forward's logits there, the "
                  f"monolithic token {row[a[j]].item():.4f}, the disaggregated {row[b[j]].item():.4f}, the row's "
                  f"maximum {row.max().item():.4f}")
        sampled_differ = [i for i in range(n) if specs[i][2] and dresults[i][0] != results[i][0]]
        for i in sampled_differ:
            a, b = results[i][0], dresults[i][0]
            print(f"  sampled request {i}: first differs at token "
                  f"{next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))} of {len(a)}")
        disagg["handoff_probe"] = _handoff_probe(torch, LLMEngine, cfg, params, engine_config,
                                                 [specs[i] for i in (greedy[:1] + differ[:2] + sampled_differ[:2])])
        first_differ = [i for i in range(n) if dresults[i][0][:1] != results[i][0][:1]]
        if first_differ:
            failures.append(f"the first token (the prefill replica's) differs from the monolithic app's for "
                            f"requests {first_differ}")
        if not all(x["blocks_equal"] for x in disagg["handoff_probe"]):
            failures.append("a handoff's imported blocks differ from the plain engine's")
        if differ:
            failures.append(f"disaggregated greedy tokens differ from the monolithic app's for requests {differ}")
        sent = n + len(seq)
        if dstats["handoffs"] != sent or dstats["handoff_failed"] or pstats["handoff_exports"] != sent:
            failures.append(f"handoffs {dstats['handoffs']} (failed {dstats['handoff_failed']}), exports "
                            f"{pstats['handoff_exports']}, of {sent} requests")
        if len(handoffs) != sent:
            failures.append(f"{len(handoffs)} llm_kv_handoff events for {sent} requests")
        if pstats["prefix_import_hits"] < 1:
            failures.append("the prefill replica imported no prefix from the cluster tier")
        if used1 != used0:
            failures.append(f"the object store's used bytes moved by {used1 - used0}")
        ddone = [(types.SimpleNamespace(id=f"disagg-{i}", prompt=specs[i][0], temperature=0.0), dresults[i][0])
                 for i in greedy]
        disagg["check"] = serve_check(torch, tt, cfg, params, ddone, device=device)
        marks["disagg_traffic_s"] = time.perf_counter() - t
        # ---- teardown ----
        t = time.perf_counter()
        pids = _serve_pids(rt)
        pub.shutdown()
        serve.shutdown()
        rows = cw.gcs.call("kv_keys", {"prefix": kv_transfer.PREFIX_ROW}, timeout=10).get("keys", [])
        deadline = time.monotonic() + 30
        while any(_alive(p) for p in pids.values()) and time.monotonic() < deadline:
            time.sleep(0.1)
        left = sorted(name for name, p in pids.items() if _alive(p))
        resident = dobj.device_object_stats()["resident_count"]
        print(f"after serve.shutdown(): {len(rows)} llmprefix/ rows, {len(left)} of {len(pids)} Serve processes "
              f"left ({sorted(n.split(':')[0] for n in pids)}), {resident} resident device objects here")
        if rows or left or resident:
            failures.append(f"left after shutdown: rows {rows[:3]}, processes {left}, resident {resident}")
        marks["shutdown_s"] = time.perf_counter() - t
        del params
    finally:
        rt.shutdown()
    res = {"mono": mono, "disagg": disagg, "sections_s": marks, "phase_s": time.perf_counter() - t0}
    print("serve app: " + json.dumps(res))
    if failures:
        raise AssertionError("serve app: " + "; ".join(failures))
    return res


def _vit_apply_fn(log_path: str, vit_kw: dict):
    """The counterpart of flax's ``model.apply`` for the scoring actors: the
    port's ViT forward with ``params`` (its state dict, on the actor's card)
    as the weights, through ``torch.func.functional_call`` on a weightless
    ("meta") ViT built once per process. Each call appends the process's
    kernel launch counts and the batch's ms (host clock to a synchronize) to
    ``log_path``, one JSON line."""
    skeleton: dict = {}

    def apply(params, images):
        import torch
        from torch.func import functional_call

        from ray_tpu_torch.models import vit
        from ray_tpu_torch.ops import attention

        if "vit" not in skeleton:
            skeleton["vit"] = vit.ViT(**vit_kw, device="meta").eval()
        t0 = time.perf_counter()
        out = functional_call(skeleton["vit"], params, (images,))
        if images.device.type == "cuda":
            torch.cuda.synchronize(images.device)
        with open(log_path, "a") as f:
            f.write(json.dumps({"pid": os.getpid(), "launches": attention.launch_counts(), "device": str(images.device),
                                "ms": (time.perf_counter() - t0) * 1e3}) + "\n")
        return out

    return apply


def _normalize(batch):
    """uint8 images to float32 in [-2, 2): the phase's host preprocessing."""
    return {"image": (batch["image"].astype(np.float32) / 255.0 - 0.5) / 0.25}


def data_phase(torch, card, trainer_raw_ms=None, zoo_rate=None, device="cuda", model=None, vit_kw=None, sizes=None):
    """Data on the card (phase 14): (a) a dataset feeds TorchTrainer and the
    flagship step; (b) BatchPredictor scores ViT-B/16 in a GPU actor pool.
    Returns the launches of each path: {"ingest": the worker's counts,
    "predict": the scoring actor's}."""
    _phase("data")
    import ray_tpu_torch as rt
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.air.checkpoint import checkpoint_from_tensors
    from ray_tpu_torch.air.config import RunConfig, ScalingConfig
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.models import vit as tvit
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.train import BatchPredictor, TorchPredictor
    from ray_tpu_torch.train.flagship_loop import dataset_loop
    from ray_tpu_torch.train.torch import TorchTrainer

    cuda = device == "cuda"
    model = model or dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=8, n_kv_heads=8, d_ff=2816,
                          max_seq_len=1024, remat=False, fused_loss=False, scan_unroll=8)
    vit_kw = vit_kw if vit_kw is not None else {}
    z = dict(DATA, **(sizes or {}))
    rows, seq, batch, L = z["rows"], z["seq"], z["batch"], model["n_layers"]
    steps = rows // batch
    failures, marks = [], {}
    t0 = time.perf_counter()
    scratch = tempfile.mkdtemp(prefix="chip_smoke_data_")
    rt.init(num_cpus=4, num_gpus=1, object_store_memory=1 << 30)
    store = rt._global_node.raylet.store
    pids = set()
    try:
        marks["init_s"] = time.perf_counter() - t0
        # ---- (a) ingest: the dataset feeds TorchTrainer's flagship step ----
        t = time.perf_counter()
        tokens = np.random.default_rng(1).integers(0, model["vocab_size"], (rows, seq + 1), dtype=np.int32)
        ds = (rd.from_numpy(np.split(tokens, z["blocks"]))
              .map_batches(lambda b: {"inputs": b["data"][:, :-1], "targets": b["data"][:, 1:]})
              .random_shuffle(seed=0))
        A.reset_launch_counts()
        result = TorchTrainer(
            dataset_loop, train_loop_config={"model": model, "dtype": "bfloat16", "batch": batch, "param_seed": 0},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=cuda), datasets={"train": ds},
            run_config=RunConfig(storage_path=os.path.join(scratch, "runs")),
        ).fit()
        m, driver_counts = result.metrics, A.launch_counts()
        pids |= {w.pid for w in rt._global_node.raylet.workers.values() if w.pid} | {m["pid"]}
        marks["ingest_fit_s"] = time.perf_counter() - t
        # The driver's in-process step on the same first batch, as the trainer's.
        first = ds.take_batch(batch)
        cfg = tt.TransformerConfig(**model, dtype=torch.bfloat16)
        params = tt.init_params(cfg, seed=0, device=device)
        step = tt.make_train_step(cfg, tt.adamw(params), device=device)
        first_tokens = torch.from_numpy(np.concatenate([first["inputs"], first["targets"][:, -1:]], 1)).to(device)
        in_process = step(params, {"tokens": first_tokens}).item()
        del params, step, first_tokens
        rel = abs(m["first_loss"] - in_process) / abs(in_process)
        med = sorted(m["step_ms"][1:])[len(m["step_ms"][1:]) // 2] if steps > 1 else float("nan")
        wait = sum(m["wait_ms"][1:]) / max(1, len(m["wait_ms"]) - 1)
        distinct = len({tuple(k) for k in m["row_keys"]})
        want = {n: steps * L for n in KERNELS} if cuda else {n: 0 for n in KERNELS}
        devices_ok = m["batch_devices"] == ([f"cuda:{torch.cuda.current_device()}"] if cuda else ["cpu"])
        print(f"ingest: {rows} rows of {seq + 1} tokens, {z['blocks']} blocks -> map_batches -> random_shuffle(seed=0) "
              f"-> TorchTrainer(datasets=...) -> iter_torch_batches(batch_size={batch}, drop_last=True): "
              f"{m['steps']} steps in worker pid {m['pid']} on {m['device_name']}; batches on {m['batch_devices']}; "
              f"{distinct} distinct rows of {len(m['row_keys'])}")
        print(f"ingest: worker launches {m['launches']} (expected {want}); driver launches meanwhile {driver_counts}")
        print(f"ingest: first loss {m['first_loss']:.6f}, the driver's in-process step on take_batch({batch}) "
              f"{in_process:.6f} (relative difference {rel:.2e}, bar {TRAINER_LOSS_RTOL}); losses "
              f"{[round(x, 4) for x in m['losses']]}")
        print(f"ingest on {card}: step {med:.2f} ms median of the {steps - 1} after the first (CUDA events), "
              f"{m['tokens_per_sec'] or float('nan'):.0f} tokens/s (host clock, to a synchronize), waiting in next() "
              f"{wait:.3f} ms per step (first {m['wait_ms'][0]:.1f} ms); the trainer phase's raw step "
              + (f"{trainer_raw_ms:.2f} ms" if trainer_raw_ms else "not measured in this run"))
        if not devices_ok:
            failures.append(f"ingest batches arrived on {m['batch_devices']}, not the worker's card")
        if m["launches"] != want or any(driver_counts.values()):
            failures.append(f"ingest: the worker launched {m['launches']} (driver {driver_counts}), not {L} per step")
        if not rel <= TRAINER_LOSS_RTOL:
            failures.append(f"ingest first loss {m['first_loss']} is not the in-process {in_process}")
        if distinct != rows or m["steps"] != steps:
            failures.append(f"ingest consumed {distinct} distinct rows in {m['steps']} steps, not {rows} in {steps}")
        if m["pid"] == os.getpid() or not all(math.isfinite(x) for x in m["losses"]):
            failures.append(f"ingest: loop pid {m['pid']}, losses {m['losses']}")
        ingest = {"steps": m["steps"], "step_ms_median": med, "tokens_per_sec": m["tokens_per_sec"],
                  "wait_ms_per_step": wait, "first_wait_ms": m["wait_ms"][0], "first_loss": m["first_loss"],
                  "in_process_first_loss": in_process, "launches": m["launches"], "distinct_rows": distinct,
                  "trainer_raw_step_ms": trainer_raw_ms}
        del ds, result
        marks["ingest_s"] = time.perf_counter() - t

        # ---- (b) batch inference: BatchPredictor scores ViT in a GPU actor pool ----
        t = time.perf_counter()
        gc.collect()
        used0 = store.usage()["used"]
        log_path = os.path.join(scratch, "vit_apply.jsonl")
        torch.manual_seed(0)
        vit = tvit.ViT(**vit_kw, device=device).eval()
        ckpt = checkpoint_from_tensors(vit.state_dict(), apply_fn=_vit_apply_fn(log_path, vit_kw))
        S, n_img, pb = vit.image_size, z["images"], z["predict_batch"]
        images = np.random.default_rng(z["seed"]).integers(0, 256, (n_img, S, S, 3), dtype=np.uint8)
        ds = rd.from_numpy(np.split(images, z["image_blocks"]), column="image").map_batches(_normalize)
        t_pred = time.perf_counter()
        scored = BatchPredictor.from_checkpoint(ckpt, TorchPredictor, input_column="image", device=device).predict(
            ds, batch_size=pb, max_scoring_workers=1, num_gpus_per_worker=1 if cuda else 0)
        logits = np.concatenate([b["predictions"] for b in scored.iter_batches(batch_size=None)])
        pred_s = time.perf_counter() - t_pred
        with open(log_path) as f:
            calls = [json.loads(line) for line in f]
        with torch.no_grad():
            ref = torch.cat([vit(torch.from_numpy(_normalize({"image": images[i:i + pb]})["image"]).to(device))
                             for i in range(0, n_img, pb)])
        mm = A.mismatch(torch.from_numpy(logits), ref.float().cpu())
        classes = vit.head.out_features
        del scored, ds, ckpt, vit, ref
        gc.collect()
        deadline = time.monotonic() + 30
        while store.usage()["used"] > used0 and time.monotonic() < deadline:
            time.sleep(0.1)
        used1 = store.usage()["used"]
        batches = n_img // pb
        vit_layers = vit_kw.get("num_layers", 12)
        want = {"flash_fwd": batches * vit_layers, "flash_bwd_dkv": 0, "flash_bwd_dq": 0} if cuda else \
            {n: 0 for n in KERNELS}
        got = calls[-1]["launches"] if calls else {}
        steady = sorted(c["ms"] for c in calls[1:]) or [float("nan")]
        steady_ms = steady[len(steady) // 2]
        print(f"predict: {n_img} uint8 images {S}^2 ({images.nbytes / 1e6:.1f} MB) in {z['image_blocks']} blocks -> "
              f"map_batches(normalize) -> BatchPredictor(TorchPredictor, ViT, batch_size={pb}, 1 actor at "
              f"{1 if cuda else 0} GPU): logits {logits.shape} in actor pid {calls[-1]['pid'] if calls else None} on "
              f"{calls[-1]['device'] if calls else None}; against the in-process ViT on the same images: "
              + " ".join(f"{k}={v:.2e}" for k, v in mm.items()) + f" (bar rel_l2 {VIT_LOGIT_RTOL})")
        print(f"predict: actor launches {got} over {len(calls)} batches (expected {want}); object store used "
              f"{used0} B before, {used1} B after the predictions were released")
        print(f"predict on {card}: {n_img / pred_s:.1f} images/s end to end ({pred_s:.2f} s: the actor's start, the "
              f"checkpoint's transfer, normalisation and scoring); in the actor {pb / steady_ms * 1e3:.1f} images/s "
              f"({steady_ms:.2f} ms a batch of {pb}, median after the first; first {calls[0]['ms'] if calls else 0:.1f}"
              f" ms); the zoo phase's in-process ViT-B/16 " + (f"{zoo_rate:.1f} images/s" if zoo_rate else
                                                              "not measured in this run"))
        if logits.shape != (n_img, classes) or not np.isfinite(logits).all():
            failures.append(f"predict: logits {logits.shape}, finite: {bool(np.isfinite(logits).all())}")
        if not mm["rel_l2"] <= VIT_LOGIT_RTOL:
            failures.append(f"predict: logits off the in-process ViT's: {mm}")
        if got != want or len(calls) != batches or any(c["pid"] == os.getpid() for c in calls):
            failures.append(f"predict: the actor launched {got} over {len(calls)} batches, expected {want}")
        if used1 > used0:
            failures.append(f"predict: the object store holds {used1 - used0} B more after the predictions were released")
        predict = {"images_per_s_end_to_end": n_img / pred_s, "actor_images_per_s": pb / steady_ms * 1e3,
                   "actor_batch_ms": steady_ms, "first_batch_ms": calls[0]["ms"] if calls else None,
                   "logits_vs_in_process": mm, "launches": got, "store_used_before": used0, "store_used_after": used1,
                   "zoo_images_per_s": zoo_rate}
        marks["predict_s"] = time.perf_counter() - t
    finally:
        rt.shutdown()
        shutil.rmtree(scratch, ignore_errors=True)
    deadline = time.monotonic() + 30
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = sorted(p for p in pids if _alive(p))
    print(f"data: worker pids {sorted(pids)}, {len(left)} left after shutdown()")
    if left:
        failures.append(f"worker processes {left} outlived shutdown()")
    marks["phase_s"] = time.perf_counter() - t0
    print("data: " + json.dumps({"ingest": ingest, "predict": predict, "sections_s": marks}))
    if failures:
        raise AssertionError("data: " + "; ".join(failures))
    return {"ingest": m["launches"], "predict": got}


def _dt_expert_data(path: str, episodes: int) -> int:
    """tests/test_rllib_algorithms.py's scripted-expert CartPole data (a PD
    controller, ~200 reward an episode) through the port's env and
    JsonWriter; returns the row count."""
    from ray_tpu_torch.rllib.env import make
    from ray_tpu_torch.rllib.offline import JsonWriter
    from ray_tpu_torch.rllib.policy.sample_batch import ACTIONS, DONES, NEXT_OBS, OBS, REWARDS, SampleBatch

    env = make("CartPole-v1")
    rows = {k: [] for k in (OBS, ACTIONS, REWARDS, DONES, NEXT_OBS)}
    for ep in range(episodes):
        obs, _ = env.reset(seed=ep)
        for _ in range(200):
            a = 1 if (obs[2] + 0.5 * obs[3]) > 0 else 0
            nobs, r, term, trunc, _ = env.step(a)
            rows[OBS].append(np.asarray(obs, np.float32))
            rows[ACTIONS].append(np.int64(a))
            rows[REWARDS].append(np.float32(r))
            rows[DONES].append(np.float32(term or trunc))
            obs = nobs
            rows[NEXT_OBS].append(np.asarray(obs, np.float32))
            if term or trunc:
                break
        rows[DONES][-1] = np.float32(1.0)  # close the final episode
    writer = JsonWriter(path)
    writer.write(SampleBatch({k: np.asarray(v) for k, v in rows.items()}))
    writer.close()
    return len(rows[OBS])


def _close_metrics(got: dict, want: dict, keys, rtol) -> dict:
    """Relative differences of the named metrics, and whether each is within rtol."""
    rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in keys}
    return {k: (r, r <= rtol) for k, r in rel.items()}


def _sink_class(rt):
    @rt.remote(num_cpus=0.5)
    class WeightSink:
        """A weight-group member pinned to the host, as a rollout worker is:
        takes a broadcast packed vector or a shipped params tree."""

        def __init__(self):
            from ray_tpu_torch._private.serialization import pin_to_host

            pin_to_host()

        def join(self, world, rank, group):
            from ray_tpu_torch.util import collective as col

            col.init_collective_group(world, rank, backend="cpu", group_name=group)
            return True

        def take(self, refs):
            import hashlib

            flat = rt.get(refs[0])
            return {"device": str(flat.device), "nbytes": flat.numel() * flat.element_size(),
                    "sha": hashlib.sha256(flat.numpy().tobytes()).hexdigest()}

        def take_tree(self, tree):
            from ray_tpu_torch.rllib.core.rl_module import tree_leaves

            return sum(x.nbytes for x in tree_leaves(tree))

        def coll(self):
            from ray_tpu_torch.util.collective.p2p import COLL

            return COLL.snapshot()

    return WeightSink


def _build_together(configs: dict) -> dict:
    """``{name: config.build()}``, the builds on threads. A build waits for
    its worker processes to start, which is what takes the time on the
    card's machine (a node with a GPU starts workers by Popen, not the
    zygote): on threads the waits overlap. If one build fails, the others
    are cleaned up and its error raised."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(configs)) as pool:
        futures = {name: pool.submit(config.build) for name, config in configs.items()}
        built, error = {}, None
        for name, fut in futures.items():
            try:
                built[name] = fut.result()
            except Exception as e:  # noqa: BLE001 - the others are cleaned up, then it is raised
                error = error or e
    if error is not None:
        for algo in built.values():
            algo.cleanup()
        raise error
    return built


def _finite(metrics: dict, key: str = "total_loss") -> bool:
    return key in metrics and bool(np.isfinite(metrics[key]))


def rllib_families(torch, rt, card, device, failures) -> dict:
    """Sections (d)-(g) of the rllib phase, in its cluster: the Podracer
    weight sync, the value-based and the policy-gradient families. Returns
    their numbers; appends to ``failures``."""
    from ray_tpu_torch.experimental import device_object as dobj
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.rllib import (
        A2CConfig, A3CConfig, ApexDQNConfig, DDPPOConfig, DQNConfig, IMPALAConfig, PGConfig, R2D2Config,
        SimpleQConfig,
    )
    from ray_tpu_torch.rllib.algorithms.dqn.dqn import dqn_loss, td_errors, td_targets
    from ray_tpu_torch.rllib.core.learner import Learner, pack_weights, to_device, weights_checksum
    from ray_tpu_torch.rllib.core.rl_module import RLModule, RLModuleSpec, tree_leaves
    from ray_tpu_torch.rllib.env import Box, Discrete
    from ray_tpu_torch.rllib.policy.sample_batch import ACTIONS, DONES, NEXT_OBS, OBS, REWARDS, SampleBatch
    from ray_tpu_torch.rllib.utils.replay_buffers import PrioritizedReplayBuffer
    from ray_tpu_torch.util import collective as col

    f = RLLIB_FAMILIES
    cuda = device == "cuda"
    res, marks = {}, {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # ---- (d) Podracer: IMPALA with the device broadcast from a learner actor on the card ----
    t_sec = time.perf_counter()
    # The Atari broadcast's members start while IMPALA builds.
    sinks = [_sink_class(rt).remote() for _ in range(f["atari_members"])]
    cfg = (IMPALAConfig().environment("CartPole-v1").rollouts(num_rollout_workers=2, rollout_fragment_length=50)
           .training(lr=5e-4, train_batch_size=500, weight_sync="device_broadcast")
           .resources(num_learners=1, num_gpus_per_learner=1, device=device).debugging(seed=0))
    algo = cfg.build()
    try:
        info = algo.learner_group.device_info()[0]
        group = algo._weight_group
        want_dev = f"cuda:{torch.cuda.current_device()}" if cuda else "cpu"
        if not algo._device_sync_ready or info["device"] != want_dev:
            failures.append(f"podracer: sync ready {algo._device_sync_ready}, the holder on {info['device']}")

        def check(label, n_iters, first_skip=False):
            """``n_iters`` iterations; the holder's bcast_sends rise by one or
            more an iteration, every sampler's bcast_recvs rise, fallbacks
            stay flat (after the first iteration when ``first_skip``), the
            samplers hold the learner's weights bit for bit."""
            losses = []
            if first_skip:
                losses.append(algo.step()["total_loss"])
                n_iters -= 1
            h0, s0 = algo.learner_group.holder_coll_stats(), algo.workers.coll_stats()
            for _ in range(n_iters):
                losses.append(algo.step()["total_loss"])
            h1, s1 = algo.learner_group.holder_coll_stats(), algo.workers.coll_stats()
            sends = h1["bcast_sends"] - h0["bcast_sends"]
            recvs = [b["bcast_recvs"] - a["bcast_recvs"] for a, b in zip(s0, s1)]
            fallbacks = [b["host_sync_fallbacks"] - a["host_sync_fallbacks"] for a, b in zip(s0, s1)]
            want = weights_checksum(algo.learner_group.get_weights())
            equal = [x == want for x in algo.workers.weights_checksums()]
            roster = algo.learner_group.weight_group_roster(group)
            live = [0] + algo.workers._group_ranks
            print(f"podracer {label}: {len(losses)} iterations, total_loss {[round(x, 4) for x in losses]}; holder "
                  f"bcast_sends +{sends}, samplers' bcast_recvs +{recvs}, host_sync_fallbacks +{fallbacks} (over the "
                  f"last {n_iters}); samplers bit-equal to the learner: {equal}; roster ranks {roster['ranks']} "
                  f"(epoch {roster['epoch']}), live {live}")
            if sends < n_iters or any(r < n_iters for r in recvs) or any(fallbacks):
                failures.append(f"podracer {label}: sends +{sends}, recvs +{recvs}, fallbacks +{fallbacks}")
            if not all(equal) or roster["ranks"] != live or not all(np.isfinite(losses)):
                failures.append(f"podracer {label}: bit-equal {equal}, roster {roster['ranks']} vs {live}, "
                                f"losses {losses}")
            return {"iterations": len(losses), "bcast_sends": sends, "bcast_recvs": recvs,
                    "host_sync_fallbacks": fallbacks, "bit_equal": all(equal), "roster": roster["ranks"]}

        res["podracer"] = {"holder": info, "start": check("2 samplers", f["podracer_iters"])}
        # One sync on each transport, on this algorithm (host clock; each ends
        # when every sampler holds the weights).
        dev_ms, host_ms = [], []
        for _ in range(f["sync_reps"]):
            t = time.perf_counter()
            algo.sync_worker_weights()
            dev_ms.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            algo.workers.sync_weights(algo.learner_group.get_weights())
            host_ms.append((time.perf_counter() - t) * 1e3)
        nbytes = sum(x.nbytes for x in tree_leaves(algo.learner_group.get_weights()))
        print(f"podracer sync on {card}: device broadcast {np.median(dev_ms):.2f} ms median (of {f['sync_reps']}), "
              f"host path {np.median(host_ms):.2f} ms, {nbytes} bytes of weights to 2 samplers")
        res["podracer"].update(sync_ms_device=float(np.median(dev_ms)), sync_ms_host=float(np.median(host_ms)),
                               weight_bytes=nbytes)
        t = time.perf_counter()
        algo.resize_workers(f["podracer_grow"])
        grow_s = time.perf_counter() - t
        res["podracer"]["grown"] = check(f"grown to {f['podracer_grow']}", 2, first_skip=True)
        algo.resize_workers(2)
        res["podracer"]["shrunk"] = check("shrunk to 2", 2, first_skip=True)
        res["podracer"]["grow_s"] = grow_s
    finally:
        algo.cleanup()

    # The Atari module's packed weights through a weight group of host-pinned
    # members, beside host ships of its params tree.
    world = 1 + len(sinks)
    rt.get([s.join.remote(world, i + 1, "atari_weights") for i, s in enumerate(sinks)], timeout=120)
    col.init_collective_group(world, 0, backend="cpu", group_name="atari_weights")
    try:
        spec = RLModuleSpec.from_spaces(Box(0.0, 1.0, (84, 84, 4)), Discrete(6))
        module = RLModule(spec, seed=0, device=device)
        bcast_ms, ship_ms, sent = [], [], None
        for _ in range(f["atari_reps"]):
            sync()
            t = time.perf_counter()
            ref = rt.put(pack_weights(module), tensor_transport="collective")
            sent = dobj.broadcast(ref, "atari_weights", timeout=120)
            got = rt.get([s.take.remote([ref]) for s in sinks], timeout=120)
            bcast_ms.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            tree = module.get_params()
            shipped = rt.get([s.take_tree.remote(tree) for s in sinks], timeout=120)
            ship_ms.append((time.perf_counter() - t) * 1e3)
            del ref
        want = weights_checksum(module)
        stats = rt.get([s.coll.remote() for s in sinks], timeout=60)
        print(f"podracer, the Atari module ({sum(p.numel() for p in module.parameters())} params, "
              f"{sent['bytes']} bytes on the wire) to {len(sinks)} members on {card}: pack + broadcast + resolve "
              f"{np.median(bcast_ms):.2f} ms median (of {f['atari_reps']}), {len(sinks)} host ships of its tree "
              f"{np.median(ship_ms):.2f} ms ({shipped[0]} bytes each); members on {[g['device'] for g in got]}, "
              f"bit-equal {[g['sha'] == want for g in got]}, ok ranks {sent['ok_ranks']}, host_sync_fallbacks "
              f"{[x['host_sync_fallbacks'] for x in stats]}")
        if (any(g["sha"] != want or g["device"] != "cpu" for g in got) or sent["ok_ranks"] != [1, 2, 3, 4]
                or any(x["host_sync_fallbacks"] for x in stats)):
            failures.append(f"podracer atari: {got} {sent} {stats}")
        res["podracer"]["atari"] = {"bytes": sent["bytes"], "broadcast_ms": float(np.median(bcast_ms)),
                                    "host_ships_ms": float(np.median(ship_ms)), "members": len(sinks)}
    finally:
        col.destroy_collective_group("atari_weights")
        for s in sinks:
            rt.kill(s)
    marks["podracer_s"] = time.perf_counter() - t_sec

    # ---- (e) DQN: on CartPole, one Atari-shaped update against the CPU, SimpleQ ----
    t_sec = time.perf_counter()
    algo = DQNConfig().environment("CartPole-v1").resources(device=device).debugging(seed=0).build()
    try:
        upd_s = []
        real = algo._train_once

        def timed_update():
            t = time.perf_counter()
            m = real()  # reads its metrics back: the update has finished
            upd_s.append(time.perf_counter() - t)
            return m

        algo._train_once = timed_update
        iters = []
        for _ in range(f["dqn_iters"]):
            t = time.perf_counter()
            m = algo.step()
            iters.append((time.perf_counter() - t, m))
        c = algo._algo_config
        steps = c.rollout_steps_per_iter
        # One env: an update at every train_intensity-th step from learning_starts on.
        want = sum(1 for ts in range(1, f["dqn_iters"] * steps + 1)
                   if ts >= c.learning_starts and ts % c.train_intensity == 0)
        act_s = iters[0][0]  # iteration 1 acts (learning_starts = its last step)
        print(f"dqn on {card}: {f['dqn_iters']} iterations of {steps} env steps; iteration 1 (one Q forward on the "
              f"card a step, 1 update) {steps / act_s:.0f} env steps/s; {len(upd_s)} updates of batch "
              f"{c.train_batch_size} in all, {np.median(upd_s) * 1e3:.2f} ms median an update (3 Q forwards, the "
              f"update, the priorities read back); iteration 2 {iters[1][0]:.2f} s; total_loss "
              f"{iters[1][1].get('total_loss')}")
        if len(upd_s) != want or not _finite(iters[1][1]):
            failures.append(f"dqn: {len(upd_s)} updates, metrics {iters[1][1]}")
        res["dqn"] = {"env_steps_per_s": steps / act_s, "update_ms": float(np.median(upd_s)) * 1e3,
                      "updates": len(upd_s), "iteration_s": [x for x, _ in iters]}
    finally:
        algo.cleanup()

    # One double-Q prioritized update at the Atari module's shape, on the card
    # and on the CPU from the same weights, TF32 switched on around it.
    spec = RLModuleSpec.from_spaces(Box(0.0, 1.0, (84, 84, 4)), Discrete(6))
    rng = np.random.default_rng(11)
    n = f["atari_dqn_rows"]
    buf = PrioritizedReplayBuffer(n, seed=0)
    buf.add(SampleBatch({OBS: rng.random((n, 84, 84, 4), dtype=np.float32), ACTIONS: rng.integers(0, 6, n),
                         REWARDS: rng.normal(size=n).astype(np.float32),
                         DONES: (rng.random(n) < 0.1).astype(np.float32),
                         NEXT_OBS: rng.random((n, 84, 84, 4), dtype=np.float32)}))
    buf.update_priorities_at(np.arange(n), rng.random(n))
    batch = buf.sample(32)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        def flat(grads, params):  # DQN's loss reaches no value head: zeros there, as the learner gives
            return torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1) for g, p in zip(grads, params)])

        pair = []
        for dev in (device, "cpu"):
            learner = Learner(spec, dqn_loss, lr=5e-4, seed=0, device=dev)
            target = RLModule(spec, seed=1, device=dev).requires_grad_(False)
            td = td_targets(learner.module, target, batch, 0.99, True)
            tb = {OBS: batch[OBS], ACTIONS: batch[ACTIONS], "td_target": td, "weights": batch["weights"]}
            _, _, grads = learner.compute_grads(tb, {})
            pair.append((learner, target, td, tb, flat(grads, learner.opt.params).cpu()))
        (card_l, card_t, card_td, card_tb, g_card), (cpu_l, _, cpu_td, cpu_tb, g_cpu) = pair
        # The control: the same gradients with TF32 allowed, not through the
        # learner's flag.
        loss_t, _ = dqn_loss(card_l.module, to_device(card_tb, card_l.device), spec, {})
        g_tf32 = flat(torch.autograd.grad(loss_t, card_l.opt.params, allow_unused=True), card_l.opt.params).cpu()
        td_gap = A.mismatch(card_td.cpu(), cpu_td)
        grad_gap, tf32_gap = A.mismatch(g_card, g_cpu), A.mismatch(g_tf32, g_cpu)
        got, want = card_l.update(card_tb, {}), cpu_l.update(cpu_tb, {})
        close = _close_metrics(got, want, ("total_loss", "grad_norm", "td_error_abs", "q_mean"), RLLIB_ATARI_RTOL)
        prio_gap = A.mismatch(torch.from_numpy(td_errors(card_l.module, batch, card_td)),
                              torch.from_numpy(td_errors(cpu_l.module, batch, cpu_td)))
        sync()
        t = time.perf_counter()
        for _ in range(f["atari_dqn_timed"]):
            b = buf.sample(32)
            td = td_targets(card_l.module, card_t, b, 0.99, True)
            card_l.update({OBS: b[OBS], ACTIONS: b[ACTIONS], "td_target": td, "weights": b["weights"]}, {})
            buf.update_priorities(td_errors(card_l.module, b, td))
        upd_ms = (time.perf_counter() - t) / f["atari_dqn_timed"] * 1e3
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    print(f"dqn atari update (84x84x4, 6 actions, batch 32, double-Q, prioritized) on {device} against the CPU "
          f"(bar rtol {RLLIB_ATARI_RTOL}): " + ", ".join(f"{k} {got[k]:.6g} vs {want[k]:.6g} (rel {r:.1e})"
                                                         for k, (r, _) in close.items())
          + f"; td targets rel_l2 {td_gap['rel_l2']:.1e}; gradients rel_l2 {grad_gap['rel_l2']:.1e} (bar "
          f"{RLLIB_ATARI_GRAD_RTOL}); new priorities rel_l2 {prio_gap['rel_l2']:.1e}; the TF32 control's gradients "
          f"rel_l2 {tf32_gap['rel_l2']:.1e}; {upd_ms:.2f} ms an update on {card} (replay sample, targets, update, "
          f"priorities; {f['atari_dqn_timed']} updates)")
    if not all(ok for _, ok in close.values()) or not grad_gap["rel_l2"] <= RLLIB_ATARI_GRAD_RTOL:
        failures.append(f"dqn atari: the update on {device} parts from the CPU's: {close} {grad_gap}")
    if not td_gap["rel_l2"] <= RLLIB_ATARI_GRAD_RTOL or not prio_gap["rel_l2"] <= RLLIB_ATARI_GRAD_RTOL:
        failures.append(f"dqn atari: targets {td_gap} or priorities {prio_gap} part from the CPU's")
    if cuda and not tf32_gap["rel_l2"] > RLLIB_ATARI_GRAD_RTOL:
        failures.append(f"dqn atari: the TF32 control is within the bar ({tf32_gap['rel_l2']:.2e})")
    res["dqn"]["atari"] = {"update_ms": upd_ms, "rel": {k: r for k, (r, _) in close.items()}, "grad": grad_gap,
                           "td_targets": td_gap, "priorities": prio_gap, "tf32_control_grad": tf32_gap}
    del pair, card_l, cpu_l, card_t, buf, batch
    gc.collect()

    t = time.perf_counter()
    algo = (SimpleQConfig().environment("CartPole-v1").rollouts(num_envs_per_worker=4)
            .training(lr=1e-3, train_batch_size=64, learning_starts=500, epsilon_timesteps=4000,
                      rollout_steps_per_iter=500, model_hiddens=(64, 64))
            .resources(device=device).debugging(seed=0).build())
    try:
        m = algo.step()
    finally:
        algo.cleanup()
    secs = time.perf_counter() - t
    print(f"simple_q on {card}: 1 iteration in {secs:.2f} s (build included), {algo._updates} updates, "
          f"total_loss {m.get('total_loss')}, {algo._timesteps_total} env steps")
    if not _finite(m) or not algo._updates:
        failures.append(f"simple_q: {algo._updates} updates, metrics {m}")
    res["simple_q"] = {"iteration_s": secs, "updates": algo._updates, "total_loss": m.get("total_loss")}
    marks["dqn_s"] = time.perf_counter() - t_sec

    # ---- (f) R2D2: one iteration on the card, its first update against the CPU ----
    t_sec = time.perf_counter()
    r2_cfg = R2D2Config().environment("CartPole-v1").debugging(seed=0)
    algo = r2_cfg.resources(device=device).build()
    ref_cpu = R2D2Config().environment("CartPole-v1").debugging(seed=0).resources(device="cpu").build()
    try:
        first, upd_s, first_grads = {}, [], []
        real = algo.update

        def checked_update(batch):
            if not first:
                ref_cpu.set_weights(algo.get_weights())
                ref_cpu.target_params = {k: {n: v.detach().cpu() for n, v in layer.items()}
                                         for k, layer in algo.target_params.items()}
                loss_c, aux_c, grads_c = algo.loss_and_grads(batch)
                loss_h, aux_h, grads_h = ref_cpu.loss_and_grads(batch)
                first.update(loss=(loss_c.item(), loss_h.item()), td_abs=(aux_c["td_abs"].item(),
                                                                          aux_h["td_abs"].item()))
                first_grads.append(A.mismatch(torch.cat([g.reshape(-1) for g in grads_c]).cpu(),
                                              torch.cat([g.reshape(-1) for g in grads_h])))
            t = time.perf_counter()
            m = real(batch)
            upd_s.append(time.perf_counter() - t)
            return m

        algo.update = checked_update
        t = time.perf_counter()
        m = algo.step()
        it_s = time.perf_counter() - t
    finally:
        algo.cleanup()
        ref_cpu.cleanup()
    rel = {k: abs(a - b) / max(abs(b), 1e-12) for k, (a, b) in first.items()}
    print(f"r2d2 on {card} (hidden {r2_cfg.hidden_size}, burn-in {r2_cfg.burn_in}, sequence {r2_cfg.seq_len}, "
          f"{r2_cfg.train_batch_size} sequences an update): 1 iteration in {it_s:.2f} s, {len(upd_s)} updates, "
          f"{np.median(upd_s) * 1e3:.2f} ms median an update; first update against the CPU: loss "
          f"{first['loss'][0]:.6g} vs {first['loss'][1]:.6g} (rel {rel['loss']:.1e}), td_abs rel {rel['td_abs']:.1e} "
          f"(bar {RLLIB_ATARI_RTOL}), gradients rel_l2 {first_grads[0]['rel_l2']:.1e} (bar {RLLIB_ATARI_GRAD_RTOL}); "
          f"total_loss {m.get('total_loss')}")
    if (not upd_s or not _finite(m) or max(rel.values()) > RLLIB_ATARI_RTOL
            or not first_grads[0]["rel_l2"] <= RLLIB_ATARI_GRAD_RTOL):
        failures.append(f"r2d2: {len(upd_s)} updates, metrics {m}, first update {first}")
    res["r2d2"] = {"iteration_s": it_s, "updates": len(upd_s), "update_ms": float(np.median(upd_s)) * 1e3,
                   "first_update_rel": rel, "first_update_grad": first_grads[0]}
    marks["r2d2_s"] = time.perf_counter() - t_sec

    # ---- (g) Ape-X DQN (2 explorers, 2 shards); PG, A2C and A3C (the learner or the apply
    # step on the card); DD-PPO (2 CPU workers): built together, then an iteration each ----
    t_sec = time.perf_counter()
    configs = {"apex_dqn": ApexDQNConfig().training(num_replay_shards=2, learning_starts=f["apex_learning_starts"]),
               "pg": PGConfig().rollouts(num_rollout_workers=1), "a2c": A2CConfig().rollouts(num_rollout_workers=1),
               "a3c": A3CConfig().rollouts(num_rollout_workers=2), "ddppo": DDPPOConfig().rollouts(num_rollout_workers=2)}
    algos = _build_together({k: c.environment("CartPole-v1").resources(device=device).debugging(seed=0)
                             for k, c in configs.items()})
    build_s = time.perf_counter() - t_sec
    print(f"apex_dqn, pg, a2c, a3c and ddppo built together in {build_s:.2f} s (8 worker actors, 2 shards)")
    for label, algo in algos.items():
        try:
            t = time.perf_counter()
            m = algo.step()
            secs = time.perf_counter() - t
            extra = ""
            ok = _finite(m)
            if label == "apex_dqn":
                extra = f"; {algo._updates} updates, the learner on {algo.learner.device}"
                ok = ok and algo._updates > 0 and algo.learner.device.type == torch.device(device).type
            elif label == "ddppo":
                digests = rt.get([w.weights_digest.remote() for w in algo.workers], timeout=60)
                sums = [weights_checksum(w) for w in rt.get([w.get_weights.remote() for w in algo.workers])]
                extra = f"; workers' digests {digests}, weights bit-equal {len(set(sums)) == 1}"
                ok = ok and len(set(digests)) == 1 and len(set(sums)) == 1
            else:
                on = algo.learner.device if label == "a3c" else algo.learner_group.local_learner.device
                extra = f"; the {'apply step' if label == 'a3c' else 'learner'} on {on}"
                ok = ok and on.type == torch.device(device).type
        finally:
            algo.cleanup()
        print(f"{label} on {card}: 1 iteration in {secs:.2f} s, {m.get('timesteps_total')} env steps, total_loss "
              f"{m.get('total_loss')}{extra}")
        if not ok:
            failures.append(f"{label}: metrics {m}{extra}")
        res[label] = {"iteration_s": secs, "total_loss": m.get("total_loss")}
    res["built_together_s"] = build_s
    marks["pg_s"] = time.perf_counter() - t_sec
    res["sections_s"] = marks
    return res


def _spread_env_class():
    """tests/test_rllib_r2d2_maddpg.py's Spread1D on the port's MultiAgentEnv
    and Box: two agents on a line must cover goals at -0.5/+0.5 without
    colliding; the shared min-assignment reward makes it cooperative."""
    from ray_tpu_torch.rllib import MultiAgentEnv
    from ray_tpu_torch.rllib.env import Box

    class Spread1D(MultiAgentEnv):
        possible_agents = ["agent_0", "agent_1"]

        def __init__(self, config=None):
            self._obs_space = Box(-2, 2, (4,), np.float32)
            self._act_space = Box(-1, 1, (1,), np.float32)
            self.goals = np.array([-0.5, 0.5], np.float32)
            self.t = 0
            self._rng = np.random.default_rng(0)

        @property
        def observation_space(self):
            return self._obs_space

        @property
        def action_space(self):
            return self._act_space

        def reset(self, *, seed=None):
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            self.pos = self._rng.uniform(-1, 1, 2).astype(np.float32)
            self.t = 0
            return self._obs(), {}

        def _obs(self):
            return {
                "agent_0": np.array([self.pos[0], self.pos[1], *self.goals], np.float32),
                "agent_1": np.array([self.pos[1], self.pos[0], *self.goals], np.float32),
            }

        def step(self, actions):
            self.pos[0] = np.clip(self.pos[0] + 0.1 * float(actions["agent_0"][0]), -2, 2)
            self.pos[1] = np.clip(self.pos[1] + 0.1 * float(actions["agent_1"][0]), -2, 2)
            self.t += 1
            d1 = abs(self.pos[0] - self.goals[0]) + abs(self.pos[1] - self.goals[1])
            d2 = abs(self.pos[0] - self.goals[1]) + abs(self.pos[1] - self.goals[0])
            r = -min(d1, d2)
            if abs(self.pos[0] - self.pos[1]) < 0.1:
                r -= 1.0
            done = self.t >= 25
            return self._obs(), {"agent_0": r / 2, "agent_1": r / 2}, {"__all__": done}, {"__all__": False}, {}

    return Spread1D


def _offline_data(path: str, env_id: str, rows: int, seed: int, expert_share: float = 0.0) -> int:
    """A dataset through the port's env and JsonWriter, as the reference
    tests write theirs: uniform random torques in [-2, 2] on Pendulum-v1
    (tests/test_rllib_algorithms.py's CQL data); on CartPole-v1 a scripted
    controller's action with probability ``expert_share``, else a random one
    (tests/test_rllib_ars_crr.py's CRR data). Returns the row count."""
    from ray_tpu_torch.rllib.env import make
    from ray_tpu_torch.rllib.offline import JsonWriter
    from ray_tpu_torch.rllib.policy.sample_batch import ACTIONS, DONES, NEXT_OBS, OBS, REWARDS, SampleBatch

    env = make(env_id)
    rng = np.random.default_rng(seed)
    rows_ = {k: [] for k in (OBS, ACTIONS, REWARDS, DONES, NEXT_OBS)}
    obs, _ = env.reset(seed=seed)
    for _ in range(rows):
        if env_id == "CartPole-v1":
            a = int(obs[2] + 0.3 * obs[3] > 0) if rng.random() < expert_share else int(rng.integers(2))
            nobs, r, term, trunc, _ = env.step(a)
            rows_[ACTIONS].append(np.int64(a))
        else:
            a = rng.uniform(-1, 1, size=(1,)).astype(np.float32)
            nobs, r, term, trunc, _ = env.step(a * 2.0)
            rows_[ACTIONS].append(a)
        rows_[OBS].append(np.asarray(obs, np.float32))
        rows_[REWARDS].append(np.float32(r))
        rows_[DONES].append(np.float32(term or trunc))
        rows_[NEXT_OBS].append(np.asarray(nobs, np.float32))
        obs = nobs
        if term or trunc:
            obs, _ = env.reset()
    writer = JsonWriter(path)
    writer.write(SampleBatch({k: np.asarray(v) for k, v in rows_.items()}))
    writer.close()
    return rows


def _held_to_cpu(torch, A, label, card_fn, cpu_fn, control_fn, cuda, failures) -> dict:
    """One update's metrics and gradients on the card (``card_fn``: full f32)
    against the CPU's (``cpu_fn``), TF32 switched on around both: the metrics
    within RLLIB_ATARI_RTOL, the gradients within RLLIB_ATARI_GRAD_RTOL, and
    ``control_fn``'s gradients (the same loss with TF32 allowed) outside it."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        m_card, g_card = card_fn()
        m_cpu, g_cpu = cpu_fn()
        g_tf32 = control_fn() if cuda else None
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

    def flat(grads):
        return torch.cat([g.detach().reshape(-1).float().cpu() for g in grads])

    got = {k: float(v.detach()) for k, v in m_card.items()}
    want = {k: float(v.detach()) for k, v in m_cpu.items()}
    close = _close_metrics(got, want, list(want), RLLIB_ATARI_RTOL)
    gap = A.mismatch(flat(g_card), flat(g_cpu))
    tf32 = A.mismatch(flat(g_tf32), flat(g_cpu)) if g_tf32 is not None else None
    print(f"{label} first update on the card against the CPU (bar rtol {RLLIB_ATARI_RTOL}): "
          + ", ".join(f"{k} {got[k]:.6g} vs {want[k]:.6g} (rel {r:.1e})" for k, (r, _) in close.items())
          + f"; gradients rel_l2 {gap['rel_l2']:.1e} (bar {RLLIB_ATARI_GRAD_RTOL}); the TF32 control's gradients "
          f"rel_l2 {tf32['rel_l2'] if tf32 else float('nan'):.1e}")
    if not all(ok for _, ok in close.values()) or not gap["rel_l2"] <= RLLIB_ATARI_GRAD_RTOL:
        failures.append(f"{label}: the first update on the card parts from the CPU's: {close} {gap}")
    if cuda and not tf32["rel_l2"] > RLLIB_ATARI_GRAD_RTOL:
        failures.append(f"{label}: the TF32 control is within the bar ({tf32['rel_l2']:.2e})")
    return {"rel": {k: r for k, (r, _) in close.items()}, "grad": gap, "tf32_control_grad": tf32}


def _timed_updates(torch, cuda, fn, n) -> float:
    """ms an update over ``n`` calls of ``fn`` (host clock to a synchronize)."""
    if cuda:
        torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    if cuda:
        torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e3


def rllib_continuous(torch, rt, card, device, failures, scratch) -> dict:
    """Section (h) of the rllib phase, in its cluster: SAC, TD3, CQL, CRR,
    Ape-X DDPG and MADDPG at their defaults. Returns their numbers; appends
    to ``failures``."""
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.rllib import (
        ApexDDPGConfig, CQLConfig, CRRConfig, MADDPGConfig, SACConfig, TD3Config,
    )
    from ray_tpu_torch.rllib.algorithms.cql.cql import cql_loss
    from ray_tpu_torch.rllib.algorithms.ddpg.ddpg import ddpg_critic_loss, ddpg_params_from_jax
    from ray_tpu_torch.rllib.algorithms.maddpg.maddpg import maddpg_loss
    from ray_tpu_torch.rllib.algorithms.off_policy import trainable
    from ray_tpu_torch.rllib.algorithms.sac.sac import sac_loss
    from ray_tpu_torch.rllib.core.learner import full_f32, to_device, weights_checksum
    from ray_tpu_torch.rllib.core.rl_module import copy_into, host_tree, tree_leaves
    from ray_tpu_torch.rllib.policy.sample_batch import ACTIONS, OBS

    c = RLLIB_CONTINUOUS
    cuda = device == "cuda"
    res, marks = {}, {}

    def twin(config, algo, trees=("params", "target")):
        """The same algorithm on the CPU, holding ``algo``'s weights."""
        cpu = config.resources(device="cpu").build()
        for name in trees:
            copy_into(getattr(cpu, name), host_tree(getattr(algo, name)))
        return cpu

    def on_cpu(tree):
        return {k: v.detach().cpu() for k, v in tree.items()}

    # ---- (h1) SAC on Pendulum-v1 at its defaults ----
    t_sec = time.perf_counter()
    sac_cfg = lambda: SACConfig().environment("Pendulum-v1").debugging(seed=0)  # noqa: E731
    algo = sac_cfg().resources(device=device).build()
    first, act_s = {}, []
    try:
        real_update, real_act = algo.update, algo._act

        def checked_update(batch, draws=None):
            if not first:
                draws = algo._update_draws(len(batch[ACTIONS]))
                tb = to_device(batch, algo.device)
                cpu = twin(sac_cfg(), algo)
                kw = dict(discrete=False, action_dim=algo.action_dim, gamma=algo._algo_config.gamma,
                          target_entropy=algo.target_entropy)

                def control():
                    total, _ = sac_loss(algo.params, algo.target, tb, draws, **kw)
                    return torch.autograd.grad(total, tree_leaves(algo.params))

                first.update(_held_to_cpu(torch, A, "sac", lambda: algo.loss_and_grads(tb, draws),
                                          lambda: cpu.loss_and_grads(to_device(batch, torch.device("cpu")), on_cpu(draws)),
                                          control, cuda, failures))
                cpu.cleanup()
            return real_update(batch, draws)

        def timed_act(obs, explore):
            t = time.perf_counter()
            out = real_act(obs, explore)
            act_s.append(time.perf_counter() - t)
            return out

        algo.update, algo._act = checked_update, timed_act
        iters = []
        for _ in range(c["sac_iters"]):
            t = time.perf_counter()
            m = algo.step()
            iters.append(time.perf_counter() - t)
        steps = algo._algo_config.rollout_steps_per_iter
        upd_ms = _timed_updates(torch, cuda, lambda: real_update(algo.buffer.sample(256)), c["timed_updates"])
        print(f"sac on {card} (Pendulum-v1, hiddens (256, 256), batch 256, learning from step 1500): "
              f"{c['sac_iters']} iterations of {steps} env steps in {[round(x, 2) for x in iters]} s "
              f"({[round(steps / x) for x in iters]} env steps/s: the first random actions only, the second acting "
              f"from step 1500 with one update a step); acting {np.median(act_s) * 1e3:.3f} ms median a step (one "
              f"forward on the card, one read; {len(act_s)} steps); {upd_ms:.2f} ms an update ({c['timed_updates']} "
              f"timed: replay sample, H2D, loss, backward, Adam, Polyak); critic_loss {m.get('critic_loss')}, alpha "
              f"{m.get('alpha')}, episode_reward_mean {m.get('episode_reward_mean')}")
        if not first or not _finite(m, "critic_loss") or not len(act_s) == c["sac_iters"] * steps - 1500:
            failures.append(f"sac: first update {bool(first)}, {len(act_s)} acting steps, metrics {m}")
        res["sac"] = {"iteration_s": iters, "env_steps_per_s": [steps / x for x in iters],
                      "act_ms": float(np.median(act_s)) * 1e3, "update_ms": upd_ms, "first_update": first,
                      "critic_loss": m.get("critic_loss")}
    finally:
        algo.cleanup()
    marks["sac_s"] = time.perf_counter() - t_sec

    # ---- (h2) TD3 at its defaults: the actor and the targets move only on delayed steps ----
    t_sec = time.perf_counter()
    algo = TD3Config().environment("Pendulum-v1").resources(device=device).debugging(seed=0).build()
    seen = []
    try:
        real_step = algo.train_step

        def checked_step(batch, update_actor, noise=None):
            if len(seen) < c["delay_checked"]:
                before = [x.detach().clone() for x in tree_leaves(algo.params["actor"]) + tree_leaves(algo.target)]
                mu = [x.clone() for x in algo.opt["actor"].mu]
                m = real_step(batch, update_actor, noise)
                after = tree_leaves(algo.params["actor"]) + tree_leaves(algo.target)
                moved = [not torch.equal(a.detach(), b) for a, b in zip(after, before)]
                mu_moved = any(not torch.equal(a, b) for a, b in zip(algo.opt["actor"].mu, mu))
                seen.append((algo._updates, bool(update_actor), all(moved), any(moved), mu_moved))
                return m
            return real_step(batch, update_actor, noise)

        algo.train_step = checked_step
        iters = []
        for _ in range(c["td3_iters"]):
            t = time.perf_counter()
            m = algo.step()
            iters.append(time.perf_counter() - t)
        upd_ms = _timed_updates(torch, cuda, lambda: real_step(algo.buffer.sample(256), True), c["timed_updates"])
        ok = all(a == (u % 2 == 0) and ((all_m and mu_m) if a else not (any_m or mu_m))
                 for u, a, all_m, any_m, mu_m in seen)
        print(f"td3 on {card}: {c['td3_iters']} iterations in {[round(x, 2) for x in iters]} s, {algo._updates} "
              f"updates (policy_delay 2); the first {len(seen)} updates (number, actor step, every actor and target "
              f"leaf moved, any moved, actor moments moved): {seen}; {upd_ms:.2f} ms an update with the actor step; "
              f"critic_loss {m.get('critic_loss')}")
        if not ok or len(seen) < c["delay_checked"] or not _finite(m, "critic_loss"):
            failures.append(f"td3: the delay did not hold: {seen}, metrics {m}")
        res["td3"] = {"iteration_s": iters, "updates": algo._updates, "update_ms": upd_ms, "delay_held": ok,
                      "critic_loss": m.get("critic_loss")}
    finally:
        algo.cleanup()
    marks["td3_s"] = time.perf_counter() - t_sec

    # ---- (h3) CQL at its defaults on a Pendulum dataset ----
    t_sec = time.perf_counter()
    path = os.path.join(scratch, "cql_pendulum")
    rows = _offline_data(path, "Pendulum-v1", c["cql_rows"], 0)
    cql_cfg = lambda: CQLConfig().environment("Pendulum-v1").offline_data(input_=path).debugging(seed=0)  # noqa: E731
    algo = cql_cfg().resources(device=device).build()
    first = {}
    try:
        real_update = algo.update

        def checked_cql(batch, draws=None):
            if not first:
                draws = algo._update_draws(batch[OBS].shape[0])
                cpu = twin(cql_cfg(), algo)
                cfg = algo._algo_config
                kw = dict(discrete=False, action_dim=algo.action_dim, gamma=cfg.gamma, cql_alpha=cfg.cql_alpha,
                          n_cql=cfg.num_cql_actions, target_entropy=algo.target_entropy)

                def control():
                    total, _ = cql_loss(algo.params, algo.target, batch, draws, **kw)
                    return torch.autograd.grad(total, tree_leaves(algo.params))

                first.update(_held_to_cpu(torch, A, "cql", lambda: algo.loss_and_grads(batch, draws),
                                          lambda: cpu.loss_and_grads(on_cpu(batch), on_cpu(draws)), control, cuda,
                                          failures))
            return real_update(batch, draws)

        algo.update = checked_cql
        t = time.perf_counter()
        m = algo.step()
        it_s = time.perf_counter() - t
        upd_ms = _timed_updates(torch, cuda, lambda: real_update(algo.read_batch(algo.reader.next(256))),
                                c["timed_updates"])
        print(f"cql on {card} ({rows} rows of Pendulum-v1, hiddens (256, 256), batch 256, 4 sampled actions): "
              f"1 iteration of 200 updates in {it_s:.2f} s; {upd_ms:.2f} ms an update (reader batch, H2D, loss, "
              f"backward, Adam, Polyak); bellman_loss {m.get('bellman_loss')}, cql_term {m.get('cql_term')}")
        if not first or not _finite(m, "bellman_loss") or not _finite(m, "cql_term"):
            failures.append(f"cql: first update {bool(first)}, metrics {m}")
        res["cql"] = {"iteration_s": it_s, "update_ms": upd_ms, "first_update": first,
                      "bellman_loss": m.get("bellman_loss"), "cql_term": m.get("cql_term")}
    finally:
        algo.cleanup()
    marks["cql_s"] = time.perf_counter() - t_sec

    # ---- (h4) CRR (exp weights) on offline CartPole ----
    t_sec = time.perf_counter()
    path = os.path.join(scratch, "crr_cartpole")
    rows = _offline_data(path, "CartPole-v1", c["crr_rows"], 0, expert_share=0.6)
    algo = (CRRConfig().environment("CartPole-v1").offline_data(input_=path)
            .training(weight_type="exp").resources(device=device).debugging(seed=0).build())
    try:
        t = time.perf_counter()
        m = algo.step()
        it_s = time.perf_counter() - t
        upd_ms = _timed_updates(torch, cuda, lambda: algo.update(algo.read_batch(algo.reader.next(256))),
                                c["timed_updates"])
        from ray_tpu_torch.rllib.env import make

        env, rewards = make("CartPole-v1"), []
        for ep in range(5):
            obs, _ = env.reset(seed=100 + ep)
            total = 0.0
            for _ in range(500):
                obs, r, term, trunc, _ = env.step(algo.compute_single_action(obs))
                total += r
                if term or trunc:
                    break
            rewards.append(total)
        print(f"crr on {card} ({rows} rows, 60% scripted expert; exp weights; hiddens (256, 256), batch 256): "
              f"1 iteration of 200 updates in {it_s:.2f} s; {upd_ms:.2f} ms an update; critic_loss "
              f"{m.get('critic_loss')}, actor_loss {m.get('actor_loss')}, mean_weight {m.get('mean_weight')}; "
              f"greedy reward over 5 episodes {float(np.mean(rewards))}")
        if not all(_finite(m, k) for k in ("critic_loss", "actor_loss", "total_loss")):
            failures.append(f"crr: metrics {m}")
        res["crr"] = {"iteration_s": it_s, "update_ms": upd_ms, "reward": float(np.mean(rewards)),
                      "total_loss": m.get("total_loss")}
    finally:
        algo.cleanup()
    marks["crr_s"] = time.perf_counter() - t_sec

    # ---- (h5) Ape-X DDPG: 2 explorers pinned to the host, the learner on the card ----
    t_sec = time.perf_counter()
    algo = ApexDDPGConfig().environment("Pendulum-v1").resources(device=device).debugging(seed=0).build()
    weighted = {}
    try:
        build_s = time.perf_counter() - t_sec
        real_step = algo.train_step

        def checked_apex(batch, update_actor, noise=None):
            # The first learner step whose importance weights are not all
            # equal (the shards' priorities have moved): its weighted critic
            # loss, TD errors and gradients on the card against the CPU's.
            if not weighted and np.ptp(np.asarray(batch["weights"])) > 0:
                cfg = algo._algo_config
                kw = dict(gamma=cfg.gamma, twin_q=cfg.twin_q, smooth=False, target_noise=0.0, noise_clip=0.0)

                def run(params, target, b):
                    critic = {k: params[k] for k in algo._critic_keys}
                    loss, td, _ = ddpg_critic_loss(critic, target, b, None, weights=b["weights"], **kw)
                    return ({"critic_loss": loss, "td_abs_sum": td.abs().sum()},
                            torch.autograd.grad(loss, tree_leaves(critic)))

                def on_card():
                    with full_f32(algo.device):
                        return run(algo.params, algo.target, to_device(batch, algo.device))

                def on_host():
                    cpu = torch.device("cpu")
                    return run(trainable(ddpg_params_from_jax(host_tree(algo.params), device=cpu), cpu),
                               ddpg_params_from_jax(host_tree(algo.target), device=cpu), to_device(batch, cpu))

                weighted.update(_held_to_cpu(torch, A, "apex_ddpg weighted", on_card, on_host,
                                             lambda: run(algo.params, algo.target, to_device(batch, algo.device))[1],
                                             cuda, failures))
            return real_step(batch, update_actor, noise)

        algo.train_step = checked_apex
        iters = []
        for _ in range(c["apex_iters"]):
            t = time.perf_counter()
            m = algo.step()
            iters.append(time.perf_counter() - t)
        t = time.perf_counter()
        algo.sync_worker_weights()
        sync_ms = (time.perf_counter() - t) * 1e3
        want = weights_checksum(algo.params)
        got = rt.get([w.weights_checksum.remote() for w in algo.workers], timeout=60)
        print(f"apex_ddpg on {card}: built in {build_s:.2f} s (2 explorers, 2 shards), {c['apex_iters']} iterations "
              f"in {[round(x, 2) for x in iters]} s, {algo._timesteps_total} env steps, {algo._updates} updates on "
              f"{algo.params['actor'][0]['w'].device}; a sync {sync_ms:.2f} ms; explorers bit-equal to the learner "
              f"{[g == want for g in got]}; critic_loss {m.get('critic_loss')}, replay {m.get('replay_size')}")
        if not got or any(g != want for g in got) or not algo._updates or not _finite(m, "critic_loss"):
            failures.append(f"apex_ddpg: checksums {got} vs {want}, {algo._updates} updates, metrics {m}")
        if not weighted:
            failures.append("apex_ddpg: no learner step had non-uniform importance weights")
        res["apex_ddpg"] = {"build_s": build_s, "iteration_s": iters, "updates": algo._updates, "sync_ms": sync_ms,
                            "bit_equal": all(g == want for g in got), "weighted_step": weighted}
    finally:
        algo.cleanup()
    marks["apex_ddpg_s"] = time.perf_counter() - t_sec

    # ---- (h6) MADDPG on the 2-agent spread: its first update against the CPU ----
    t_sec = time.perf_counter()
    Spread1D = _spread_env_class()
    ma_cfg = lambda: MADDPGConfig().environment(Spread1D).debugging(seed=0)  # noqa: E731
    algo = ma_cfg().resources(device=device).build()
    first = {}
    try:
        real_update = algo.update

        def checked_maddpg(batch):
            if not first:
                cpu = twin(ma_cfg(), algo, ("params", "target_params"))
                tb = {k: torch.from_numpy(np.require(v, np.float32, "W")).to(algo.device) for k, v in batch.items()}

                def control():
                    total, _ = maddpg_loss(algo.params, algo.target_params, tb, gamma=algo._algo_config.gamma)
                    return torch.autograd.grad(total, tree_leaves(algo.params["actor"])
                                               + tree_leaves(algo.params["critic"]))

                def run(a, b):
                    total, aux, ga, gc = a.loss_and_grads(b)
                    return dict(aux, total_loss=total), ga + gc

                first.update(_held_to_cpu(torch, A, "maddpg", lambda: run(algo, tb), lambda: run(cpu, on_cpu(tb)),
                                          control, cuda, failures))
                cpu.cleanup()
            return real_update(batch)

        algo.update = checked_maddpg
        iters = []
        for _ in range(c["maddpg_iters"]):
            t = time.perf_counter()
            m = algo.step()
            iters.append(time.perf_counter() - t)
        upd_ms = _timed_updates(torch, cuda, lambda: real_update(algo.buffer.sample(256)), c["timed_updates"])
        print(f"maddpg on {card} (2 agents, hiddens (64, 64), batch 256): {c['maddpg_iters']} iterations in "
              f"{[round(x, 2) for x in iters]} s, {algo._updates} updates; {upd_ms:.2f} ms an update; metrics {m}")
        if not first or not algo._updates or not _finite(m, "total_loss"):
            failures.append(f"maddpg: first update {bool(first)}, {algo._updates} updates, metrics {m}")
        res["maddpg"] = {"iteration_s": iters, "updates": algo._updates, "update_ms": upd_ms, "first_update": first}
    finally:
        algo.cleanup()
    marks["maddpg_s"] = time.perf_counter() - t_sec
    res["sections_s"] = marks
    return res


def _event_ms(torch, cuda, fn, n) -> float:
    """ms a call over ``n`` calls of ``fn``: CUDA events around the calls on
    the card (the host clock on the CPU)."""
    if not cuda:
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t) / n * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def rllib_model_based(torch, rt, card, device, failures) -> dict:
    """Section (i) of the rllib phase, in its cluster: DreamerV3, MAML and
    MBMPO at their defaults (RLLIB_MODEL_BASED). Returns their numbers;
    appends to ``failures``."""
    from unittest import mock

    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.rllib import DreamerV3Config, MAMLConfig, MBMPOConfig
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import dreamerv3 as dv3
    from ray_tpu_torch.rllib.algorithms.maml import maml
    from ray_tpu_torch.rllib.algorithms.mbmpo import mbmpo
    from ray_tpu_torch.rllib.core.rl_module import copy_into, host_tree
    from ray_tpu_torch.rllib.env import PointGoalEnv

    c = RLLIB_MODEL_BASED
    cuda = device == "cuda"
    res, marks = {}, {}

    def tf32_allowed(module):
        """The module's update with its full-f32 scope taken away: TF32 as
        the process has it (the control)."""
        return mock.patch.object(module, "full_f32", lambda device: contextlib.nullcontext())

    def on_cpu(tree):
        return {k: (v.detach().cpu() if isinstance(v, torch.Tensor) else on_cpu(v)) for k, v in tree.items()}

    # ---- (i1) DreamerV3 on Pendulum-v1 and CartPole-v1 at its defaults ----
    for env in ("Pendulum-v1", "CartPole-v1"):
        t_sec = time.perf_counter()
        label = f"dreamerv3 {env}"
        dv3_cfg = lambda res_device: (DreamerV3Config().environment(env)  # noqa: E731
                                      .resources(device=res_device).debugging(seed=0))
        algo = dv3_cfg(device).build()
        first, act_s = {}, []
        try:
            real_update, real_act = algo.update, algo._act

            def twin(res_device):
                other = dv3_cfg(res_device).build()
                for name in ("params", "actor_params", "critic_params", "critic_ema"):
                    copy_into(getattr(other, name), host_tree(getattr(algo, name)))
                other.return_scale = algo.return_scale.to(other.device)
                return other

            def checked_update(batch, draws=None):
                if first:
                    return real_update(batch, draws)
                cfg = algo._algo_config
                draws = algo._update_draws(cfg.batch_size, cfg.batch_length)
                cpu, ctl = twin("cpu"), twin(device)

                def control():
                    with tf32_allowed(dv3):
                        return ctl.train_step(batch, draws)[1]

                out = {}

                def on_card():
                    out["m"], grads = algo.train_step(batch, draws)
                    return out["m"], grads

                first.update(_held_to_cpu(torch, A, label, on_card, lambda: cpu.train_step(batch, on_cpu(draws)),
                                          control, cuda, failures))
                cpu.cleanup()
                ctl.cleanup()
                return out["m"]

            def timed_act(explore=True):
                t = time.perf_counter()
                out = real_act(explore)
                act_s.append(time.perf_counter() - t)
                return out

            algo.update, algo._act = checked_update, timed_act
            iters = []
            for _ in range(c["dreamer_iters"]):
                t = time.perf_counter()
                m = algo.step()
                iters.append(time.perf_counter() - t)
            steps = algo._algo_config.rollout_steps_per_iter
            cfg = algo._algo_config
            n_run = algo._updates
            batches = [algo.buffer.sample(cfg.batch_size, cfg.batch_length) for _ in range(c["dreamer_timed"])]
            it = iter(batches)
            upd_ms = _event_ms(torch, cuda, lambda: real_update(next(it)), c["dreamer_timed"])
            a = algo.compute_single_action(np.zeros(algo.obs_dim, np.float32))
            print(f"{label} on {card} (deter 128, 8x8 latents, hiddens (128,), batch 8x16, horizon 10): "
                  f"{c['dreamer_iters']} iterations of {steps} env steps in {[round(x, 2) for x in iters]} s "
                  f"({[round(steps / x) for x in iters]} env steps/s; {n_run} updates, from buffer row 500); "
                  f"acting {np.median(act_s) * 1e3:.3f} ms median a step (the posterior and the actor on the card, "
                  f"one read; {len(act_s)} steps); {upd_ms:.2f} ms an update ({c['dreamer_timed']} timed with CUDA "
                  f"events, the replay batches sampled before: H2D, world loss over 16 steps, its backward and Adam, "
                  f"10 imagined steps, the actor and critic backward and Adams, the EMA); metrics {m}; "
                  f"compute_single_action(zeros) = {a}")
            if not first or not _finite(m, "model_loss") or not _finite(m, "actor_loss") or not n_run:
                failures.append(f"{label}: first update {bool(first)}, {n_run} updates, metrics {m}")
            res[label] = {"iteration_s": iters, "env_steps_per_s": [steps / x for x in iters],
                          "act_ms": float(np.median(act_s)) * 1e3, "update_ms": upd_ms, "updates": n_run,
                          "first_update": first, "model_loss": m.get("model_loss"),
                          "actor_loss": m.get("actor_loss")}
        finally:
            algo.cleanup()
        marks[f"{label}_s"] = time.perf_counter() - t_sec

    # ---- (i2) MAML on PointGoalEnv at its defaults: 2 CPU rollout actors ----
    t_sec = time.perf_counter()
    algo = MAMLConfig().environment(PointGoalEnv, env_config={"seed": 0}).resources(device=device) \
        .debugging(seed=0).build()
    first, stacks = {}, {}
    try:
        learner = algo.learner
        real_meta = learner.meta_update

        def checked_meta(pre, post):
            if not first:
                stacks.update(pre=pre, post=post)
                cfg = algo._algo_config
                cpu = cfg.meta_learner(algo.module_spec, "cpu")
                cpu.module.load_params(learner.module.get_params())

                def control():
                    with tf32_allowed(maml):
                        return learner.meta_loss_and_grads(pre, post)[1]

                def run(lrn, a, b):
                    loss, grads = lrn.meta_loss_and_grads(a, b)
                    return {"meta_loss": loss}, grads

                first.update(_held_to_cpu(torch, A, "maml meta-update (second order)",
                                          lambda: run(learner, pre, post),
                                          lambda: run(cpu, on_cpu(pre), on_cpu(post)), control, cuda, failures))
            return real_meta(pre, post)

        learner.meta_update = checked_meta
        iters = []
        for _ in range(c["maml_iters"]):
            t = time.perf_counter()
            m = algo.step()
            iters.append(time.perf_counter() - t)
        meta_ms = _event_ms(torch, cuda, lambda: real_meta(stacks["pre"], stacks["post"]), c["maml_timed"])
        print(f"maml on {card} (PointGoalEnv, meta-batch 10, 10 episodes a task, 2 CPU rollout actors, hiddens "
              f"(64, 64)): {c['maml_iters']} iterations in {[round(x, 2) for x in iters]} s (4000 env steps on the "
              f"actors, 10 adaptations, 5 meta-updates each); {meta_ms:.2f} ms a second-order meta-update "
              f"({c['maml_timed']} timed with CUDA events: 10 tasks, each an inner gradient with its graph, the "
              f"outer loss, the gradient through both, Adam); metrics {m}")
        if not first or not _finite(m, "meta_loss") or not _finite(m, "adaptation_delta"):
            failures.append(f"maml: first meta-update {bool(first)}, metrics {m}")
        res["maml"] = {"iteration_s": iters, "meta_update_ms": meta_ms, "first_meta_update": first,
                       "meta_loss": m.get("meta_loss"), "adaptation_delta": m.get("adaptation_delta")}
    finally:
        algo.cleanup()
    marks["maml_s"] = time.perf_counter() - t_sec

    # ---- (i3) MBMPO on PointGoalEnv at its defaults ----
    t_sec = time.perf_counter()
    algo = MBMPOConfig().environment(PointGoalEnv, env_config={"seed": 0}).resources(device=device) \
        .debugging(seed=0).build()
    first = {}
    try:
        real_ens = algo.ensemble_update

        def checked_ens(obs_k, act_k, nxt_k):
            if not first:
                cpu_dyn = [{k: v.detach().cpu().requires_grad_(True) for k, v in layer.items()}
                           for layer in algo.dyn_params]

                def run(dyn, o, a, n):
                    losses, grads = mbmpo.ensemble_loss_and_grads(dyn, o, a, n)
                    return {f"member_{i}_loss": x for i, x in enumerate(losses)}, grads

                def on_card():
                    with maml.full_f32(algo.device):
                        return run(algo.dyn_params, obs_k, act_k, nxt_k)

                first.update(_held_to_cpu(torch, A, "mbmpo ensemble update", on_card,
                                          lambda: run(cpu_dyn, obs_k.cpu(), act_k.cpu(), nxt_k.cpu()),
                                          lambda: run(algo.dyn_params, obs_k, act_k, nxt_k)[1], cuda, failures))
            return real_ens(obs_k, act_k, nxt_k)

        algo.ensemble_update = checked_ens
        iters = []
        for _ in range(c["mbmpo_iters"]):
            t = time.perf_counter()
            m = algo.step()
            iters.append(time.perf_counter() - t)
        # One imagined rollout from member 0 on the card against the CPU's.
        B, H = 20, algo._horizon
        starts = torch.from_numpy(algo._start_obs[:B]).to(algo.device)
        noise = algo._noise(H, B, algo.act_dim)
        theta = {k: p.detach() for k, p in algo.learner.params().items()}
        model = algo._model_slice(0)
        task = torch.as_tensor(np.asarray(algo.env.get_task(), np.float32))
        cpu_module = algo._algo_config.meta_learner(algo.module_spec, "cpu").module
        cpu_module.load_params(algo.learner.module.get_params())
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            with maml.full_f32(algo.device):
                got = mbmpo.imagine(algo.learner.module, theta, model, starts, noise, algo.reward)
            want = mbmpo.imagine(cpu_module, on_cpu(theta), [on_cpu(layer) for layer in model], starts.cpu(),
                                 noise.cpu(), lambda s, a, n: PointGoalEnv.reward_fn(s, a, n, task))
            ctl = mbmpo.imagine(algo.learner.module, theta, model, starts, noise, algo.reward) if cuda else None
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

        def flat(cols):
            return torch.cat([x.detach().reshape(-1).float().cpu() for x in cols])

        gap = A.mismatch(flat(got), flat(want))
        tf32 = A.mismatch(flat(ctl), flat(want)) if ctl is not None else None
        print(f"mbmpo imagined rollout (member 0, {B} starts, horizon {H}) on the card against the CPU: rel_l2 "
              f"{gap['rel_l2']:.1e} over obs, actions, rewards, logp, vf (bar {RLLIB_ATARI_GRAD_RTOL}); the TF32 "
              f"control's rel_l2 {tf32['rel_l2'] if tf32 else float('nan'):.1e}")
        if not gap["rel_l2"] <= RLLIB_ATARI_GRAD_RTOL:
            failures.append(f"mbmpo: the imagined rollout on the card parts from the CPU's: {gap}")
        n = len(algo._replay_obs)
        idx = [algo._np_rng.integers(0, n, (5, 256)) for _ in range(c["mbmpo_timed"])]
        cols = iter([[torch.from_numpy(col[i]).to(algo.device)
                      for col in (algo._replay_obs, algo._replay_act, algo._replay_next)] for i in idx])
        ens_ms = _event_ms(torch, cuda, lambda: real_ens(*next(cols)), c["mbmpo_timed"])
        t = time.perf_counter()
        for _ in range(c["mbmpo_timed"]):
            algo._imagined_batch(theta, model)
        imag_ms = (time.perf_counter() - t) / c["mbmpo_timed"] * 1e3
        print(f"mbmpo on {card} (PointGoalEnv, 5 members of (64, 64), batch 256, 30 epochs, 20 real and 20 imagined "
              f"episodes): {c['mbmpo_iters']} iterations in {[round(x, 2) for x in iters]} s; {ens_ms:.3f} ms an "
              f"ensemble update ({c['mbmpo_timed']} timed with CUDA events: the 5 members' batched forward, backward "
              f"and one Adam over the stacked leaves); {imag_ms:.2f} ms an imagined batch (host clock: 20 steps of "
              f"the policy, its draw, the member and the reward on the card, the read, GAE on the host); metrics {m}")
        if not first or not _finite(m, "meta_loss") or not _finite(m, "dynamics_loss"):
            failures.append(f"mbmpo: first ensemble update {bool(first)}, metrics {m}")
        res["mbmpo"] = {"iteration_s": iters, "ensemble_update_ms": ens_ms, "imagined_batch_ms": imag_ms,
                        "first_ensemble_update": first, "imagined_rollout": gap, "imagined_rollout_tf32": tf32,
                        "meta_loss": m.get("meta_loss"), "dynamics_loss": m.get("dynamics_loss")}
    finally:
        algo.cleanup()
    marks["mbmpo_s"] = time.perf_counter() - t_sec
    res["sections_s"] = marks
    return res


def _two_step_env_class():
    """tests/test_rllib_multiagent.py's TwoStepGame on the port's
    MultiAgentEnv and spaces: agent 0's first action picks the payoff matrix
    of the second step; the optimum (8) needs a coordinated (1, 1), which
    additive mixing cannot represent and QMIX's monotonic mixing can."""
    from ray_tpu_torch.rllib import MultiAgentEnv
    from ray_tpu_torch.rllib.env import Box, Discrete

    class TwoStepGame(MultiAgentEnv):
        possible_agents = ["a0", "a1"]
        observation_space = Box(0.0, 1.0, (3,), np.float32)
        action_space = Discrete(2)

        def __init__(self, config=None):
            self._state = 0

        def _obs(self):
            o = np.zeros(3, np.float32)
            o[self._state] = 1.0
            return {a: o.copy() for a in self.possible_agents}

        def reset(self, *, seed=None):
            self._state = 0
            return self._obs(), {}

        def step(self, action_dict):
            if self._state == 0:
                self._state = 1 if action_dict["a0"] == 0 else 2
                return self._obs(), {a: 0.0 for a in self.possible_agents}, {"__all__": False}, {"__all__": False}, {}
            r = 7.0 if self._state == 1 else float(np.array([[0.0, 1.0], [1.0, 8.0]])[action_dict["a0"],
                                                                                      action_dict["a1"]])
            return self._obs(), {a: r / 2 for a in self.possible_agents}, {"__all__": True}, {"__all__": False}, {}

        def close(self):
            pass

    return TwoStepGame


def _context_bandit_class():
    """tests/test_cluster_launcher.py's 2-arm contextual bandit on the port's
    spaces: arm 0 pays when ctx[0] > 0, else arm 1."""
    from ray_tpu_torch.rllib.env import Box, Discrete

    class ContextBandit:
        observation_space = Box(-1, 1, (2,), np.float32)
        action_space = Discrete(2)

        def __init__(self, config=None):
            self._rng = np.random.default_rng(0)
            self._ctx = None

        def _next(self):
            self._ctx = self._rng.uniform(-1, 1, 2).astype(np.float32)
            return self._ctx

        def reset(self, *, seed=None, options=None):
            return self._next(), {}

        def step(self, action):
            good = 0 if self._ctx[0] > 0 else 1
            return self._next(), 1.0 if int(action) == good else 0.0, True, False, {}

        def close(self):
            pass

    return ContextBandit


def bandits_on_the_host(iters: int) -> dict:
    """LinUCB and LinTS on the 2-arm context bandit, ``iters`` iterations of
    200 steps each: the mean reward by iteration and the greedy arm for
    ctx[0] = 0.9 and -0.9 (section (j) runs this in a process that sees no
    card)."""
    import torch

    from ray_tpu_torch.rllib import BanditLinTS, BanditLinUCB

    res = {}
    for cls in (BanditLinUCB, BanditLinTS):
        cfg = cls.get_default_config().environment(_context_bandit_class())
        cfg.steps_per_iter = 200
        algo = cfg.build()
        try:
            rewards = [algo.step()["mean_reward"] for _ in range(iters)]
            greedy = [algo.compute_single_action(np.array([x, 0.0], np.float32)) for x in (0.9, -0.9)]
        finally:
            algo.cleanup()
        res[cls.__name__] = {"mean_reward": rewards, "greedy": greedy}
    return {"algorithms": res, "cuda_available": torch.cuda.is_available()}


def _expert_rows(path: str, kind: str) -> int:
    """tests/test_rllib.py's offline data through the port's JsonWriter: BC's
    2,000 expert rows (action 1 iff obs[0] > 0, 100-step episodes) or
    MARWIL's 3,000 one-step rows, half expert (reward 1) and half
    anti-expert (reward 0). Returns the row count."""
    from ray_tpu_torch.rllib.offline import JsonWriter
    from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch

    n = 2000 if kind == "bc" else 3000
    rng = np.random.default_rng(0 if kind == "bc" else 1)
    obs = rng.uniform(-1, 1, size=(n, 4)).astype(np.float32)
    expert = (obs[:, 0] > 0).astype(np.int64)
    if kind == "bc":
        cols = {"actions": expert, "rewards": np.ones(n, np.float32), "dones": np.arange(n) % 100 == 99}
    else:
        follow = rng.uniform(size=n) < 0.5
        cols = {"actions": np.where(follow, expert, 1 - expert),
                "rewards": np.where(follow, 1.0, 0.0).astype(np.float32), "dones": np.ones(n, bool)}
    writer = JsonWriter(path)
    writer.write(SampleBatch({"obs": obs, **cols}))
    writer.close()
    return n


def _f32_near_ties(scores: np.ndarray, k: int) -> np.ndarray:
    """Rows of ``scores`` [B, C] where the k-th and (k+1)-th largest (or any
    two of the top k + 1) lie within f32 rounding of each other: there the
    card's and the CPU's sums may order them either way."""
    top = -np.sort(-scores.astype(np.float64), axis=1)[:, : k + 1]
    gaps = np.abs(np.diff(top, axis=1))
    scale = np.maximum(np.abs(top[:, :-1]), np.abs(top[:, 1:]))
    return np.any(gaps <= 8 * np.finfo(np.float32).eps * np.maximum(scale, 1e-30), axis=1)


def rllib_lighter(torch, rt, card, device, failures, scratch) -> dict:
    """Section (j) of the rllib phase, in its cluster: BC and MARWIL, QMIX,
    SlateQ, ES and ARS, LinUCB and LinTS at the reference tests' configs
    (RLLIB_LIGHT). Returns their numbers; appends to ``failures``."""
    from unittest import mock

    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.rllib import (
        ARSConfig,
        BCConfig,
        ESConfig,
        MARWILConfig,
        QMIXConfig,
        SlateQConfig,
    )
    from ray_tpu_torch.rllib.algorithms.es import es as tes
    from ray_tpu_torch.rllib.algorithms.marwil.marwil import marwil_loss
    from ray_tpu_torch.rllib.algorithms.qmix import qmix as tqmix
    from ray_tpu_torch.rllib.algorithms.slateq import slateq as tslateq
    from ray_tpu_torch.rllib.core import learner as tlearner
    from ray_tpu_torch.rllib.core.rl_module import RLModule, copy_into, host_tree, tree_leaves
    from ray_tpu_torch.rllib.env import SlateRecEnv

    c = RLLIB_LIGHT
    cuda = device == "cuda"
    res, marks = {}, {}

    def tf32_allowed(module):
        """The module's computation with its full-f32 scope taken away: TF32
        as the process has it (the control)."""
        return mock.patch.object(module, "full_f32", lambda device: contextlib.nullcontext())

    # ---- (j1) BC and MARWIL on tests/test_rllib.py's offline data ----
    for kind, iters, bar, cfg_fn in (
            ("bc", c["bc_iters"], 45, lambda: BCConfig().training(lr=5e-3, train_batch_size=512)),
            ("marwil", c["marwil_iters"], 40,
             lambda: MARWILConfig().training(lr=5e-3, train_batch_size=1024, beta=2.0))):
        t_sec = time.perf_counter()
        path = os.path.join(scratch, kind)
        rows = _expert_rows(path, kind)
        cfg = cfg_fn().environment("CartPole-v1").rollouts(num_rollout_workers=0).debugging(seed=0) \
            .resources(device=device)
        cfg.offline_data(input_=path)
        algo = cfg.build()
        first = {}
        try:
            lg = algo.learner_group
            learner, real_update = lg.local_learner, lg.update

            def checked(batch, loss_cfg, kind=kind, learner=learner, real_update=real_update, first=first):
                if not first:
                    cpu = tlearner.Learner(learner.spec, marwil_loss, device="cpu")
                    cpu.set_weights(learner.get_weights())

                    def run(lrn):
                        loss, metrics, grads = lrn.compute_grads(batch, loss_cfg)
                        return dict(metrics, total_loss=loss), grads

                    def control():
                        with tf32_allowed(tlearner):
                            return learner.compute_grads(batch, loss_cfg)[2]

                    first.update(_held_to_cpu(torch, A, f"{kind} learner update", lambda: run(learner),
                                              lambda: run(cpu), control, cuda, failures))
                return real_update(batch, loss_cfg)

            lg.update = checked
            probe = np.random.default_rng(7).uniform(-1, 1, size=(50, 4)).astype(np.float32)
            t = time.perf_counter()
            for _ in range(iters):
                m = algo.step()
            run_s = time.perf_counter() - t
            matched = sum(int(algo.compute_single_action(o) == int(o[0] > 0)) for o in probe)
            batches = [algo.reader.next(cfg.train_batch_size) for _ in range(c["timed_updates"])]
            it = iter(batches)
            upd_ms = _event_ms(torch, cuda, lambda: real_update(next(it), algo.loss_cfg()), c["timed_updates"])
            print(f"{kind} on {card} ({rows} offline rows, batch {cfg.train_batch_size}, hiddens (64, 64), the "
                  f"learner in this process): {iters} iterations in {run_s:.2f} s; {upd_ms:.3f} ms an update "
                  f"({c['timed_updates']} timed with CUDA events: the batch to the card, forward, backward, the "
                  f"clip, Adam, the metrics read); the expert's action on {matched}/50 probes (bar {bar}); "
                  f"metrics {m}")
            if not first or matched < bar or not _finite(m):
                failures.append(f"{kind}: first update {bool(first)}, {matched}/50 expert matches, metrics {m}")
            res[kind] = {"rows": rows, "iterations": iters, "run_s": run_s, "update_ms": upd_ms,
                         "expert_matches": matched, "bar": bar, "first_update": first,
                         "total_loss": m.get("total_loss")}
        finally:
            algo.cleanup()
        marks[f"{kind}_s"] = time.perf_counter() - t_sec

    # ---- (j2) QMIX on the two-step game ----
    t_sec = time.perf_counter()
    qmix_cfg = lambda res_device: (QMIXConfig().environment(_two_step_env_class())  # noqa: E731
                                   .training(lr=3e-3, train_batch_size=64, learning_starts=128,
                                             target_network_update_freq=40, rollout_steps_per_iter=400,
                                             epsilon_timesteps=3000, final_epsilon=0.05, gamma=0.99)
                                   .debugging(seed=0).resources(device=res_device))
    algo = qmix_cfg(device).build()
    first, act_s = {}, []
    try:
        real_step, real_q = algo.train_step, algo._q_values

        def checked_step(batch):
            if not first:
                cpu = qmix_cfg("cpu").build()
                copy_into(cpu.params, host_tree(algo.params))
                copy_into(cpu.target, host_tree(algo.target))
                tb = {k: torch.from_numpy(np.require(np.asarray(v), requirements="W")) for k, v in batch.items()}

                def run(a, full=True):
                    scope = tqmix.full_f32(a.device) if full else contextlib.nullcontext()
                    with scope:
                        loss, aux = tqmix.qmix_loss(a.params, a.target, {k: v.to(a.device) for k, v in tb.items()},
                                                    gamma=0.99)
                        return dict(aux, loss=loss), torch.autograd.grad(loss, tree_leaves(a.params))

                first.update(_held_to_cpu(torch, A, "qmix train step", lambda: run(algo), lambda: run(cpu),
                                          lambda: run(algo, full=False)[1], cuda, failures))
                cpu.cleanup()
            return real_step(batch)

        def timed_q(obs):
            t = time.perf_counter()
            out = real_q(obs)
            act_s.append(time.perf_counter() - t)
            return out

        algo.train_step, algo._q_values = checked_step, timed_q
        best, iters = -1e9, []
        for _ in range(c["qmix_iters"]):
            t = time.perf_counter()
            r = algo.step()
            iters.append(time.perf_counter() - t)
            if np.isfinite(r["episode_reward_mean"]):
                best = max(best, r["episode_reward_mean"])
            if best >= 7.5:
                break
        greedy = algo.compute_actions(_two_step_env_class()().reset()[0])
        batches = [algo.buffer.sample(64) for _ in range(c["timed_updates"])]
        it = iter(batches)
        upd_ms = _event_ms(torch, cuda, lambda: real_step(next(it)), c["timed_updates"])
        print(f"qmix on {card} (the two-step game, agent (64, 64), mixing embed 32, batch 64): best mean reward "
              f"{best} in {len(iters)} iterations of 400 env steps (bar 7.5 within {c['qmix_iters']}; "
              f"{[round(x, 2) for x in iters]} s); greedy joint action {greedy}; {upd_ms:.3f} ms a train step "
              f"({c['timed_updates']} timed with CUDA events: the batch to the card, both mixers, backward, Adam); "
              f"acting {np.median(act_s) * 1e3:.3f} ms median a step (the agents' Q on the card, one read)")
        if not first or best < 7.5 or greedy["a0"] != 1:
            failures.append(f"qmix: first train step {bool(first)}, best {best}, greedy {greedy}")
        res["qmix"] = {"best_reward": best, "iterations": len(iters), "iteration_s": iters, "update_ms": upd_ms,
                       "act_ms": float(np.median(act_s)) * 1e3, "first_update": first}
    finally:
        algo.cleanup()
    marks["qmix_s"] = time.perf_counter() - t_sec

    # ---- (j3) SlateQ on SlateRecEnv ----
    t_sec = time.perf_counter()
    slateq_cfg = lambda res_device: (SlateQConfig().environment(SlateRecEnv)  # noqa: E731
                                     .training(rollout_steps_per_iter=400, learning_starts=400, train_intensity=2,
                                               epsilon_timesteps=4000)
                                     .debugging(seed=0).resources(device=res_device))
    algo = slateq_cfg(device).build()
    first = {}
    try:
        real_update = algo.update

        def checked_update(batch):
            if not first:
                cpu = slateq_cfg("cpu").build()
                copy_into(cpu.params, host_tree(algo.params))
                copy_into(cpu.target_params, host_tree(algo.target_params))
                tb = {k: torch.from_numpy(np.require(np.asarray(v), requirements="W")) for k, v in batch.items()}

                def run(a):
                    total, aux, q_grads, choice_grads = a.loss_and_grads({k: v.to(a.device) for k, v in tb.items()})
                    return dict(aux, total_loss=total), q_grads + choice_grads

                def control():
                    with tf32_allowed(tslateq):
                        return run(algo)[1]

                first.update(_held_to_cpu(torch, A, "slateq update", lambda: run(algo), lambda: run(cpu), control,
                                          cuda, failures))
                cpu.cleanup()
            return real_update(batch)

        algo.update = checked_update
        iters = []
        for _ in range(c["slateq_iters"]):
            t = time.perf_counter()
            m = algo.step()
            iters.append(time.perf_counter() - t)
        # One batch's greedy slates on the card against the CPU's.
        b = algo.buffer.sample(c["slate_rows"])
        cpu = slateq_cfg("cpu").build()
        copy_into(cpu.params, host_tree(algo.params))
        got, want = algo.greedy_slates(b["user"], b["docs"]), cpu.greedy_slates(b["user"], b["docs"])
        with torch.no_grad():
            u, d = torch.from_numpy(b["user"]), torch.from_numpy(b["docs"])
            q = tslateq.per_item(cpu.params["q"], u, d)
            v = tslateq.per_item(cpu.params["choice"], u, d)
            score = torch.where(q > 0, torch.exp(v) * q, q).numpy()
        cpu.cleanup()
        ties = _f32_near_ties(score, algo.K)
        differ = np.any(got != want, axis=1)
        print(f"slateq greedy slates on the card against the CPU ({len(got)} replay rows): {int(differ.sum())} rows "
              f"differ, {int(ties.sum())} rows hold a near-tie (two of the top {algo.K + 1} scores within 8 f32 "
              f"ulps), {int((differ & ~ties).sum())} rows differ without one (bar 0)")
        if np.any(differ & ~ties):
            failures.append(f"slateq: {int((differ & ~ties).sum())} greedy slates on the card part from the CPU's")
        batches = [algo.buffer.sample(algo._algo_config.train_batch_size) for _ in range(c["timed_updates"])]
        it = iter(batches)
        upd_ms = _event_ms(torch, cuda, lambda: real_update(next(it)), c["timed_updates"])
        obs = [algo._split_obs(np.asarray(algo.env.reset(seed=s)[0], np.float32)) for s in range(c["act_steps"])]
        t = time.perf_counter()
        for user, docs in obs:
            algo.greedy_slates(user[None], docs[None])
        act_ms = (time.perf_counter() - t) / len(obs) * 1e3
        print(f"slateq on {card} (SlateRecEnv: 10 candidates, slates of 2, hiddens (64, 64), batch 64): "
              f"{c['slateq_iters']} iterations of 400 env steps in {[round(x, 2) for x in iters]} s "
              f"({[round(400 / x) for x in iters]} env steps/s; {algo._updates} updates from step 400); "
              f"{upd_ms:.3f} ms an update ({c['timed_updates']} timed with CUDA events: the batch to the card, the "
              f"target's greedy slates, both heads, backward, two Adams); {act_ms:.3f} ms a greedy acting step "
              f"(host clock: the obs to the card, both heads over 10 candidates, the top-k, one read); metrics {m}")
        if not first or not _finite(m):
            failures.append(f"slateq: first update {bool(first)}, metrics {m}")
        res["slateq"] = {"iteration_s": iters, "updates": algo._updates, "update_ms": upd_ms, "act_ms": act_ms,
                         "first_update": first, "greedy_rows": len(got), "greedy_rows_differ": int(differ.sum()),
                         "greedy_near_ties": int(ties.sum()), "total_loss": m.get("total_loss")}
    finally:
        algo.cleanup()
    marks["slateq_s"] = time.perf_counter() - t_sec

    # ---- (j4) ES and ARS on CartPole-v1, 2 CPU worker actors each ----
    t_sec = time.perf_counter()
    built = _build_together({
        "es": ESConfig().environment("CartPole-v1").rollouts(num_rollout_workers=2)
        .training(episodes_per_batch=16, stepsize=0.02, noise_stdev=0.05, episode_horizon=200, eval_episodes=3,
                  model_hiddens=(16,)).debugging(seed=0).resources(device=device),
        "ars": ARSConfig().environment("CartPole-v1").rollouts(num_rollout_workers=2)
        .training(episodes_per_batch=16, num_top_directions=8, noise_stdev=0.05, stepsize=0.05, episode_horizon=500,
                  eval_episodes=3).debugging(seed=0).resources(device=device),
    })
    try:
        for name, algo in built.items():
            iters, steps = [], []
            for _ in range(c["es_iters"]):
                r = algo.step()
                iters.append(r["time_this_iter_s"])
                steps.append(r["timesteps_total"] - sum(steps))
            obs = np.random.default_rng(3).normal(size=(c["act_obs"], 4)).astype(np.float32)
            actions = [algo.compute_single_action(o) for o in obs]
            cpu = RLModule(algo.module_spec, device="cpu").requires_grad_(False)
            cpu.load_params(tes._unflatten(algo.flat, algo._template, algo._shapes))
            x = obs
            if name == "ars" and getattr(algo, "_obs_mean_cur", None) is not None:
                x = ((obs - algo._obs_mean_cur) / (algo._obs_std_cur + 1e-8)).astype(np.float32)
            with torch.no_grad():
                module = algo._act_module
                with tlearner.full_f32(algo.device):
                    on_card = module(torch.from_numpy(x).to(algo.device))[0].cpu()
                on_host = cpu(torch.from_numpy(x))[0]
            rel = float((on_card - on_host).abs().max() / on_host.abs().max().clamp_min(1e-30))
            same = actions == on_host.argmax(-1).tolist()
            rates = [n / s for n, s in zip(steps, iters)]
            print(f"{name} on {card} (CartPole-v1, 2 CPU worker actors pinned to the host, 16 antithetic pairs): "
                  f"{c['es_iters']} iterations in {[round(x, 2) for x in iters]} s ({[round(x) for x in rates]} env "
                  f"steps/s, {steps} env steps); reward {r['episode_reward_mean']}; "
                  f"compute_single_action on the card against the CPU forward on {len(obs)} observations: actions "
                  f"equal {same}, logits rel {rel:.1e} (bar {RLLIB_ATARI_RTOL})")
            if not same or not rel <= RLLIB_ATARI_RTOL or not all(n > 0 for n in steps):
                failures.append(f"{name}: actions equal {same}, logits rel {rel}, env steps {steps}")
            res[name] = {"iteration_s": iters, "env_steps": steps, "env_steps_per_s": rates,
                         "reward": r["episode_reward_mean"], "act_actions_equal": same, "act_logits_rel": rel}
    finally:
        for algo in built.values():
            algo.cleanup()
    marks["es_ars_s"] = time.perf_counter() - t_sec

    # ---- (j5) LinUCB and LinTS: numpy on the host, nothing on the card ----
    # In a process that sees no card (CUDA_VISIBLE_DEVICES empty) and cannot
    # import gymnasium: there they cannot launch anything on a card.
    t_sec = time.perf_counter()
    code = ("import json, sys\n"
            "sys.modules['gymnasium'] = None\n"
            "import chip_smoke\n"
            f"print(json.dumps(chip_smoke.bandits_on_the_host({c['bandit_iters']})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(os.path.abspath(__file__)),
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        failures.append(f"bandits: the host-only process exited {out.returncode}: {out.stderr[-2000:]}")
    else:
        bandits = json.loads(out.stdout.strip().splitlines()[-1])
        for name, r in bandits["algorithms"].items():
            print(f"{name} (numpy, in a process with no card visible and no gymnasium: "
                  f"torch.cuda.is_available() {bandits['cuda_available']}): mean reward by iteration "
                  f"{r['mean_reward']} (bar > 0.8 at the last), greedy {r['greedy']}")
            if not r["mean_reward"][-1] > 0.8 or r["greedy"] != [0, 1] or bandits["cuda_available"]:
                failures.append(f"{name}: {r}, cuda available {bandits['cuda_available']}")
        res["bandits"] = bandits
    marks["bandits_s"] = time.perf_counter() - t_sec
    res["sections_s"] = marks
    return res


def profiler_probe(torch, n) -> dict:
    """ROADMAP O3: ``n`` adds of 2^20 f32 under torch.profiler (CPU and CUDA
    activities), on this thread and on a fresh one; the device events, and
    those whose name holds "add" (``n`` when the profiler sees the card),
    counted in each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device="cuda")
    out = {}

    def run(where):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                x.add(1.0)
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        out[where] = {"add_kernels": sum("add" in e.name.lower() for e in device), "device_events": len(device)}

    run("this_thread")
    t = threading.Thread(target=run, args=("fresh_thread",))
    t.start()
    t.join()
    return out


def rllib_mcts(torch, rt, card, device, failures) -> dict:
    """Section (k) of the rllib phase, in its cluster: AlphaZero,
    LeelaChessZero and the AlphaStar league at the reference tests' configs
    (RLLIB_MCTS), then the profiler probe. Returns their numbers; appends to
    ``failures``."""
    from unittest import mock

    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.rllib import AlphaStarConfig, AlphaZeroConfig, LeelaChessZeroConfig
    from ray_tpu_torch.rllib.algorithms.alpha_star import alpha_star as tas
    from ray_tpu_torch.rllib.algorithms.alpha_zero import alpha_zero as taz
    from ray_tpu_torch.rllib.algorithms.leela_chess_zero import leela_chess_zero as tlc0
    from ray_tpu_torch.rllib.core.rl_module import copy_into, host_tree
    from ray_tpu_torch.rllib.env.board_env import TicTacToeEnv
    from ray_tpu_torch.rllib.env.two_player import TwoPlayerMatrixEnv, scripted_biased_policy

    c = RLLIB_MCTS
    cuda = device == "cuda"
    res, marks = {}, {}

    def tf32_allowed(module):
        """The module's computation with its full-f32 scope taken away: TF32
        as the process has it (the control)."""
        return mock.patch.object(module, "full_f32", lambda device: contextlib.nullcontext())

    def checked_first(label, module, algo, cpu_factory, first, run):
        """Hold ``run(algo)``'s first call on the card to ``run(cpu)`` on a
        CPU twin holding the same weights."""
        cpu = cpu_factory()
        first.update(_held_to_cpu(torch, A, label, lambda: run(algo), lambda: run(cpu),
                                  lambda: control_grads(module, algo, run), cuda, failures))
        cpu.cleanup()

    def control_grads(module, algo, run):
        with tf32_allowed(module):
            return run(algo)[1]

    def timed_calls(store, fn):
        def timed(*args):
            t = time.perf_counter()
            out = fn(*args)
            store.append(time.perf_counter() - t)
            return out

        return timed

    # ---- (k1) AlphaZero on CartPole-v1 ----
    t_sec = time.perf_counter()
    az_cfg = lambda d: (AlphaZeroConfig().environment("CartPole-v1")  # noqa: E731
                        .training(num_sims=25, episodes_per_iter=3, updates_per_iter=30, horizon=200, lr=5e-3,
                                  temperature_timesteps=1500).debugging(seed=0).resources(device=d))
    algo = az_cfg(device).build()
    first, expand_s, play = {}, [], {"s": 0.0, "steps": 0}
    try:
        real_update, real_predict, real_play = algo.update, algo._predict, algo._self_play_episode

        def az_twin():
            cpu = az_cfg("cpu").build()
            cpu.module.load_params(algo.module.get_params())
            return cpu

        def checked(batch):
            if not first:
                checked_first("alpha_zero update", taz, algo, az_twin, first, lambda a: a.loss_and_grads(batch))
            return real_update(batch)

        def played():
            t, n = time.perf_counter(), algo._timesteps_total
            out = real_play()
            play["s"] += time.perf_counter() - t
            play["steps"] += algo._timesteps_total - n
            return out

        algo.update, algo._predict, algo._self_play_episode = checked, timed_calls(expand_s, real_predict), played
        iters, rewards = [], []
        for _ in range(c["iters"]):
            t = time.perf_counter()
            r = algo.step()
            iters.append(time.perf_counter() - t)
            rewards.append(r["episode_reward_mean"])
        obs = np.asarray(algo.env.reset(seed=0)[0], np.float32)
        ev_ms = _event_ms(torch, cuda, lambda: real_predict(obs), c["timed"])
        batches = [algo._replay_batch() for _ in range(c["timed_updates"])]
        it = iter(batches)
        upd_ms = _event_ms(torch, cuda, lambda: real_update(next(it)), c["timed_updates"])
        wall_ms = float(np.median(expand_s)) * 1e3
        rate = play["steps"] / play["s"]
        print(f"alpha_zero on {card} (CartPole-v1, 25 simulations a step, hiddens (64, 64), batch 128): "
              f"{c['iters']} iterations in {[round(x, 2) for x in iters]} s, rewards {rewards}; self-play "
              f"{play['steps']} env steps at {rate:.1f} env steps/s ({len(expand_s)} network calls); one search "
              f"expansion's forward and read {wall_ms:.3f} ms median by the host clock, {ev_ms:.3f} ms by CUDA "
              f"events ({c['timed']} calls); {upd_ms:.3f} ms an update ({c['timed_updates']} timed with CUDA events: "
              f"the batch to the card, forward, backward, Adam); metrics {r}")
        if not first or not _finite(r):
            failures.append(f"alpha_zero: first update {bool(first)}, metrics {r}")
        res["alpha_zero"] = {"iteration_s": iters, "rewards": rewards, "self_play_env_steps": play["steps"],
                             "self_play_env_steps_per_s": rate, "expand_ms_wall": wall_ms, "expand_ms_events": ev_ms,
                             "network_calls": len(expand_s), "update_ms": upd_ms, "first_update": first,
                             "total_loss": r.get("total_loss")}
    finally:
        algo.cleanup()
    marks["alpha_zero_s"] = time.perf_counter() - t_sec

    # ---- (k2) LeelaChessZero on tic-tac-toe ----
    t_sec = time.perf_counter()
    lc0_cfg = lambda d: (LeelaChessZeroConfig().environment(TicTacToeEnv)  # noqa: E731
                         .training(lr=2e-3, num_sims=25, games_per_iter=8, sgd_iters=6, train_batch_size=128,
                                   model_hiddens=(64, 64)).debugging(seed=0).resources(device=d))
    algo = lc0_cfg(device).build()
    first, expand_s, play = {}, [], {"s": 0.0, "steps": 0}
    try:
        real_update, real_predict, real_play = algo.update, algo._predict, algo._self_play_game

        def lc0_twin():
            cpu = lc0_cfg("cpu").build()
            copy_into(cpu.params, host_tree(algo.params))
            return cpu

        def checked(batch):
            if not first:
                checked_first("lc0 update", tlc0, algo, lc0_twin, first, lambda a: a.loss_and_grads(batch))
            return real_update(batch)

        def played():
            t, n = time.perf_counter(), algo._timesteps_total
            out = real_play()
            play["s"] += time.perf_counter() - t
            play["steps"] += algo._timesteps_total - n
            return out

        algo.update, algo._predict, algo._self_play_game = checked, timed_calls(expand_s, real_predict), played
        iters = []
        for _ in range(c["iters"]):
            t = time.perf_counter()
            r = algo.step()
            iters.append(time.perf_counter() - t)
        flat = [row for game in algo._replay for row in game]
        rng = np.random.default_rng(5)
        rows = [flat[i] for i in rng.integers(0, len(flat), c["lc0_rows"])]
        batch = tlc0.rows_to_batch(rows)
        if not first:  # fewer positions than a batch so far: one update by hand
            algo.update(batch)
        obs = torch.from_numpy(np.stack([row[0] for row in rows]))
        legal = torch.from_numpy(np.stack([row[1] for row in rows]))
        cpu = lc0_twin()
        with torch.no_grad():
            with tlc0.full_f32(algo.device):
                on_card = [t.cpu() for t in tlc0.lc0_forward(algo.params, obs.to(algo.device), legal.to(algo.device))]
            on_host = tlc0.lc0_forward(cpu.params, obs, legal)
        cpu.cleanup()
        fwd = {}
        for name, got, want in zip(("logp", "value", "moves_left"), on_card, on_host):
            keep = legal if name == "logp" else torch.ones_like(got, dtype=torch.bool)
            fwd[name] = float((got - want)[keep].abs().max() / want[keep].abs().max().clamp_min(1e-30))
        n_legal = legal.sum(-1)
        ev_ms = _event_ms(torch, cuda, lambda: real_predict(rows[0][0], rows[0][1]), c["timed"])
        upd_ms = _event_ms(torch, cuda, lambda: real_update(batch), c["timed_updates"])
        wall_ms = float(np.median(expand_s)) * 1e3
        rate = play["steps"] / play["s"]
        print(f"lc0 on {card} (tic-tac-toe, 25 simulations a ply, hiddens (64, 64), batch 128): {c['iters']} "
              f"iterations in {[round(x, 2) for x in iters]} s ({len(flat)} replay positions); self-play "
              f"{play['steps']} plies at {rate:.1f} plies/s ({len(expand_s)} network calls); one search expansion's "
              f"forward and read {wall_ms:.3f} ms median by the host clock, {ev_ms:.3f} ms by CUDA events; "
              f"{upd_ms:.3f} ms an update; the masked forward on the card against the CPU over {len(rows)} positions "
              f"({int(n_legal.min())}-{int(n_legal.max())} legal moves): "
              + ", ".join(f"{k} rel {v:.1e}" for k, v in fwd.items()) + f" (bar {RLLIB_ATARI_RTOL}); metrics {r}")
        if not first or any(not v <= RLLIB_ATARI_RTOL for v in fwd.values()) or ("total_loss" in r and not _finite(r)):
            failures.append(f"lc0: first update {bool(first)}, masked forward {fwd}")
        res["lc0"] = {"iteration_s": iters, "replay_positions": len(flat), "self_play_plies": play["steps"],
                      "self_play_plies_per_s": rate, "expand_ms_wall": wall_ms, "expand_ms_events": ev_ms,
                      "network_calls": len(expand_s), "update_ms": upd_ms, "first_update": first,
                      "masked_forward_rel": fwd, "draw_rate": r.get("draw_rate"), "total_loss": r.get("total_loss")}
    finally:
        algo.cleanup()
    marks["lc0_s"] = time.perf_counter() - t_sec

    # ---- (k3) the AlphaStar league on rock-paper-scissors ----
    t_sec = time.perf_counter()
    as_cfg = lambda d: (AlphaStarConfig().environment(TwoPlayerMatrixEnv, env_config={"rounds": 24})  # noqa: E731
                        .training(lr=5e-3, entropy_coeff=0.003, episodes_per_slot=6, self_play_fraction=0.2,
                                  snapshot_interval=8, snapshot_min_winrate=0.55, model_hiddens=(32,),
                                  scripted_league_seeds=[("rocky", scripted_biased_policy(3, 0, p=0.8, seed=1))])
                        .debugging(seed=0).resources(device=d))
    algo = as_cfg(device).build()
    first, act_s, seen = {}, [], []
    try:
        real_step, real_sample = algo.a2c_step, algo._sample

        def as_twin():
            cpu = as_cfg("cpu").build()
            for name, slot in cpu.slots.items():
                slot["params"].load_params(algo.slots[name]["params"].get_params())
            return cpu

        def checked(name, batch):
            if not first:
                # The policy loss is a mean of terms that cancel (the
                # advantages normalised to mean 0): its difference is held
                # against the terms' mean magnitude (a2c_loss's
                # policy_terms), the other metrics as they are.
                def run(a):
                    aux, grads, _ = a.a2c_loss_and_grads(name, batch)
                    return {k: v for k, v in aux.items() if k != "policy_loss"}, grads

                cpu = as_twin()
                first.update(_held_to_cpu(torch, A, f"alpha_star {name} a2c step", lambda: run(algo),
                                          lambda: run(cpu), lambda: control_grads(tas, algo, run), cuda, failures))
                got = float(algo.a2c_loss_and_grads(name, batch)[0]["policy_loss"])
                cpu_aux = cpu.a2c_loss_and_grads(name, batch)[0]
                want, scale = float(cpu_aux["policy_loss"]), float(cpu_aux["policy_terms"])
                rel = abs(got - want) / scale
                print(f"alpha_star {name} policy loss on the card against the CPU: {got:.6g} vs {want:.6g}, the "
                      f"difference {abs(got - want):.1e} over the terms' mean magnitude {scale:.4g}: {rel:.1e} "
                      f"(bar {RLLIB_ATARI_RTOL})")
                if not rel <= RLLIB_ATARI_RTOL:
                    failures.append(f"alpha_star: the policy loss parts from the CPU's by {rel} of its terms' scale")
                first["policy_loss_rel_to_terms"] = rel
                cpu.cleanup()
            seen.append((name, batch))
            return real_step(name, batch)

        algo.a2c_step, algo._sample = checked, timed_calls(act_s, real_sample)
        iters = []
        for _ in range(c["iters"]):
            t = time.perf_counter()
            r = algo.step()
            iters.append(time.perf_counter() - t)
        steps = algo._timesteps_total
        module = algo.slots["main"]["params"]
        ev_ms = _event_ms(torch, cuda, lambda: real_sample(module, np.zeros(6, np.float32)), c["timed"])
        name, batch = seen[0]
        upd_ms = _event_ms(torch, cuda, lambda: real_step(name, batch), c["timed_updates"])
        wr = algo.winrate_vs("rocky", "main", episodes=10)
        wall_ms = float(np.median(act_s)) * 1e3
        rate = steps / sum(iters)
        print(f"alpha_star on {card} (rock-paper-scissors, 24 rounds, 3 slots x 6 episodes, hiddens (32,)): "
              f"{c['iters']} iterations in {[round(x, 2) for x in iters]} s, {steps} env steps ({rate:.1f} learner "
              f"env steps/s); acting {wall_ms:.3f} ms median a draw by the host clock (forward, Gumbel draw, one "
              f"read), {ev_ms:.3f} ms by CUDA events; {upd_ms:.3f} ms an A2C step ({len(batch["obs"])} rows: the "
              f"batch to the card, forward, backward, the clip, Adam); main's win-rate against rocky {wr}; {r}")
        if not first or not all(np.isfinite(r[f"{n}/loss"]) for n in algo.slots):
            failures.append(f"alpha_star: first update {bool(first)}, metrics {r}")
        res["alpha_star"] = {"iteration_s": iters, "env_steps": steps, "env_steps_per_s": rate,
                             "act_ms_wall": wall_ms, "act_ms_events": ev_ms, "a2c_step_ms": upd_ms,
                             "first_update": first, "winrate_vs_rocky": wr, "league_size": r["league_size"]}
    finally:
        algo.cleanup()
    marks["alpha_star_s"] = time.perf_counter() - t_sec

    # ---- (k4) the profiler probe (ROADMAP O3) ----
    if cuda:
        probe = profiler_probe(torch, c["probe_adds"])
        print(f"profiler probe (O3): {c['probe_adds']} adds under torch.profiler late in the script: {probe}")
        res["profiler_probe"] = probe
    res["sections_s"] = marks
    return res


def rllib_external(torch, card, device, failures) -> dict:
    """Section (l) of the rllib phase: DQN served over a PolicyServerInput to
    PolicyClient threads, DQN trained on their episodes, and the ``rllib
    train`` CLI in a subprocess (RLLIB_EXTERNAL). Returns the numbers;
    appends to ``failures``."""
    from ray_tpu_torch.rllib import DQNConfig
    from ray_tpu_torch.rllib.env import PolicyClient, PolicyServerInput
    from ray_tpu_torch.rllib.env.cartpole import make

    c = RLLIB_EXTERNAL
    res, marks = {}, {}
    t_sec = time.perf_counter()
    dqn_cfg = lambda d: (DQNConfig().environment("CartPole-v1")  # noqa: E731
                         .training(learning_starts=0, train_batch_size=32, rollout_steps_per_iter=0)
                         .debugging(seed=0).resources(device=d))
    algo = dqn_cfg(device).build()
    server = PolicyServerInput(lambda obs, explore: int(algo.compute_single_action(np.asarray(obs, np.float32))))
    cpu = None
    try:
        get_s, errors = [], []

        def client(i):
            try:
                cl, env = PolicyClient(server.address), make("CartPole-v1")
                for ep in range(c["episodes"]):
                    obs, _ = env.reset(seed=1000 * i + ep)
                    eid = cl.start_episode()
                    while True:
                        t = time.perf_counter()
                        a = cl.get_action(eid, obs)
                        get_s.append(time.perf_counter() - t)
                        obs, r, term, trunc, _ = env.step(int(a))
                        cl.log_returns(eid, r)
                        if term or trunc:
                            cl.end_episode(eid, obs)
                            break
            except Exception as e:  # noqa: BLE001 — reported as a failure below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(c["clients"])]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        wall = time.perf_counter() - t
        batch = server.next_batch(min_episodes=c["clients"] * c["episodes"])
        if errors or batch is None or any(th.is_alive() for th in threads):
            failures.append(f"external: clients failed {errors}, batch {batch is not None}, "
                            f"{sum(th.is_alive() for th in threads)} clients still running")
            return res
        # The served actions against a CPU copy's greedy actions.
        cpu = dqn_cfg("cpu").build()
        cpu.learner.module.load_params(algo.learner.module.get_params())
        want = cpu._greedy(np.asarray(batch["obs"], np.float32))
        differ = int((np.asarray(batch["actions"]).astype(np.int64) != want).sum())
        n0 = algo._updates
        algo.buffer.add(batch)
        algo._timesteps_total += len(batch)
        t = time.perf_counter()
        for _ in range(c["updates"]):
            m = algo._train_once()  # host floats: the learner reads its metrics once an update
        train_s = time.perf_counter() - t
        per = float(np.median(get_s)) * 1e3
        print(f"external on {card}: DQN's compute_single_action served by a PolicyServerInput to {c['clients']} "
              f"PolicyClient threads, {c['clients'] * c['episodes']} episodes of the port's CartPole-v1, "
              f"{len(get_s)} get_action requests in {wall:.2f} s ({len(get_s) / wall:.1f} get_action/s, "
              f"{(2 * len(get_s) + 2 * c['clients'] * c['episodes']) / wall:.1f} HTTP requests/s all told), "
              f"{per:.3f} ms median a get_action (the client's HTTP round trip: one forward on the card and one "
              f"read under the server's policy lock); served actions against the CPU copy's greedy actions: "
              f"{differ} of {len(batch)} differ (bar 0); {algo._updates - n0} updates on the external episodes in "
              f"{train_s:.2f} s, metrics {m}")
        if differ or not all(np.isfinite(v) for v in m.values()) or algo._updates - n0 != c["updates"]:
            failures.append(f"external: {differ} served actions differ, updates {algo._updates - n0}, metrics {m}")
        res["serve"] = {"episodes": c["clients"] * c["episodes"], "get_action_requests": len(get_s), "wall_s": wall,
                        "get_action_per_s": len(get_s) / wall, "get_action_ms_median": per,
                        "get_action_ms_p90": float(np.percentile(get_s, 90)) * 1e3, "actions_differ": differ,
                        "train_updates": c["updates"], "train_s": train_s, "metrics": m}
    finally:
        server.shutdown()
        algo.cleanup()
        if cpu is not None:
            cpu.cleanup()
    marks["serve_s"] = time.perf_counter() - t_sec

    # The `rllib train` CLI in a process of its own, on the card.
    t_sec = time.perf_counter()
    cmd = [sys.executable, "-m", "ray_tpu_torch.rllib", "train", "--run", "PPO", "--env", "CartPole-v1",
           "--stop-iters", "1"]
    if device != "cuda":
        cmd += ["--config", json.dumps({"device": device, "num_rollout_workers": 1, "train_batch_size": 400})]
    out = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
                         timeout=c["cli_timeout"])
    cli_s = time.perf_counter() - t_sec
    tail = out.stdout.strip().splitlines()[-2:]
    print(f"cli: {' '.join(cmd[1:])} exited {out.returncode} in {cli_s:.1f} s; its last lines {tail}")
    if out.returncode != 0 or not any(line.startswith("iter 1:") for line in tail):
        failures.append(f"cli: exit {out.returncode}: {out.stderr[-2000:]}")
    res["cli"] = {"returncode": out.returncode, "s": cli_s, "last_lines": tail}
    marks["cli_s"] = cli_s
    res["sections_s"] = marks
    return res


def f32_kernel_rows(torch, A, card, counts, label, shape, kernels, calls, replays, iters):
    """Rows of the kernels line for the f32 functions `kernels` at one shape
    (B, T, H, D; causal, the forward with LSE), named "<kernel>_<label>":
    each kernel's device ms (a CUDA graph of `calls` calls, _graph_ms) and
    ms a call (`iters` calls between events, host code included), beside its
    plain version and SDPA in f32 timed the same two ways, and its bound at
    the f32-accurate rate of its route (F32_PEAKS). `counts` are the launches
    of the path that runs them."""
    import torch.nn.functional as F

    B, T, H, D = shape["B"], shape["T"], shape["H"], shape["D"]
    q, k, v, dout = _inputs(torch, 300, torch.float32, B, T, T, H, D)
    scale = D**-0.5
    out, lse = A.flash_fwd_cuda(q, k, v, True, scale, 0, save_lse=True)
    delta = (dout * out).sum(-1).transpose(1, 2).contiguous()
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v, dout))
    # SDPA's backward runs on the stream its forward ran on: one side stream
    # for that forward, the backward's graph capture and its timed calls.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    launch = {"flash_fwd": lambda: A.flash_fwd_cuda(q, k, v, True, scale, 0, save_lse=True),
              "flash_bwd_dkv": lambda: A.flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, True, scale, 0),
              "flash_bwd_dq": lambda: A.flash_bwd_dq_cuda(q, k, v, dout, lse, delta, True, scale, 0)}
    plain = {"fwd": lambda: A._plain_flash_fwd(q, k, v, True, scale, 0),
             "bwd": lambda: A._plain_flash_bwd(q, k, v, out, lse, dout, True, scale, 0)}
    library = {"fwd": sdpa_fwd, "bwd": lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)}
    plain_ms = {w: _graph_ms(torch, fn, max(1, calls // 5), replays) for w, fn in plain.items()}
    lib_ms = {"fwd": _graph_ms(torch, library["fwd"], calls, replays),
              "bwd": _graph_ms(torch, library["bwd"], calls, replays, stream=side)}
    lib_call_ms = {"fwd": _time_ms(torch, library["fwd"], iters)}
    with torch.cuda.stream(side):
        lib_call_ms["bwd"] = _time_ms(torch, library["bwd"], iters)
    pairs = B * H * T * (T + 1) // 2
    tensor, vec = B * T * H * D * 4, B * H * T * 4  # one f32 [B, T, H, D] tensor; one f32 [B, H, T] row vector
    work = {  # kernel: (FLOPs, bytes, which plain and library call, what they compute)
        "flash_fwd": (4 * D * pairs, 4 * tensor + vec, "fwd", ("out+lse", "out")),  # QK^T, PV | q k v -> out, lse
        "flash_bwd_dkv": (8 * D * pairs, 6 * tensor + 2 * vec, "bwd", ("dq+dk+dv", "dq+dk+dv")),  # S, dP, dV, dK
        "flash_bwd_dq": (6 * D * pairs, 5 * tensor + 2 * vec, "bwd", ("dq+dk+dv", "dq+dk+dv")),  # S, dP, dQ
    }
    sources = {"flash_fwd": ("flash_fwd.cu", 57), "flash_bwd_dkv": ("flash_bwd.cu", 320),
               "flash_bwd_dq": ("flash_bwd.cu", 366)}
    rows = []
    for kernel in kernels:
        flops, nbytes, which, (plain_covers, lib_covers) = work[kernel]
        ms, call_ms = _graph_ms(torch, launch[kernel], calls, replays), _time_ms(torch, launch[kernel], iters)
        t_ops, t_bytes = flops / F32_PEAKS[kernel] * 1e3, nbytes / PEAK_BYTES * 1e3
        row = {"name": f"{kernel}_{label}", "kernel": kernel, "route": "cuda", "design": F32_DESIGNS[kernel],
               "source": f"ray_tpu_torch/ops/csrc/{sources[kernel][0]}",
               "replaces": f"ray_tpu/ops/attention.py:{sources[kernel][1]}",
               "shape": f"f32 B{B} T{T} H{H} D{D} causal" + (", LSE" if kernel == "flash_fwd" else ""),
               "launches": counts[kernel], "max_abs_err": None, "rel_l2_err": None, "ms": ms, "call_ms": call_ms,
               "plain_ms": plain_ms[which], "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": lib_ms[which],
               "library_call_ms": lib_call_ms[which], "plain_covers": plain_covers, "library_covers": lib_covers}
        rows.append(row)
        print(f"{kernel} f32 ({row['shape']}) on {card}: {ms:.4f} ms on the device, {call_ms:.4f} ms a call "
              f"(bound {row['bound_ms']:.5f} ms by {row['bound_by']}: {flops / 1e6:.1f} MFLOP at "
              f"{F32_PEAKS[kernel] / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.2f} MB; {row['bound_ms'] / ms:.1%} of bound); "
              f"plain {plain_ms[which]:.4f} ms ({plain_covers}); library (SDPA, f32) {lib_ms[which]:.4f} ms on the "
              f"device, {lib_call_ms[which]:.4f} ms a call ({lib_covers})", flush=True)
    torch.cuda.synchronize()
    del q, k, v, dout, out, lse, delta, qt, kt, vt, dot, ot
    torch.cuda.empty_cache()
    return rows


def rllib_phase(torch, card, device="cuda", sizes=None):
    """RLlib on the card (phase 15): (a) PPO on CartPole-v1, CPU rollout
    workers and one learner actor holding the card; (b) the learner at the
    Atari module's shape in this process, against the same update on the
    CPU; (c) the Decision Transformer, its attention on the flash kernels.
    Returns (the flash kernels' launches in the DT run, the kernels line's
    rows for the three f32 kernels at DT's shape and at the main path's:
    none on the CPU)."""
    _phase("rllib")
    import ray_tpu_torch as rt
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.rllib import DTConfig, PPOConfig
    from ray_tpu_torch.rllib.algorithms.dt.dt import dt_loss
    from ray_tpu_torch.rllib.algorithms.ppo.ppo import ppo_loss
    from ray_tpu_torch.rllib.core.learner import Learner, _host_metrics, global_norm, to_device
    from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec, tree_leaves
    from ray_tpu_torch.rllib.env import Box, Discrete
    from ray_tpu_torch.rllib.policy.sample_batch import (
        ACTIONS, ADVANTAGES, LOGPS, OBS, VALUE_TARGETS, VF_PREDS, SampleBatch,
    )

    cuda = device == "cuda"
    z = dict(RLLIB, **(sizes or {}))
    failures, marks, res = [], {}, {"card": card}
    t0 = time.perf_counter()
    scratch = tempfile.mkdtemp(prefix="chip_smoke_rllib_")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # ---- (a) PPO on CartPole-v1: CPU rollout workers, a learner actor on the card ----
    # 12 CPUs of resource on the card's 8 cores: section (g) holds 8 worker
    # actors and 2 shards at once (mostly idle between their steps).
    rt.init(num_cpus=12, num_gpus=1, object_store_memory=1 << 30)
    pids = set()
    try:
        marks["init_s"] = time.perf_counter() - t0
        t = t_ppo = time.perf_counter()
        cfg = (PPOConfig().environment("CartPole-v1")
               .rollouts(num_rollout_workers=z["workers"], num_envs_per_worker=z["envs"])
               .training(lr=3e-4, train_batch_size=z["train_batch"], sgd_minibatch_size=z["minibatch"],
                         num_sgd_iter=z["sgd_iters"], entropy_coeff=0.01)
               .resources(num_learners=1, num_gpus_per_learner=1, device=device)
               .debugging(seed=0))
        algo = cfg.build()
        learner_info = algo.learner_group.device_info()[0]
        pids |= {w.pid for w in rt._global_node.raylet.workers.values() if w.pid} | {learner_info["pid"]}
        marks["ppo_build_s"] = time.perf_counter() - t
        want_dev = f"cuda:{torch.cuda.current_device()}" if cuda else "cpu"
        print(f"ppo: learner actor pid {learner_info['pid']} on {learner_info['device']} "
              f"({learner_info['device_name']}); {z['workers']} rollout workers x {z['envs']} envs on the CPU")
        if learner_info["device"] != want_dev or learner_info["pid"] == os.getpid() or (
                cuda and learner_info["device_name"] != torch.cuda.get_device_name(0)):
            failures.append(f"ppo: the learner actor is on {learner_info}, not this card in a process of its own")
        # The first round by hand: the learner actor and an in-process learner on
        # this card, from the same weights, through the same minibatches.
        loss_cfg = {"clip_param": cfg.clip_param, "vf_clip_param": cfg.vf_clip_param,
                    "vf_loss_coeff": cfg.vf_loss_coeff, "entropy_coeff": cfg.entropy_coeff}
        w0 = algo.learner_group.get_weights()
        local = Learner(algo.module_spec, ppo_loss, cfg.lr, cfg.grad_clip, cfg.seed, device=device)
        local.set_weights(w0)
        per_worker = max(1, cfg.train_batch_size // z["workers"] // z["envs"])
        t = time.perf_counter()
        batch = SampleBatch.concat_samples(algo.workers.sample(per_worker))
        sample_s = time.perf_counter() - t
        algo._timesteps_total += batch.count
        remote_ms, local_ms, pairs = [], [], []
        for epoch in range(cfg.num_sgd_iter):
            for mb in batch.minibatches(min(cfg.sgd_minibatch_size, batch.count), seed=epoch):
                t = time.perf_counter()
                rm = algo.learner_group.update(mb, loss_cfg)
                remote_ms.append((time.perf_counter() - t) * 1e3)
                t = time.perf_counter()
                lm = local.update(mb, loss_cfg)
                sync()
                local_ms.append((time.perf_counter() - t) * 1e3)
                pairs.append((rm, lm))
        t = time.perf_counter()
        algo.sync_worker_weights()
        sync_ms = (time.perf_counter() - t) * 1e3
        keys = ("total_loss", "grad_norm", "kl")
        first = _close_metrics(*pairs[0], keys, RLLIB_ROUND_RTOL)
        last = _close_metrics(*pairs[-1], keys, RLLIB_ROUND_RTOL)
        w_remote, w_local = algo.learner_group.get_weights(), local.get_weights()
        w_equal = all(np.array_equal(a, b) for a, b in zip(tree_leaves(w_remote), tree_leaves(w_local)))
        print(f"ppo round 1: {batch.count} env steps sampled in {sample_s * 1e3:.1f} ms "
              f"({batch.count / sample_s:.0f} env steps/s), {len(pairs)} minibatch updates of {cfg.sgd_minibatch_size}: "
              f"the learner actor {sum(remote_ms):.1f} ms ({np.median(remote_ms):.2f} ms median a minibatch, the call "
              f"included; its first {remote_ms[0]:.1f} ms), in-process {sum(local_ms):.1f} ms ({np.median(local_ms):.2f} "
              f"ms median; its first {local_ms[0]:.1f} ms); weight sync "
              f"{sync_ms:.1f} ms; on {card}")
        print(f"ppo round 1, the actor against the in-process learner (bar rtol {RLLIB_ROUND_RTOL}): first minibatch "
              + ", ".join(f"{k} {pairs[0][0][k]:.6g} vs {pairs[0][1][k]:.6g} (rel {r:.1e})" for k, (r, _) in first.items())
              + "; last minibatch " + ", ".join(f"{k} rel {r:.1e}" for k, (r, _) in last.items())
              + f"; weights after the round bit-equal: {w_equal}")
        if not all(ok for _, ok in list(first.values()) + list(last.values())):
            failures.append(f"ppo: the learner actor's round parts from the in-process learner's: {first} {last}")
        del local
        # Then train on, through Algorithm.step, to the reference test's bar.
        best, rewards, iter_s = float("-inf"), [], []
        it = 1
        while it < z["ppo_iters"]:
            t = time.perf_counter()
            r = algo.step()
            iter_s.append(time.perf_counter() - t)
            it += 1
            rewards.append(r["episode_reward_mean"])
            best = max(best, r["episode_reward_mean"])
            if best >= z["ppo_bar"]:
                break
        action = algo.compute_single_action(np.zeros(4, np.float32))
        print(f"ppo: episode_reward_mean by iteration {[round(x, 1) for x in rewards]} (iteration 1 is the round "
              f"above); best {best:.1f} after {it} iterations (bar {z['ppo_bar']} within {z['ppo_iters']}); "
              f"{np.median(iter_s):.3f} s median an iteration on {card}; compute_single_action(zeros) = {action}")
        if not best >= z["ppo_bar"]:
            failures.append(f"ppo: best episode_reward_mean {best} under {z['ppo_bar']} in {it} iterations")
        if action not in (0, 1):
            failures.append(f"ppo: compute_single_action gave {action!r}")
        pids |= {w.pid for w in rt._global_node.raylet.workers.values() if w.pid}
        algo.cleanup()
        res["ppo"] = {"env_steps_per_s": batch.count / sample_s, "sample_ms": sample_s * 1e3,
                      "learner_round_ms": sum(remote_ms), "minibatch_update_ms_actor": float(np.median(remote_ms)),
                      "first_update_ms_actor": remote_ms[0], "first_update_ms_in_process": local_ms[0],
                      "minibatch_update_ms_in_process": float(np.median(local_ms)), "weight_sync_ms": sync_ms,
                      "iterations_to_bar": it if best >= z["ppo_bar"] else None, "best_reward": best,
                      "iteration_s_median": float(np.median(iter_s)) if iter_s else None,
                      "first_minibatch_rel": {k: r for k, (r, _) in first.items()}, "weights_equal_after_round": w_equal,
                      "learner": learner_info}
        marks["ppo_s"] = time.perf_counter() - t_ppo
        # (d)-(h) in the same cluster; they launch none of the flash kernels.
        t = time.perf_counter()
        A.reset_launch_counts()
        res["families"] = rllib_families(torch, rt, card, device, failures)
        dg_counts = A.launch_counts()
        res["continuous"] = rllib_continuous(torch, rt, card, device, failures, scratch)
        h_end = A.launch_counts()
        h_counts = {k: h_end[k] - dg_counts[k] for k in h_end}
        t_i = time.perf_counter()
        model_based = rllib_model_based(torch, rt, card, device, failures)
        family_counts = A.launch_counts()
        i_counts = {k: family_counts[k] - h_end[k] for k in family_counts}
        model_based.update(rllib_families_launches=i_counts, section_s=time.perf_counter() - t_i)
        res["model_based"] = model_based
        print("(i): " + json.dumps(model_based))
        t_j = time.perf_counter()
        lighter = rllib_lighter(torch, rt, card, device, failures, scratch)
        j_end = A.launch_counts()
        j_counts = {k: j_end[k] - family_counts[k] for k in j_end}
        family_counts = j_end
        lighter.update(rllib_families_launches=j_counts, section_s=time.perf_counter() - t_j)
        res["lighter"] = lighter
        print("(j): " + json.dumps(lighter))
        t_k = time.perf_counter()
        mcts = rllib_mcts(torch, rt, card, device, failures)
        k_end = A.launch_counts()
        k_counts = {k: k_end[k] - family_counts[k] for k in k_end}
        family_counts = k_end
        mcts.update(rllib_families_launches=k_counts, section_s=time.perf_counter() - t_k)
        res["mcts"] = mcts
        print("(k): " + json.dumps(mcts))
        t_l = time.perf_counter()
        external = rllib_external(torch, card, device, failures)
        l_end = A.launch_counts()
        l_counts = {k: l_end[k] - family_counts[k] for k in l_end}
        family_counts = l_end
        external.update(rllib_families_launches=l_counts, section_s=time.perf_counter() - t_l)
        res["external"] = external
        print("(l): " + json.dumps(external))
        print(f"rllib families: flash kernel launches in this process over sections (d)-(g): {dg_counts}, over "
              f"(h): {h_counts}, over (i): {i_counts}, over (j): {j_counts}, over (k): {k_counts}, over (l): "
              f"{l_counts}")
        if any(family_counts.values()):
            failures.append(f"rllib families: the value, policy-gradient, continuous, model-based, lighter, MCTS "
                            f"and external paths launched {family_counts}")
        pids |= {w.pid for w in rt._global_node.raylet.workers.values() if w.pid}
        marks["families_s"] = time.perf_counter() - t
    finally:
        rt.shutdown()
    deadline = time.monotonic() + 30
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = sorted(p for p in pids if _alive(p))
    print(f"ppo: worker pids {sorted(pids)}, {len(left)} left after shutdown()")
    if left:
        failures.append(f"ppo: worker processes {left} outlived shutdown()")

    # ---- (b) the learner at the Atari module's shape, here, against the CPU ----
    t = time.perf_counter()
    spec = RLModuleSpec.from_spaces(Box(0.0, 1.0, (84, 84, 4)), Discrete(6))
    n, mbs = z["atari_rows"], z["atari_minibatch"]
    rng = np.random.default_rng(7)
    atari = SampleBatch({OBS: rng.random((n, 84, 84, 4), dtype=np.float32), ACTIONS: rng.integers(0, 6, n),
                         LOGPS: (np.log(1 / 6) + rng.normal(0, 0.3, n)).astype(np.float32),
                         VF_PREDS: rng.normal(size=n).astype(np.float32),
                         ADVANTAGES: rng.normal(size=n).astype(np.float32),
                         VALUE_TARGETS: rng.normal(size=n).astype(np.float32)})
    loss_cfg = {"clip_param": 0.2, "vf_clip_param": 10.0, "vf_loss_coeff": 0.5, "entropy_coeff": 0.0}
    on_card = Learner(spec, ppo_loss, 3e-4, 0.5, 0, device=device)
    on_cpu = Learner(spec, ppo_loss, 3e-4, 0.5, 0, device="cpu")
    minibatches = [mb for epoch in range(z["atari_sgd_iters"]) for mb in atari.minibatches(mbs, seed=epoch)]
    # As a user's process would have it: cuDNN's f32 convolutions in TF32 (its
    # default) and TF32 matmuls; the learner's scoped flag must keep its
    # update in full f32 all the same.
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    metric_keys = ("total_loss", "grad_norm", "policy_loss", "vf_loss")

    def flat(grads):
        return torch.cat([g.reshape(-1) for g in grads]).cpu()

    try:
        # The first minibatch's gradients: on the card through the learner (its
        # scoped full f32), on the CPU, and the control on the card with TF32.
        _, _, g_card = on_card.compute_grads(minibatches[0], loss_cfg)
        _, _, g_cpu = on_cpu.compute_grads(minibatches[0], loss_cfg)
        loss_t, metrics_t = ppo_loss(on_card.module, to_device(minibatches[0], on_card.device), spec, loss_cfg)
        g_tf32 = torch.autograd.grad(loss_t, on_card.opt.params)
        tf32 = _host_metrics(metrics_t, loss_t, global_norm(g_tf32))
        grad_gap, tf32_grad_gap = A.mismatch(flat(g_card), flat(g_cpu)), A.mismatch(flat(g_tf32), flat(g_cpu))
        del g_card, g_cpu, g_tf32, loss_t, metrics_t
        got, want = on_card.update(minibatches[0], loss_cfg), on_cpu.update(minibatches[0], loss_cfg)
        close = _close_metrics(got, want, metric_keys, RLLIB_ATARI_RTOL)
        tf32_close = _close_metrics(tf32, want, metric_keys, RLLIB_ATARI_RTOL)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        sync()
        t_round = time.perf_counter()
        for mb in minibatches[1:]:
            on_card.update(mb, loss_cfg)
        sync()
        round_s = time.perf_counter() - t_round
        kinds = None
        if cuda:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                on_card.update(minibatches[0], loss_cfg)
                sync()
            us = {e.key: e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)}
            kinds = _kinds(us, 1, RLLIB_PROFILE_GROUPS) if sum(us.values()) > 0 else None
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    upd_ms = round_s / max(1, len(minibatches) - 1) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**20 if cuda else 0.0
    print(f"atari: RLModuleSpec.from_spaces(Box(0, 1, (84, 84, 4)), Discrete(6)): convs {spec.conv_filters}, "
          f"hiddens {spec.hiddens}; one PPO round on {n} synthetic rows ({atari[OBS].nbytes / 1e6:.0f} MB of frames), "
          f"{len(minibatches)} minibatch updates of {mbs}, the learner on {device} with TF32 switched on around it")
    print(f"atari first minibatch, {device} against the CPU (bar rtol {RLLIB_ATARI_RTOL}): "
          + ", ".join(f"{k} {got[k]:.6g} vs {want[k]:.6g} (rel {r:.1e})" for k, (r, _) in close.items())
          + f"; its {sum(p.numel() for p in on_cpu.opt.params)} gradients rel_l2 {grad_gap['rel_l2']:.1e} "
          f"(bar {RLLIB_ATARI_GRAD_RTOL}), elem {grad_gap['elem']:.1e}")
    print(f"atari control, TF32 allowed on {device} (not through the learner's flag) against the CPU: "
          + ", ".join(f"{k} rel {r:.1e}" for k, (r, _) in tf32_close.items())
          + f"; gradients rel_l2 {tf32_grad_gap['rel_l2']:.1e}, elem {tf32_grad_gap['elem']:.1e}")
    print(f"atari on {card}: {upd_ms:.2f} ms a minibatch update (host clock, the host-to-device copy of its frames "
          f"included), {mbs / upd_ms * 1e3:.0f} samples/s, peak memory {peak:.0f} MiB; device ms of one update by kind: "
          + (", ".join(f"{k} {v:.3f}" for k, v in kinds.items()) if kinds else "not measured"))
    if not all(ok for _, ok in close.values()):
        failures.append(f"atari: the update on {device} parts from the CPU's: {close}")
    if not grad_gap["rel_l2"] <= RLLIB_ATARI_GRAD_RTOL:
        failures.append(f"atari: the gradients on {device} part from the CPU's: rel_l2 {grad_gap['rel_l2']:.2e}")
    if cuda and not tf32_grad_gap["rel_l2"] > RLLIB_ATARI_GRAD_RTOL:
        failures.append(f"atari: the TF32 control's gradients are within the bar (rel_l2 "
                        f"{tf32_grad_gap['rel_l2']:.2e}): the check cannot tell TF32 from full f32")
    res["atari"] = {"minibatch_update_ms": upd_ms, "samples_per_s": mbs / upd_ms * 1e3, "peak_mib": peak,
                    "device_ms_by_kind": kinds, "first_minibatch_rel": {k: r for k, (r, _) in close.items()},
                    "first_minibatch_grad": grad_gap,
                    "tf32_control_rel": {k: r for k, (r, _) in tf32_close.items()},
                    "tf32_control_grad": tf32_grad_gap, "updates": len(minibatches)}
    del on_card, on_cpu, atari, minibatches
    gc.collect()
    marks["atari_s"] = time.perf_counter() - t

    # ---- (c) the Decision Transformer on the flash kernels ----
    t = time.perf_counter()
    data = os.path.join(scratch, "dt_data")
    rows = _dt_expert_data(data, z["dt_episodes"])
    cfg = (DTConfig().environment("CartPole-v1")
           .training(lr=1e-3, train_batch_size=64, context_length=20, updates_per_iter=z["dt_updates"],
                     eval_episodes=3, max_ep_len=200)
           .resources(device=device).debugging(seed=0).offline_data(data))
    algo = cfg.build()
    try:
        # One forward and backward of the loss on the kernels and on their plain
        # versions, on the first training batch (the sampler's state restored).
        state = algo._rng.bit_generator.state
        parts = algo._sample_windows(64, 20)
        algo._rng.bit_generator.state = state
        args = [torch.from_numpy(a).to(device) for a in parts]
        leaves = tree_leaves(algo.params)
        A.reset_launch_counts()
        loss_k = dt_loss(algo.params, *args, cfg.n_heads)
        grads_k = torch.autograd.grad(loss_k, leaves)
        one_update = A.launch_counts()
        with _plain_attention(A):
            loss_p = dt_loss(algo.params, *args, cfg.n_heads)
            grads_p = torch.autograd.grad(loss_p, leaves)
        checks = [("loss", A.mismatch(loss_k.reshape(1), loss_p.reshape(1)))]
        checks += [(f"grad {i} {tuple(g.shape)}", A.mismatch(g, w)) for i, (g, w) in enumerate(zip(grads_k, grads_p))]
        worst = {k: max(m[k] for _, m in checks) for k in ("rel_l2", "elem", "max_abs")}
        over = [f"{what}: {x}" for what, m in checks for x in A.over_tolerance(m, torch.float32)]
        want_one = {k: cfg.n_layers for k in KERNELS} if cuda else {k: 0 for k in KERNELS}
        print(f"dt: {rows} expert rows in {z['dt_episodes']} episodes; f32, batch 64, context 20 (T {3 * 20}), embed "
              f"{cfg.embed_dim}, {cfg.n_layers} layers, {cfg.n_heads} heads (D {cfg.embed_dim // cfg.n_heads}); one "
              f"forward and backward on the kernels against their plain versions: loss {loss_k.item():.6f} vs "
              f"{loss_p.item():.6f}; worst over the loss and {len(grads_k)} gradients "
              + " ".join(f"{k}={v:.2e}" for k, v in worst.items())
              + f" (bars {A.MATCH_TOL[torch.float32]}); launches {one_update} (expected {want_one})")
        if over:
            failures.append("dt: the kernels part from their plain versions: " + "; ".join(over))
        if one_update != want_one:
            failures.append(f"dt: one update launched {one_update}, not {want_one}")
        del grads_k, grads_p, loss_k, loss_p
        # Training to the reference test's bar; every launch counted.
        A.reset_launch_counts()
        best, rewards, n_iter = float("-inf"), [], 0
        for _ in range(z["dt_iters"]):
            r = algo.step()
            n_iter += 1
            rewards.append(r["episode_reward_mean"])
            best = max(best, r["episode_reward_mean"])
            if best >= z["dt_bar"]:
                break
        counts = A.launch_counts()
        eval_steps = int(round(sum(algo._episode_reward_window)))  # CartPole pays 1 a step
        updates = n_iter * z["dt_updates"]
        want = ({"flash_fwd": cfg.n_layers * (updates + eval_steps), "flash_bwd_dkv": cfg.n_layers * updates,
                 "flash_bwd_dq": cfg.n_layers * updates} if cuda else {k: 0 for k in KERNELS})
        print(f"dt: episode_reward_mean by iteration {[round(x, 1) for x in rewards]}; best {best:.1f} after {n_iter} "
              f"iterations (bar {z['dt_bar']} within {z['dt_iters']}); launches {counts} over {updates} updates and "
              f"{eval_steps} evaluation forwards (expected {want})")
        if not best >= z["dt_bar"]:
            failures.append(f"dt: best episode_reward_mean {best} under {z['dt_bar']} in {n_iter} iterations")
        if counts != want:
            failures.append(f"dt: launched {counts}, expected {want}")
        # ms per update, after the run (host clock to a synchronize).
        sync()
        t_upd = time.perf_counter()
        for _ in range(z["dt_timed"]):
            algo.train_step(*algo._sample_windows(64, 20))
        sync()
        dt_ms = (time.perf_counter() - t_upd) / z["dt_timed"] * 1e3
        print(f"dt on {card}: {dt_ms:.2f} ms an update ({z['dt_timed']} updates, the window sampling on the host "
              f"included)")
        res["dt"] = {"update_ms": dt_ms, "iterations_to_bar": n_iter if best >= z["dt_bar"] else None,
                     "best_reward": best, "launches": counts, "one_update_launches": one_update,
                     "kernel_vs_plain_worst": worst}
    finally:
        algo.cleanup()
        shutil.rmtree(scratch, ignore_errors=True)
    marks["dt_s"] = time.perf_counter() - t

    rows = []
    if cuda:
        # The three kernels at DT's shape, as training launches them (f32, the
        # forward with LSE); then the three at the main path's shape, where the
        # operations bound and the bytes bound part.
        # No path runs them at that shape: those rows book no launches.
        rows = f32_kernel_rows(torch, A, card, counts, "dt", DT_SHAPE, KERNELS, calls=50, replays=20, iters=100)
        res["dt"].update(kernel_ms={r["kernel"]: r["ms"] for r in rows},
                         kernel_call_ms={r["kernel"]: r["call_ms"] for r in rows},
                         kernel_plain_ms={r["kernel"]: r["plain_ms"] for r in rows},
                         kernel_sdpa_ms={r["kernel"]: r["library_ms"] for r in rows},
                         kernel_bound_ms={r["kernel"]: r["bound_ms"] for r in rows})
        rows += f32_kernel_rows(torch, A, card, dict.fromkeys(KERNELS, 0), "f32", MAIN, F32_MAIN_KERNELS, calls=5,
                                replays=4, iters=20)
    marks["phase_s"] = time.perf_counter() - t0
    res["sections_s"] = marks
    print("rllib: " + json.dumps(res))
    if failures:
        raise AssertionError("rllib: " + "; ".join(failures))
    return counts, rows, family_counts


def pbt_trainable(config):
    """PBT's trial body in the tune phase (b), a Tune function trainable: the
    flagship (models/transformer.py, weights from ``param_seed``) on
    ``train.torch.get_device()`` (``config["device"]`` where given: the CPU
    rehearsal), AdamW at ``config["lr"]``, trained on one fixed batch (seed
    ``batch_seed``) in chunks of ``chunk`` steps, one reported result a chunk
    (the last loss, the process's flash launch counts, tokens/s, peak
    memory). Every second iteration it writes a directory checkpoint under
    ``ckpt_root``: the parameters and AdamW's state through ``torch.save``,
    with two bit checksums of every tensor and the loss of a forward at those
    weights in its metadata. Where ``tune.get_checkpoint()`` returns one at
    the start, it loads it onto the device, checks every tensor's checksums
    against the donor's, runs that forward again, and reports both with its
    first result (``restored``). Each result also carries the steps and the
    forwards outside a step (checkpoints', the restore's) that this process
    ran, which its launch counts must match. It returns after iteration
    ``iters`` (after one chunk where a restore starts it there), so no
    chunk runs past its last result; only an exploited trial's process is
    killed in the chunk it runs ahead of the controller, whose launches no
    result reports."""
    import torch

    from ray_tpu_torch import tune
    from ray_tpu_torch.air.checkpoint import Checkpoint
    from ray_tpu_torch.models import transformer as tt
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.train.torch import get_device

    fn_start = time.time()
    A.reset_launch_counts()
    device = torch.device(config["device"]) if config.get("device") else get_device()
    cuda = device.type == "cuda"
    if not cuda:
        torch.set_num_threads(1)  # trials beside each other on the host's cores
    cfg = tt.TransformerConfig(**config["model"], dtype=getattr(torch, config["dtype"]))
    params = tt.init_params(cfg, seed=config.get("param_seed", 0), device=device)
    leaves = tt.param_leaves(params)
    opt = tt.adamw(params, config["lr"])
    step = tt.make_train_step(cfg, opt, device=device)
    g = torch.Generator(device=device).manual_seed(config.get("batch_seed", 1))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (config["batch"], config["seq"] + 1), generator=g,
                                     device=device)}

    def state_tensors():
        """The parameters, then each one's AdamW state, in a fixed order."""
        out = list(leaves)
        for p in leaves:
            st = opt.state.get(p, {})
            out += [st[k] for k in sorted(st) if torch.is_tensor(st[k])]
        return out

    counted = {"steps": 0, "forwards": 0}

    def forward_loss():
        counted["forwards"] += 1
        with torch.no_grad():
            return float(tt.loss_fn(params, batch, cfg))

    it, restored = 0, None
    ckpt = tune.get_checkpoint()
    if ckpt is not None:
        meta = ckpt.metadata
        t0 = time.perf_counter()
        state = torch.load(os.path.join(meta["dir"], "state.pt"), map_location=device, weights_only=True)
        with torch.no_grad():
            for p, w in zip(leaves, state["params"]):
                p.copy_(w)
        opt.load_state_dict(state["opt"])
        for group in opt.param_groups:
            group["lr"] = config["lr"]  # the explored learning rate
        if cuda:
            torch.cuda.synchronize(device)
        load_s = time.perf_counter() - t0
        del state
        sums = [_bits_checksum(torch, t) for t in state_tensors()]
        loss = forward_loss()
        it = int(meta["iteration"])
        restored = {"donor_dir": meta["dir"], "bit_equal": sums == meta["sums"], "tensors": len(sums),
                    "loss": loss, "donor_loss": meta["loss"], "load_s": load_s, "lr": config["lr"],
                    "fn_start": fn_start}
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    tokens = config["batch"] * config["seq"] * config["chunk"]
    while it < config["iters"] or restored is not None:  # a restore is reported, whatever its iteration
        t0 = time.perf_counter()
        for _ in range(config["chunk"]):
            loss = step(params, batch)
        loss = loss.item()
        counted["steps"] += config["chunk"]
        chunk_s = time.perf_counter() - t0
        it += 1
        metrics = {"loss": loss, "iteration": it, "pid": os.getpid(),
                   "tokens_per_sec": tokens / chunk_s, "chunk_s": chunk_s, "lr": config["lr"],
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0,
                   "device_name": torch.cuda.get_device_name(device) if cuda else "cpu"}
        if restored is not None:
            metrics["restored"], restored = restored, None
        ckpt = None
        if it % 2 == 0:
            t0 = time.perf_counter()
            path = os.path.join(config["ckpt_root"], f"ckpt_{os.getpid()}_{it}")
            os.makedirs(path)
            sums = [_bits_checksum(torch, t) for t in state_tensors()]
            torch.save({"params": leaves, "opt": opt.state_dict()}, os.path.join(path, "state.pt"))
            ckpt = Checkpoint.from_directory(path)
            ckpt.metadata.update(dir=path, iteration=it, sums=sums, loss=forward_loss())
            metrics.update(save_s=time.perf_counter() - t0, ckpt_iteration=it,
                           ckpt_bytes=os.path.getsize(os.path.join(path, "state.pt")))
        metrics.update(launches=A.launch_counts(), steps=counted["steps"], forwards=counted["forwards"])
        tune.report(metrics, checkpoint=ckpt)


def _observed_pbt_class():
    """PopulationBasedTraining that records, in the driver, every result it
    decides on, each exploit (donor, checkpoint metadata, the two learning
    rates, the time) and each restart (exploit to the restarted trial's first
    result), and deletes the trials' checkpoint directories that no trial
    holds any more (each writer's newest stays: its save may be in flight)."""
    from ray_tpu_torch.tune.schedulers.pbt import EXPLOIT, PopulationBasedTraining

    class ObservedPBT(PopulationBasedTraining):
        def __init__(self, *args, ckpt_root, **kwargs):
            super().__init__(*args, **kwargs)
            self.ckpt_root = ckpt_root
            self.results, self.exploits, self.restarts, self.pruned = [], [], [], 0
            self._exploited_at: dict = {}

        def _record(self, trial, result):
            now = time.time()
            self.results.append((trial.trial_id, dict(result)))
            if trial.trial_id in self._exploited_at:
                at = self._exploited_at.pop(trial.trial_id)
                # (exploit to the first result, exploit to the restored function's start)
                start = (result.get("restored") or {}).get("fn_start", now)
                self.restarts.append((trial.trial_id, (now - at, start - at), dict(result)))
            return now

        def on_trial_complete(self, controller, trial, result):
            # The result that meets the stop goes here, not to on_trial_result.
            self._record(trial, result)
            super().on_trial_complete(controller, trial, result)
            self._prune(controller)

        def on_trial_result(self, controller, trial, result):
            now = self._record(trial, result)
            decision = super().on_trial_result(controller, trial, result)
            if decision == EXPLOIT:
                donor, new_config = self.pending_exploit[trial.trial_id]
                self.exploits.append({"trial": trial.trial_id, "donor": donor.trial_id,
                                      "iteration": result.get("training_iteration"),
                                      "donor_meta": {k: donor.checkpoint.metadata[k] for k in ("dir", "iteration",
                                                                                             "loss", "sums")},
                                      "lr_from": trial.config["lr"], "lr_to": new_config["lr"]})
                self._exploited_at[trial.trial_id] = now
            self._prune(controller)
            return decision

        def _prune(self, controller):
            held = {t.checkpoint.metadata.get("dir") for t in controller.trials if t.checkpoint is not None}
            written = {}
            for name in os.listdir(self.ckpt_root):
                _, pid, it = name.split("_")
                written.setdefault(pid, []).append((int(it), name))
            for versions in written.values():
                for _, name in sorted(versions)[:-1]:
                    path = os.path.join(self.ckpt_root, name)
                    if path not in held:
                        shutil.rmtree(path, ignore_errors=True)
                        self.pruned += 1

    return ObservedPBT


def _learner_devices_callbacks():
    """RLlib callbacks that add each learner's device, process and card to
    every training result (the tune phase (c) reads them from the trials)."""
    from ray_tpu_torch.rllib.callbacks import DefaultCallbacks

    class LearnerDevices(DefaultCallbacks):
        def on_train_result(self, *, algorithm, result):
            result["learner_devices"] = algorithm.learner_group.device_info()

    return LearnerDevices


@contextlib.contextmanager
def _controller_host_time(totals: dict):
    """Adds the seconds the Tune controller spends handling results
    (``_on_result``: the scheduler, the loggers, the next task) and saving the
    experiment's state (with each new checkpoint's copy) to ``totals``."""
    from ray_tpu_torch.tune.execution.tune_controller import TuneController

    originals = {name: getattr(TuneController, name) for name in ("_on_result", "save_experiment_state")}

    def timed(name, fn):
        def wrapper(self, *args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(self, *args, **kwargs)
            finally:
                totals[name] = totals.get(name, 0.0) + time.perf_counter() - t
                totals[name + "_calls"] = totals.get(name + "_calls", 0) + 1
        return wrapper

    for name, fn in originals.items():
        setattr(TuneController, name, timed(name, fn))
    try:
        yield totals
    finally:
        for name, fn in originals.items():
            setattr(TuneController, name, fn)


def tune_phase(torch, card, main_first_loss, trainer_raw_ms, device="cuda", model=None, sizes=None):
    """Tune on the card (phase 16), in a cluster of its own: (a) Tuner over
    TorchTrainer, two trials sharing the card; (b) PBT of the flagship at full
    width with directory checkpoints; (c) Tuner over PPO with each trial's
    learner on the card. Returns the flash launches the trials made, per
    kernel."""
    _phase("tune")
    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.air.config import RunConfig, ScalingConfig
    from ray_tpu_torch.rllib import PPO
    from ray_tpu_torch.train.flagship_loop import train_loop
    from ray_tpu_torch.train.torch import TorchTrainer
    from ray_tpu_torch.tune.search import BasicVariantGenerator

    cuda = device == "cuda"
    z = dict(TUNE, **(sizes or {}))
    model = model or dict(vocab_size=32000, d_model=1024, n_layers=8, n_heads=8, n_kv_heads=8, d_ff=2816,
                          max_seq_len=1024, remat=False, fused_loss=False, scan_unroll=8)
    L = model["n_layers"]
    batch, seq, dtype = z.get("batch", MAIN["B"]), z.get("seq", MAIN["T"]), z.get("dtype", "bfloat16")
    failures, marks, res = [], {}, {"card": card}
    counts = dict.fromkeys(KERNELS, 0)
    t0 = time.perf_counter()
    storage = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    rt.init(num_cpus=z["num_cpus"], num_gpus=1, object_store_memory=1 << 30)
    pids = set()

    def note_workers():
        pids.update(w.pid for w in rt._global_node.raylet.workers.values() if w.pid)

    try:
        marks["init_s"] = time.perf_counter() - t0
        # ---- (a) Tuner(TorchTrainer): two trials share the card ----
        t = time.perf_counter()
        config = dict(model=model, dtype=dtype, batch=batch, seq=seq, param_seed=0, batch_seed=1,
                      **TRAINER_MOE)
        trainer = TorchTrainer(
            train_loop, train_loop_config=config,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=cuda,
                                         resources_per_worker={"GPU": 0.5} if cuda else None),
            run_config=RunConfig(storage_path=os.path.join(storage, "trainer")))
        grid = tune.Tuner(trainer, param_space={"train_loop_config": {"param_seed": tune.grid_search([0, 1])}},
                          tune_config=tune.TuneConfig(metric="loss", mode="min")).fit()
        fit_done = time.time()
        note_workers()
        marks["trainer_s"] = time.perf_counter() - t
        fit_start = fit_done - marks["trainer_s"]
        steps_per = config["warmup"] + 2 * config["rounds"] * config["chunk"] + config["profile_steps"]
        rows = sorted(((r.config["train_loop_config"]["param_seed"], r) for r in grid), key=lambda x: x[0])
        res["trainer"] = []
        for seed, r in rows:
            m = r.metrics
            pids.add(m.get("pid"))
            for n in KERNELS:
                counts[n] += m.get("launches", {}).get(n, 0)
            rec = {"param_seed": seed, "error": r.error, "device_name": m.get("device_name"),
                   "launches": m.get("launches"), "steps": m.get("steps"), "first_loss": m.get("first_loss"),
                   "tokens_per_sec_framework": m.get("tokens_per_sec_framework"),
                   "tokens_per_sec_raw": m.get("tokens_per_sec_raw"),
                   "fit_to_result_s": m.get("end_time", fit_done) - fit_start,
                   "interval": [m.get("start_time"), m.get("end_time")]}
            res["trainer"].append(rec)
            print(f"tune trainer, param_seed {seed}: {'error ' + r.error if r.error else 'done'}; worker pid "
                  f"{m.get('pid')} on {m.get('device_name')}; {m.get('steps')} steps, launches {m.get('launches')}; "
                  f"first loss {m.get('first_loss')}; framework {m.get('tokens_per_sec_framework') or 0:.0f} "
                  f"tokens/s, raw {m.get('tokens_per_sec_raw') or 0:.0f} tokens/s, sharing the card (the trainer "
                  f"phase alone: raw {batch * seq / trainer_raw_ms * 1e3 if trainer_raw_ms else float('nan'):.0f} "
                  f"tokens/s); fit() to its last step {rec['fit_to_result_s']:.2f} s")
            if r.error or not m.get("launches"):
                failures.append(f"(a) the param_seed {seed} trial did not finish: {r.error}")
                continue
            if cuda and m["device_name"] != torch.cuda.get_device_name(0):
                failures.append(f"(a) trial {seed} ran on {m['device_name']!r}")
            want = {n: m["steps"] * L for n in KERNELS} if cuda else dict.fromkeys(KERNELS, 0)
            if m["steps"] != steps_per or m["launches"] != want:
                failures.append(f"(a) trial {seed}: {m['steps']} steps launched {m['launches']}, not {L} a step")
        ok = [rec for rec in res["trainer"] if not rec["error"] and rec["interval"][0]]
        if len(ok) == 2:
            (s0, e0), (s1, e1) = ok[0]["interval"], ok[1]["interval"]
            overlap = min(e0, e1) - max(s0, s1)
            res["trainer_overlap_s"] = overlap
            print(f"tune trainer: the two trials' loops (the flagship's set-up on the card to its last step) "
                  f"overlap by {overlap:.2f} s ({e0 - s0:.2f} s and {e1 - s1:.2f} s long)")
            if overlap <= 0:
                failures.append(f"(a) the two trials' loops do not overlap in time ({overlap:.2f} s)")
            rel = abs(ok[0]["first_loss"] - main_first_loss) / abs(main_first_loss)
            print(f"tune trainer: param_seed 0's first loss {ok[0]['first_loss']:.6f}, the main path's (the "
                  f"trainer phase's worker is held to it too) {main_first_loss:.6f} (relative difference "
                  f"{rel:.2e}, bar {TRAINER_LOSS_RTOL})")
            if not rel <= TRAINER_LOSS_RTOL:
                failures.append(f"(a) param_seed 0's first loss {ok[0]['first_loss']} is not {main_first_loss}")
        else:
            failures.append(f"(a) {len(ok)} of 2 trials finished")

        # ---- (b) PBT of the flagship at full width ----
        t = time.perf_counter()
        ckpt_root = os.path.join(storage, "pbt_ckpts")
        os.makedirs(ckpt_root)
        from ray_tpu_torch.models import transformer as tt

        shapes = tt._param_shapes(tt.TransformerConfig(**model))
        n_params = sum(int(np.prod(s)) for s in [*shapes["layers"].values()] + [
            v for k, v in shapes.items() if k != "layers"])
        ckpt_bytes = 3 * 4 * n_params
        # Each trial holds one checkpoint and may be writing the next; the
        # controller keeps a copy of each trial's newest in the experiment.
        need = (2 + 1) * z["population"] * ckpt_bytes
        free = shutil.disk_usage(storage).free
        print(f"pbt: {n_params / 1e6:.1f}M parameters, ~{ckpt_bytes / 1e9:.2f} GB a checkpoint; free disk under "
              f"{storage}: {free / 1e9:.1f} GB (the sweep needs up to {need / 1e9:.1f} GB)")
        if free < need:
            raise AssertionError(f"tune: {free / 1e9:.1f} GB free, the PBT sweep needs {need / 1e9:.1f} GB")
        pbt = _observed_pbt_class()(
            perturbation_interval=2, quantile_fraction=0.25, seed=z["pbt_seed"], ckpt_root=ckpt_root,
            hyperparam_mutations={"lr": tune.loguniform(*z["lr_range"])})
        host = {}
        with _controller_host_time(host):
            t_sweep = time.perf_counter()
            sweep_grid = tune.run(
                pbt_trainable,
                config=dict(model=model, dtype=dtype, batch=batch, seq=seq, chunk=z["chunk"], iters=z["iters"],
                            param_seed=0, batch_seed=1, ckpt_root=ckpt_root, lr=tune.loguniform(*z["lr_range"]),
                            **({} if cuda else {"device": "cpu"})),
                metric="loss", mode="min", num_samples=z["population"], scheduler=pbt,
                search_alg=BasicVariantGenerator(num_samples=z["population"], seed=z["searcher_seed"]),
                stop={"training_iteration": z["iters"]}, storage_path=storage, name="pbt",
                resources_per_trial={"CPU": 1, "GPU": 0.5} if cuda else {"CPU": 1},
                # As many live trials as the card holds: an exploited trial's
                # restart takes its own freed half back, where a waiting
                # trial would otherwise take it first.
                max_concurrent_trials=2)
            sweep_s = time.perf_counter() - t_sweep
        note_workers()
        marks["pbt_s"] = time.perf_counter() - t
        # Each trial process's last result: its launches, steps and forwards
        # outside a step so far, and how many results it gave.
        per_pid = {}
        for tid, r in pbt.results:
            pids.add(r["pid"])
            n = per_pid.get(r["pid"], (None, 0))[1]
            per_pid[r["pid"]] = (r, n + 1)
        for pid, (r, n) in sorted(per_pid.items()):
            for k in KERNELS:
                counts[k] += r["launches"].get(k, 0)
            want = {k: (r["steps"] + (r["forwards"] if k == "flash_fwd" else 0)) * L if cuda else 0
                    for k in KERNELS}
            print(f"pbt process {pid}: {n} results, {r['steps']} steps and {r['forwards']} forwards outside a "
                  f"step, launches {r['launches']} ({L} a step, and {L} a forward for flash_fwd)")
            if r["steps"] != n * z["chunk"] or r["launches"] != want:
                failures.append(f"(b) pid {pid}: {n} results of {z['chunk']} steps, but {r['steps']} steps and "
                                f"{r['forwards']} forwards counted, launches {r['launches']}, not {want}")
        by_trial = {}
        for tid, r in pbt.results:
            by_trial.setdefault(tid, []).append(r)
        losses = [r["loss"] for _, r in pbt.results]
        errors = [r.error for r in sweep_grid if r.error]
        n_results = len(pbt.results)
        host_ms = (host.get("_on_result", 0.0) + host.get("save_experiment_state", 0.0)) / max(
            1, host.get("_on_result_calls", 0)) * 1e3
        # The controller hands the scheduler each trial's results merged: a
        # key stays until a later result writes it again.
        saves = [r for _, r in pbt.results if r.get("ckpt_iteration") == r["iteration"]]
        restarts = [(tid, s, r.get("restored")) for tid, s, r in pbt.restarts]
        print(f"pbt: population {z['population']}, lr ~ loguniform{z['lr_range']} (searcher seed "
              f"{z['searcher_seed']}), perturbation every 2 iterations of {z['chunk']} steps, quantile 0.25, seed "
              f"{z['pbt_seed']}, stop at iteration {z['iters']}: {n_results} results in {sweep_s:.1f} s; "
              f"{len(pbt.exploits)} exploit(s); {pbt.pruned} checkpoint(s) deleted as no trial held them; errors "
              f"{errors}")
        for tid in sorted(by_trial):
            rs = by_trial[tid]
            print(f"pbt {tid}: lr {[round(r['lr'], 6) for r in rs]}; losses {[round(r['loss'], 4) for r in rs]}; "
                  f"tokens/s {[round(r['tokens_per_sec']) for r in rs]}; peak memory "
                  f"{max(r['peak_memory_bytes'] for r in rs) / 2**30:.2f} GiB; pids {sorted({r['pid'] for r in rs})}")
        for e in pbt.exploits:
            print(f"pbt exploit: {e['trial']} at iteration {e['iteration']} takes {e['donor']}'s checkpoint of "
                  f"iteration {e['donor_meta']['iteration']} (loss {e['donor_meta']['loss']:.6f}), lr "
                  f"{e['lr_from']:.6g} -> {e['lr_to']:.6g}")
        for tid, (s, s_start), rst in restarts:
            print(f"pbt restart: {tid}'s first result {s:.2f} s after the exploit ({s_start:.2f} s to the restored "
                  f"function's start: waiting for a share of the card, the new process, its imports; then the model, "
                  f"the load and one chunk); restored {rst and rst['tensors']} tensors bit-equal to the donor's "
                  f"checksums: {rst and rst['bit_equal']}; forward loss {rst and rst['loss']} against the donor's "
                  f"{rst and rst['donor_loss']}; load {rst and rst['load_s']:.2f} s")
        if saves:
            print(f"pbt checkpoints: {len(saves)} written, {saves[0]['ckpt_bytes']} bytes each; save (checksums, "
                  f"torch.save, the forward) {min(r['save_s'] for r in saves):.2f}-{max(r['save_s'] for r in saves):.2f} s")
        print(f"pbt controller: {host.get('_on_result', 0.0) * 1e3:.1f} ms handling {host.get('_on_result_calls', 0)} "
              f"results, {host.get('save_experiment_state', 0.0) * 1e3:.1f} ms saving the experiment's state "
              f"({host.get('save_experiment_state_calls', 0)} saves, each new checkpoint copied): {host_ms:.1f} ms a "
              f"result")
        if errors:
            failures.append(f"(b) trials failed: {errors}")
        if not pbt.exploits:
            failures.append("(b) no exploit happened")
        if len(restarts) != len(pbt.exploits):
            failures.append(f"(b) {len(pbt.exploits)} exploits but {len(restarts)} restarted trials reported")
        for (tid, s, rst), e in zip(restarts, pbt.exploits):
            if not rst or rst["donor_dir"] != e["donor_meta"]["dir"] or not rst["bit_equal"]:
                failures.append(f"(b) {tid}'s restored tensors differ from the donor's checksums")
            elif not abs(rst["loss"] - rst["donor_loss"]) <= TRAINER_LOSS_RTOL * abs(rst["donor_loss"]):
                failures.append(f"(b) {tid}'s forward after the restore {rst['loss']} is not the donor's "
                                f"{rst['donor_loss']}")
        if not losses or not all(math.isfinite(x) for x in losses):
            failures.append("(b) a loss is not finite")
        best = min(by_trial.values(), key=lambda rs: rs[-1]["loss"]) if by_trial else None
        if best is None or not best[-1]["loss"] < best[0]["loss"]:
            failures.append("(b) the best trial's last loss is not below its first")
        if cuda and any(r["device_name"] != torch.cuda.get_device_name(0) for _, r in pbt.results):
            failures.append("(b) a trial trained off this card")
        res["pbt"] = {"sweep_s": sweep_s, "results": n_results, "exploits": pbt.exploits and [
            {k: v for k, v in e.items() if k != "donor_meta"} for e in pbt.exploits],
            "restart_s": [s for _, (s, _), _ in restarts], "restart_to_fn_start_s": [s for _, (_, s), _ in restarts],
            "load_s": [rst["load_s"] for _, _, rst in restarts if rst],
            "save_s": [r["save_s"] for r in saves], "ckpt_bytes": saves[0]["ckpt_bytes"] if saves else None,
            "tokens_per_sec": {tid: [r["tokens_per_sec"] for r in rs] for tid, rs in by_trial.items()},
            "peak_memory_gib": {tid: max(r["peak_memory_bytes"] for r in rs) / 2**30 for tid, rs in by_trial.items()},
            "controller_ms_per_result": host_ms, "pruned": pbt.pruned,
            "processes": {pid: {"results": n, "steps": r["steps"], "forwards": r["forwards"]}
                          for pid, (r, n) in per_pid.items()}}

        # ---- (c) Tuner(PPO): each trial's learner on the card ----
        t = time.perf_counter()
        ppo = tune.Tuner(
            PPO,
            param_space={"env": "CartPole-v1", "num_rollout_workers": 1, "num_envs_per_worker": 2,
                         "train_batch_size": 256, "sgd_minibatch_size": 64, "num_sgd_iter": 2,
                         "lr": tune.grid_search([3e-4, 1e-3]), "num_learners": 1,
                         "num_gpus_per_learner": 0.5 if cuda else 0, "device": device,
                         "callbacks_class": _learner_devices_callbacks()},
            tune_config=tune.TuneConfig(metric="episode_reward_mean", mode="max"),
            run_config=RunConfig(name="ppo", storage_path=storage, stop={"training_iteration": z["ppo_iters"]}),
        ).fit()
        note_workers()
        marks["ppo_s"] = time.perf_counter() - t
        best = ppo.get_best_result()
        learners = [d for r in ppo for d in r.metrics.get("learner_devices", [])]
        pids.update(d["pid"] for d in learners)
        print(f"tune ppo: {len(ppo)} results in {marks['ppo_s']:.1f} s, errors {ppo.errors}; best lr "
              f"{best.config.get('lr') if best else None} (episode_reward_mean "
              f"{best.metrics.get('episode_reward_mean') if best else None}); learners {learners}")
        if len(ppo) != 2 or ppo.errors:
            failures.append(f"(c) {len(ppo)} results, errors {ppo.errors}")
        if best is None:
            failures.append("(c) no best result")
        want_dev = "cuda" if cuda else "cpu"
        if len(learners) != 2 or any(torch.device(d["device"]).type != want_dev for d in learners):
            failures.append(f"(c) the learners ran on {learners}, not {want_dev}")
        res["ppo"] = {"s": marks["ppo_s"], "learners": learners}
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    pids.discard(None)
    pids.discard(os.getpid())
    deadline = time.monotonic() + 30
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = sorted(p for p in pids if _alive(p))
    print(f"tune: worker pids {sorted(pids)}, {len(left)} left after shutdown()")
    if left:
        failures.append(f"worker processes {left} outlived shutdown()")
    marks["phase_s"] = time.perf_counter() - t0
    res.update(sections_s=marks, launches=counts)
    print(f"tune: phase wall time {marks['phase_s']:.1f} s")
    print("tune: " + json.dumps(res, default=str))
    if failures:
        raise AssertionError("tune: " + "; ".join(failures))
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    smi, card = device_phase(torch)
    info, f32_info = build_phase()
    errs = kernels_phase(torch)
    counts, in_step, first_loss, step_ms = main_path_phase(torch, smi)
    kernels = timings_phase(torch, smi, counts, errs, info, in_step)
    serve_res = serve_phase(torch, smi)
    moe_counts, moe_first_loss, _ = moe_train_phase(torch, smi)
    serve_phase(torch, smi, moe=True)
    (worker_counts, moe_worker_counts), trainer_raw_ms = trainer_phase(torch, smi, first_loss, step_ms, moe_first_loss)
    for row in kernels:
        row["worker_launches"] = worker_counts[row["name"]]
        row["moe_launches"] = moe_counts[row["name"]]
        row["moe_worker_launches"] = moe_worker_counts[row["name"]]
    zoo_row, vit_rate = zoo_phase(torch, smi, errs)
    kernels.append(zoo_row)
    ring_row, parallel_counts = parallel_phase(torch, smi, first_loss, step_ms)
    for row in kernels[:3]:
        row["parallel_launches"] = parallel_counts[row["name"]]
    kernels.append(ring_row)
    kernels[0]["mpmd_launches"] = a10_phase(torch)
    serve_app_phase(torch, smi, serve_res)
    data = data_phase(torch, smi, trainer_raw_ms, vit_rate)
    for row in kernels:
        row["data_launches"] = data["predict"]["flash_fwd"] if row["name"] == "flash_fwd_vit" else \
            data["ingest"].get(row["name"], 0)
    rllib_counts, dt_rows, family_counts = rllib_phase(torch, smi)
    # DT trains in f32: its launches are the f32 kernels', booked in the f32
    # rows at its shape (the earlier rows time the bf16 kernels, other
    # functions of the sources; no path runs the f32 kernels at the main
    # path's shape).
    for row in kernels:
        row["rllib_launches"] = 0
    for row in kernels + dt_rows:
        row["rllib_families_launches"] = family_counts[row.get("kernel", row["name"])]
    for row in dt_rows:
        on_dt = row["name"].endswith("_dt")
        i = f32_info[row["kernel"], DT_SHAPE["D"] if on_dt else MAIN["D"]]
        row.update(max_abs_err=max(e["max_abs"] for e in errs[row["name"]]),
                   rel_l2_err=max(e["rel_l2"] for e in errs[row["name"]]),
                   rllib_launches=rllib_counts[row["kernel"]] if on_dt else 0,
                   regs=i["regs"], smem_bytes=i["smem_bytes"], blocks_per_sm=i["blocks_per_sm"],
                   local_bytes=i["local_bytes"])
    kernels += dt_rows
    tune_counts = tune_phase(torch, smi, first_loss, trainer_raw_ms)
    # The trials run the bf16 kernels at the main path's shape: their rows
    # carry the count, the other shapes' and the f32 rows' 0.
    for row in kernels:
        row["tune_launches"] = tune_counts.get(row["name"], 0)
    print(f"script wall time {time.perf_counter() - t0:.1f} s (from the device phase; imports before it)")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
