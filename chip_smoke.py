#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Builds the CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``, sm_90a,
into ``build/repro_torch/``), holds every kernel against its plain
PyTorch version on the card, then drives the Bento request path
(``make_mount`` -> ``Mount.submit`` / ``PosixView`` -> xv6 -> journal ->
``KernelServices.checksum_batch`` -> the CUDA blockhash kernel) and checks
each result against the same stream run with ``device="cpu"``, which the
CPU tests hold byte-identical to the JAX reference package. The rest of
the file system follows at the reference benchmarks' sizes, each path
with the launch count set to 0 just before it: 64 CoW overlay tenants
over one base image (``overlay``), the provenance layer swapped onto and
off a live mount under 4 submitters (``prov_upgrade``), the same mix on
a FUSE daemon and on a bento mount (``fuse``), and the crash simulator's
quick sweeps, the sharded-checkpoint re-save included, held point for
point against the CPU (``crash``), and the checkpoint store of
benchmarks/fs_reshard.py at its full sizes with the token shards
(``ckpt_reshard``): elastic restores onto virtual meshes of the card,
FUSE restores serial against overlapped, overlay tenants and dedup
copies, every shard and fetched chunk hashed by the blockhash kernel,
each part held against the CPU. Then it serves rwkv6-7b at full width
and depth (``serve.step`` -> ``models/rwkv``
-> the CUDA WKV6 kernel for every prefill), checks the prefill against the same
prefill through the plain version, saves its layer 0 sharded on a
virtual (2, 2) mesh and restores it onto (1, 2) and (4, 2), runs a
prefill from the restored layer (``ckpt_model``), and traces where the
time goes. Then it
holds the SSD and flash attention kernels against their plain versions and
serves zamba2-7b at full width and depth the same way (``models/mamba2`` ->
the CUDA SSD kernel in each Mamba2 layer's prefill, the shared attention
block -> the CUDA flash attention kernel). Last the dense stack and the
trainer: smollm-135m served whole (``serve_smollm``: the flash kernel in
every layer's prefill), trained at full width and depth with the
bundle's RunConfig (``train_smollm``: the flash kernel in every forward
and rematerialised forward, its backward by recompute through the plain
version), and tests/test_system.py's story on the card (``train_ckpt``:
checkpoints on a bento mount, a failure and its recovery, the mounted fs
upgraded under the trainer, a restore, serving from it; every commit and
restore chunk on the blockhash kernel). Then the families beyond the
dense one: the WKV6 and SSD kernels' autograd Functions at their models'
training shapes (``wkv6_grad``, ``ssd_grad``: the kernel forward, the
backward by recompute through the plain version), rwkv6-7b and
zamba2-7b trained at full width with their depth cut through them under
two-level remat (``train_rwkv6``, ``train_zamba2``), and olmoe-1b-7b
served whole (``serve_olmoe``: the MoE layer's dense dispatch, the flash
kernel in every layer's prefill) and trained at full width
(``train_olmoe``). Last the cross-attention families: llama-3.2-vision-11b
served whole (``serve_vlm``: the flash kernel in every self and gated
cross layer's prefill, over 6404 stub image tokens) and trained at full
width with its depth cut to one super-block (``train_vlm``), and
whisper-small served and trained whole (``serve_whisper``,
``train_whisper``: the flash kernel in the encoder, the decoder and its
cross attention). The mesh-parallel paths run on virtual meshes of the
card (one card in every cell; ``distributed.spmd.shard_map`` runs the
cells as threads, so their times are one card's): each collective
against its definition (``spmd``), olmoe-1b-7b served with the
expert-parallel MoE on serve_olmoe's weights (``serve_olmoe_a2a``), the
sequence-sharded decode against the dense one in the smollm, zamba2, VLM
and whisper serves (``decode_flash``), smollm's blocks as a 3-stage
GPipe pipeline against the sequential stack (``pipeline``) and its
gradients through the int8 compressors (``compression``), both on
train_smollm's trainer, and the trainer partitioned over a (2, 2) mesh
(``train_mesh``: smollm-135m at 10 of its 30 layers, each cell holding
its FSDP x model shards and computing with its own half of the MLP and
the vocabulary, tensor-parallel over ``model``, held against the same
steps unpartitioned, and an elastic round through a bento mount;
``train_mesh_olmoe``, after ``train_olmoe``: olmoe-1b-7b at 2 layers,
each cell's own heads, experts and vocabulary, with the dense dispatch
and the expert-parallel a2a, held against the same steps unpartitioned
and the plain a2a's; ``serve_mesh_smollm`` and ``serve_mesh_olmoe``,
after ``serve_smollm`` and ``serve_olmoe_a2a``: the serve programs
partitioned over a (2, 2) mesh on the serve phase's weights and prompt,
each cell holding its shard of the weights and of the KV cache and
computing on its own heads, experts and vocabulary, held in f32 at 2
layers against the same serve unpartitioned; ``serve_mesh_vlm`` and
``serve_mesh_whisper``, after ``serve_vlm`` and ``serve_whisper``: the
same for the cross-attention families, each cell also holding its kv
heads' shard of the cross KV, the VLM held in f32 at one super-block (5
layers), whisper-small whole; ``serve_mesh_rwkv6``, after
``serve_trace``, and ``serve_mesh_zamba2``, after ``serve_zamba2``: the
same for the recurrent families, each cell holding its heads' shard of
the WKV or SSD state, its even block of zamba2's conv state and its
shard of zamba2's shared-block KV cache, held in f32 at 2 layers
(rwkv6) and 6 (zamba2, one shared-block application);
``serve_mesh_flash_smollm`` and ``serve_mesh_flash_olmoe``, after
``serve_mesh_smollm`` and ``serve_mesh_olmoe``: the same models served
on the same mesh under the ``decode_flash`` rules, each decode step 2-D
tensor parallel on the cell's weight shards with no weight gathered (the
features over ``data``, the cell's rows and sequence block with every kv
head in its attention), the prefill on the cell's rows, held in f32 at 2
layers;
``train_mesh_rwkv6``, after ``train_rwkv6``: rwkv6-7b at 2 layers,
each cell's own WKV heads, channel-mix columns and vocabulary, held
against the same steps unpartitioned; ``train_mesh_vlm``, after
``train_vlm``: llama-3.2-vision-11b at train_vlm's depth, each cell's
own heads of the self and the cross attention, MLP columns and
vocabulary, held against train_vlm's first steps; ``train_mesh_whisper``,
after ``train_whisper``: whisper-small whole, each cell's own heads of
the encoder's, the decoder's and the cross attention and MLP columns,
held against train_whisper's first steps). The training phases' profiled steps trace the
device alone, as the serves' profiles do, and time their named ranges
(``repro_torch.ranges``) with CUDA events. Last the launch half and
the examples: the dry-run (``launch.dryrun``: programs traced on meta
tensors in two worker processes while the card runs the phases above)
held to those phases (train_mesh_olmoe's two runs traced over the
whole virtual mesh), its traced kernel calls to their launches
exactly and its traced peaks to their measured peaks (``dryrun``), and
``examples/quickstart_torch.py`` and ``train_small_lm_torch.py`` on the
card (``examples``). Every phase asserts
and prints JSON lines, and a line with its seconds; the last line is the
device record. It
imports nothing of JAX and exits non-zero, printing no result, when no
CUDA device is present or when run outside a checkout.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM, NVIDIA's data sheet: device-memory rate, the float32 rate
# outside the tensor cores (the table's nearest entry for the blockhash
# kernel's integer multiply-adds), and the tensor cores' dense bf16 rate.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
# The card's host link, PCIe Gen5 x16: 128 GB/s both ways on the same data
# sheet, so 64 GB/s for the words that cross it one way.
HOST_LINK_BYTES_PER_S = 64e9

# (nblocks, wpb): the probe, a 16-byte input, a 4093-byte block padded to
# whole words, one full journal commit (nlog=64 holds 63 blocks), one
# buffer cache (4096 blocks, 16 MiB) and the 128 MiB image of the
# fs_macro fileserver mount.
KERNEL_SHAPES = ((1, 2), (1, 4), (1, 1024), (63, 1024), (4096, 1024),
                 (32768, 1024))
# each of the blockhash kernel's timings: the median of 10 runs of 10
# calls (fewer than the 20 of 20 of device_ms's default: the smoke's
# seconds are budgeted)
KERNEL_TIMING = {"count": 10, "reps": 10}
HEADLINE_SHAPE = (63, 1024)

SOURCES = ("blockhash", "wkv6", "ssd", "flash_attention")  # csrc/<name>.cu

# (B, S, H, K, V, chunk): the three shapes of tests/test_kernels.py's WKV6
# sweep, then the serve's full width (rwkv6-7b: 64 heads of 64, chunk 32,
# batch 4, prompt 1024), then a cell's own in train_mesh_rwkv6 (its 4
# rows of 2048 tokens, 32 of the 64 heads) and in serve_mesh_rwkv6's
# prefill (its 2 rows of the prompt, 32 of the 64 heads).
WKV6_SHAPES = ((2, 64, 3, 16, 16, 16), (1, 128, 2, 32, 32, 32),
               (1, 64, 1, 8, 8, 64), (4, 1024, 64, 64, 64, 32),
               (4, 2048, 32, 64, 64, 32), (2, 1024, 32, 64, 64, 32))
WKV6_HEADLINE = ((4, 1024, 64, 64, 64, 32), "bfloat16")
WKV6_TOL = 1e-4  # x max(1, max|ref|), for y and the state
SERVE = {"arch": "rwkv6-7b", "batch": 4, "prompt": 1024, "gen": 32}

# (b, S, H, P, N, chunk): the three shapes of tests/test_kernels.py's SSD
# sweep, then the serve's full width (zamba2-7b: 112 heads, P = N = 64,
# chunk 128, batch 4, prompt 1024), then a cell's own in train_mesh_zamba2
# (its 4 rows of 2048 tokens, 56 of the 112 heads) and in
# serve_mesh_zamba2's prefill (its 2 rows of the prompt, 56 heads).
SSD_SHAPES = ((2, 128, 3, 16, 8, 32), (1, 256, 2, 64, 64, 128),
              (1, 64, 1, 8, 8, 64), (4, 1024, 112, 64, 64, 128),
              (4, 2048, 56, 64, 64, 128), (2, 1024, 56, 64, 64, 128))
SSD_HEADLINE = ((4, 1024, 112, 64, 64, 128), "bfloat16")
SSD_TOL = 2e-4  # x max(1, max|ref|), for y and the state
# (B, Sq, Skv, Hq, Hkv, D, causal, window, softcap): the five shapes of
# tests/test_kernels.py's flash sweep, a softcap case at the serve's
# head_dim, lengths no tile divides (Skv != Sq under a window; the serve's
# shared block at a 1000-token prompt), the serve's shared block
# (zamba2-7b: 32 heads of 112), then smollm-135m's attention (9 heads over
# 3 kv heads of 64) at its serve, at its training step (a microbatch of 4 x
# 2048) and at train_ckpt's step (8 x 256), then the shapes this file's
# other model paths launch: olmoe-1b-7b's (16 heads of 128) at its serve
# and at its training step (one microbatch of 8 x 2048) and a cell's own
# (8 of the heads, 4 rows) in train_mesh_olmoe, and zamba2-7b's
# shared block at its training step (a microbatch of 4 x 2048); then the
# cross-attention families: llama-3.2-vision-11b (32 heads over 8 of 128)
# at its serve (a 1024-token prompt, its self layers causal, its cross
# layers over the 6404 image tokens) and at its training microbatch (4 x
# 2048), and whisper-small (12 heads of 64) at its serve (the encoder's
# 1500 frames, non-causal; a 384-token prompt; the cross attention to the
# frames) and at its training step (8 x 448 tokens); then a VLM cell's own
# in train_mesh_vlm (16 of the q heads over 4 of the kv heads, 4 rows),
# self and cross; a whisper cell's own in train_mesh_whisper (6 of
# the 12 heads, 4 rows): the encoder's, the decoder's, the cross; a
# zamba2 cell's own shared block in train_mesh_zamba2 (16 of the 32 heads,
# 4 rows); last a cell's own prefill attention in the partitioned serves:
# olmoe-1b-7b's 8 of its 16 heads (serve_mesh_olmoe, 2 rows), all of
# smollm-135m's 9 over 3 (serve_mesh_smollm, 2 rows: they do not split),
# olmoe-1b-7b's 4 of its 16 heads (serve_olmoe_a2a's (1, 4) mesh, 4
# rows), a VLM serve cell's 16 q heads over 4 kv heads (serve_mesh_vlm, 2
# rows), self and cross, a whisper serve cell's 6 of the 12 heads
# (serve_mesh_whisper, 2 rows): the encoder's, the decoder's, the cross,
# and a zamba2 serve cell's shared block, 16 of its 32 heads
# (serve_mesh_zamba2, 2 rows).
FLASH_CASES = ((2, 256, 256, 4, 2, 64, True, 0, 0.0),
               (1, 512, 512, 8, 8, 128, True, 0, 0.0),
               (2, 256, 256, 4, 4, 64, False, 0, 0.0),
               (1, 512, 512, 4, 2, 64, True, 128, 0.0),
               (1, 256, 512, 4, 1, 64, False, 0, 0.0),
               (1, 256, 256, 4, 2, 112, True, 0, 5.0),
               (2, 100, 300, 4, 2, 112, True, 64, 0.0),
               (4, 1000, 1000, 32, 32, 112, True, 0, 0.0),
               (4, 1024, 1024, 32, 32, 112, True, 0, 0.0),
               (4, 1024, 1024, 9, 3, 64, True, 0, 0.0),
               (4, 2048, 2048, 9, 3, 64, True, 0, 0.0),
               (8, 256, 256, 9, 3, 64, True, 0, 0.0),
               (4, 1024, 1024, 16, 16, 128, True, 0, 0.0),
               (8, 2048, 2048, 16, 16, 128, True, 0, 0.0),
               (4, 2048, 2048, 8, 8, 128, True, 0, 0.0),
               (4, 2048, 2048, 32, 32, 112, True, 0, 0.0),
               (4, 1024, 1024, 32, 8, 128, True, 0, 0.0),
               (4, 1024, 6404, 32, 8, 128, False, 0, 0.0),
               (4, 2048, 2048, 32, 8, 128, True, 0, 0.0),
               (4, 2048, 6404, 32, 8, 128, False, 0, 0.0),
               (4, 1500, 1500, 12, 12, 64, False, 0, 0.0),
               (4, 384, 384, 12, 12, 64, True, 0, 0.0),
               (4, 384, 1500, 12, 12, 64, False, 0, 0.0),
               (8, 1500, 1500, 12, 12, 64, False, 0, 0.0),
               (8, 448, 448, 12, 12, 64, True, 0, 0.0),
               (8, 448, 1500, 12, 12, 64, False, 0, 0.0),
               (4, 2048, 2048, 16, 4, 128, True, 0, 0.0),
               (4, 2048, 6404, 16, 4, 128, False, 0, 0.0),
               (4, 1500, 1500, 6, 6, 64, False, 0, 0.0),
               (4, 448, 448, 6, 6, 64, True, 0, 0.0),
               (4, 448, 1500, 6, 6, 64, False, 0, 0.0),
               (4, 2048, 2048, 16, 16, 112, True, 0, 0.0),
               (2, 1024, 1024, 8, 8, 128, True, 0, 0.0),
               (2, 1024, 1024, 9, 3, 64, True, 0, 0.0),
               (4, 1024, 1024, 4, 4, 128, True, 0, 0.0),
               (2, 1024, 1024, 16, 4, 128, True, 0, 0.0),
               (2, 1024, 6404, 16, 4, 128, False, 0, 0.0),
               (2, 1500, 1500, 6, 6, 64, False, 0, 0.0),
               (2, 384, 384, 6, 6, 64, True, 0, 0.0),
               (2, 384, 1500, 6, 6, 64, False, 0, 0.0),
               (2, 1024, 1024, 16, 16, 112, True, 0, 0.0))
FLASH_HEADLINE = ((4, 1024, 1024, 32, 32, 112, True, 0, 0.0), "bfloat16")
# atol = rtol, as the tests; the atol taken at the output's own scale where
# that is below 1 (flash_within)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the kernel's key tile (BKV in csrc/flash_attention.cu): a non-causal case
# of FLASH_DROP_MIN_KEYS keys or more is also run in bf16 with one tile of
# keys dropped, a planted fault its check must refuse
FLASH_KEY_TILE = 64
FLASH_DROP_MIN_KEYS = 1024
# the first non-causal shape with Skv >> Sq on a model's path: the VLM's
# cross attention at its serve
FLASH_CROSS_HEADLINE = ((4, 1024, 6404, 32, 8, 128, False, 0, 0.0),
                        "bfloat16")
# (count, reps) of device_ms for the kernel and sdpa, then for the plain
# version (the smoke's seconds are budgeted): a bf16 case in 10 replays of
# 5 calls each, or in fewer where its forward does more than FLASH_BIG_OPS
# operations; every f32 case, and the plain version of a big one, in 3
# replays of 1 call (tens of ms a call: the timing, not the check, took
# most of the phase's seconds)
FLASH_BIG_OPS = 2e11
FLASH_TIMING = {"small": ({"count": 5, "reps": 10}, {"count": 5, "reps": 10}),
                "big": ({"count": 3, "reps": 5}, {"count": 1, "reps": 3}),
                "float32": ({"count": 1, "reps": 3}, {"count": 1, "reps": 3})}
# odd_prompt: a prefill whose length neither a flash block (128) nor the
# SSD chunk (128) divides
ZAMBA = {"arch": "zamba2-7b", "batch": 4, "prompt": 1024, "gen": 32,
         "odd_prompt": 1000}
# smollm-135m, whole: served as zamba2 is, and trained at SmolLM's context
# (2048) with the bundle's RunConfig (microbatches of 4: 2 a step). The
# checkpoint story (tests/test_system.py's) keeps the full width but cuts
# the depth: see phase_train_ckpt.
SMOLLM = {"arch": "smollm-135m", "batch": 4, "prompt": 1024, "gen": 32,
          "odd_prompt": 1000}
TRAIN = {"arch": "smollm-135m", "global_batch": 8, "seq": 2048, "warmup": 2,
         "steps": 6}
# The trainer partitioned over a virtual (2, 2) ("data", "model") mesh of
# the card (train_mesh): smollm-135m at full width with train_smollm's
# RunConfig, batch, data and seed, its depth cut from 30 to 10 layers (the
# smoke's seconds: the VLM's mesh phase joined it), every leaf a
# MeshArray whose cells hold their FSDP x model shards; held against the
# same steps unpartitioned at the same depth, run just before it. Its
# elastic round keeps the width and cuts the depth to 2 layers at train_ckpt's
# 8 x 256 (a full-depth checkpoint is 1.61 GB: a save and two restores
# would take a minute at the store's rates): saved at (2, 2), restored
# onto (4, 1) and (1, 1).
TRAIN_MESH = {"layers": 10, "mesh": (2, 2), "warmup": 2, "steps": 3,
              "elastic": ((4, 1), (1, 1)), "elastic_layers": 2,
              "elastic_seq": 256, "real_mesh": (2, 1)}
# The partitioned step against the unpartitioned one from the same seed:
# each step's loss within MESH_LOSS_TOL x max(1, |loss|), each parameter
# leaf after the last step within MESH_PARAM_TOL x max(1, max|p|). On the
# CPU at the smoke config with this RunConfig (8 x 64 and 8 x 256, 5
# steps) the two are bit-identical (max difference 0: the cells' gradient
# sum adds the two data cells' microbatches as the accumulation does);
# the bounds leave room for the card's kernels that add in an order of
# their own (the embedding's backward).
# Since the step is tensor-parallel over ``model`` (its MLP's and the
# vocabulary's partial sums added over the cells), the bf16 step's
# parameters may stray from the unpartitioned run's past MESH_PARAM_TOL (partial
# sums added in another order flip Adam's sign on a gradient near 0): its
# gap is printed, and where it exceeds the bound the parameters are held
# on the same steps in f32 compute, partitioned and not (mesh_f32_hold).
# The parameters after 5 steps of the warm-up (learning rates 0 to 6e-6)
# move by about 1e-5 whatever the gradients, so a fault that sits only in
# the backward cannot reach MESH_PARAM_TOL: each leaf of the first moment,
# which is linear in the gradients, is held too, its gap's norm within
# MESH_MOMENT_TOL of the leaf's norm (a missing psum at an entry, or a
# norm's scale summed over model, moves a leaf by half its norm or more;
# moment_probe.py plants one on the card). Not its largest element: the
# MoE's routing flips a token to another expert at a near-tie, in f32 too,
# and that one token's share of an expert's gradient sets the largest
# element's gap (0.098 of olmoe's largest first moment in f32).
MESH_LOSS_TOL, MESH_PARAM_TOL, MESH_MOMENT_TOL = 1e-3, 1e-4, 5e-2
# The partitioned step tensor-parallel over ``model`` on the MoE family
# (train_mesh_olmoe): olmoe-1b-7b at full width and 2 layers (train_olmoe's
# 4 halved for the smoke's seconds, since train_mesh_vlm joined it), its
# batch (8 x 2048), RunConfig, data and seed, on a virtual (2, 2) mesh
# whose cells compute with their own 8 heads, 32 experts and half of the
# vocabulary; the dense dispatch and the expert-parallel a2a (ruleset
# moe_a2a), 2 + 2 steps each. The dense run's losses and gathered
# parameters are held against the same steps unpartitioned (train_olmoe's
# trainer at 2 layers); the a2a's against the same
# steps unpartitioned with the MoE layer through plain_a2a_moe over the
# mesh's 4 slices of the tokens (at full width the a2a drops other
# assignments than the dense dispatch: serve_olmoe_a2a); MESH_LOSS_TOL,
# MESH_PARAM_TOL and MESH_MOMENT_TOL as train_mesh. Its f32 hold, where a
# bf16 run strays (routing flips make olmoe's first moments stray 0.1 or
# more in bf16), is cut to 2 layers, 8 x 1024 and 2 steps: at the run's
# size the a2a's f32 mesh step ran out of the card's 80 GB; 1024 keeps a
# token group of 4096 inside a data cell, the bf16 run's path.
TRAIN_MESH_OLMOE = {"arch": "olmoe-1b-7b", "layers": 2, "mesh": (2, 2),
                    "warmup": 2, "steps": 2,
                    "runs": (("dense", "dense", "baseline"),
                             ("a2a", "a2a", "moe_a2a")),
                    "f32_hold": {"layers": 2, "seq": 1024, "steps": 2}}
# The partitioned step tensor-parallel over ``model`` on the VLM
# (train_mesh_vlm): llama-3.2-vision-11b at full width and train_vlm's
# depth (one super-block: 4 self layers and a cross layer), its batch (8
# x 2048 over 6404 stub image tokens), RunConfig, data, gates and seed, on
# a virtual (2, 2) mesh whose cells compute with their own 16 of the 32 q
# heads and 4 of the 8 kv heads in the self and the cross attention, half
# the MLP columns and half the vocabulary; 2 steps, held against
# train_vlm's first 2 (its parameters and first moments copied to the
# host after them: TRAIN_STATE_AT) within MESH_LOSS_TOL, MESH_PARAM_TOL and
# MESH_MOMENT_TOL. Where the bf16 run strays past a bound, the f32 hold
# runs cut to 8 x 256 (the depth cannot go below one super-block; in f32
# each of the 4 cells holds its gathered parameters and their gradients at
# 4 bytes, 17.1 GB each over the cells, beside 25.7 GB of state at rest),
# its unpartitioned state on the host.
TRAIN_MESH_VLM = {"arch": "llama-3.2-vision-11b", "mesh": (2, 2), "steps": 2,
                  "f32_hold": {"seq": 256, "steps": 2}}
# The same on whisper (train_mesh_whisper): whisper-small whole (12
# encoder and 12 decoder layers), train_whisper's batch (8 x 448 over 1500
# stub frames), RunConfig, data and seed, on a virtual (2, 2) mesh whose
# cells compute with their own 6 of the 12 heads in the encoder's, the
# decoder's and the cross attention and 1536 of the 3072 MLP columns; its
# vocabulary of 51865 divides by neither 2 nor 4, so the embedding and
# logits are gathered whole and repeat in each cell, as GSPMD replicates
# them. 2 steps held against train_whisper's first 2, as the VLM's; its
# f32 hold, where the bf16 run strays, at the run's own size (whisper's
# 335 M parameters leave room).
TRAIN_MESH_WHISPER = {"arch": "whisper-small", "mesh": (2, 2), "steps": 2,
                      "f32_hold": {"seq": 448, "steps": 2}}
# the mesh phases held against a training phase's first steps, by name:
# train_mesh_<x> follows train_<x> (mesh_of)
TRAIN_MESH_CROSS = {"train_mesh_vlm": TRAIN_MESH_VLM,
                    "train_mesh_whisper": TRAIN_MESH_WHISPER}
TRAIN_STATE_AT = {}  # such a training phase's state_copy (on the host)
# The partitioned step tensor-parallel over ``model`` on rwkv6
# (train_mesh_rwkv6): rwkv6-7b at full width with its depth cut 32 -> 2,
# train_rwkv6's RunConfig, batch (8 x 2048), data and seed, on a virtual
# (2, 2) mesh whose cells run the time mix on their own 32 of the 64 WKV
# heads and the channel mix on 7168 of its 14336 columns, with half the
# vocabulary; 2 + 2 steps held against the same steps unpartitioned at
# that depth, run just before it (its state kept on the card), within
# MESH_LOSS_TOL, MESH_PARAM_TOL and MESH_MOMENT_TOL; its f32 hold, where
# the bf16 run strays, at 8 x 1024.
TRAIN_MESH_RWKV6 = {"arch": "rwkv6-7b", "layers": 2, "mesh": (2, 2),
                    "warmup": 2, "steps": 2,
                    "f32_hold": {"seq": 1024, "steps": 2}}
# The same on zamba2 (train_mesh_zamba2): zamba2-7b at full width with its
# depth cut 81 -> 6 (one application of the shared block, after layer 5),
# train_zamba2's RunConfig, batch (8 x 2048), data and seed, on a virtual
# (2, 2) mesh whose cells run the Mamba2 blocks on their own 56 of the 112
# SSD heads (their gate, x and dt columns of the gathered ``w_in``, B and C
# whole; their 3584 rows of ``w_out``), the shared block's attention on 16
# of its 32 heads and its MLP on 7168 of its 14336 columns, with half the
# vocabulary; 2 + 2 steps held against the same steps unpartitioned at
# that depth, run just before it, as train_mesh_rwkv6's; its f32 hold,
# where the bf16 run strays, at 8 x 1024.
TRAIN_MESH_ZAMBA2 = {"arch": "zamba2-7b", "layers": 6, "mesh": (2, 2),
                     "warmup": 2, "steps": 2,
                     "f32_hold": {"seq": 1024, "steps": 2}}
TRAIN_CKPT = {"arch": "smollm-135m", "layers": 2, "global_batch": 8,
              "seq": 256, "steps": 9, "ckpt_every": 3, "fail_at": 6,
              "n_blocks": 1 << 19, "decode_steps": 4}

# The file-system phases of the reference's own benchmarks, at their
# sizes: benchmarks/fs_coldstart.run (64 tenants over one 8192-block base
# image, build_base_image's default), benchmarks/fs_upgrade.run_under_load
# (a bento mount of 16384 blocks, 4 submitters, windows of 0.6 s), and the
# quick crash sweeps of fs/crashsim.py on xv6.
OVERLAY = {"fs_kind": "xv6", "tenants": 64, "base_blocks": 8192}
UPGRADE = {"n_blocks": 16384, "submitters": 4, "phase_s": 0.6,
           "pause_budget_s": 5.0}
TORTURES = ("torture_chain", "torture_prov", "torture_dedup",
            "torture_lazy", "torture_overlay", "torture_ckpt_shards")


CARD = {}  # {"card": nvidia-smi's name and power limit}, once known


EMITTED = {}  # each phase's last line, for the phases that check others


def emit(phase: str, **fields) -> None:
    """A phase's JSON line, with the card's name and power limit."""
    EMITTED[phase] = fields
    print(json.dumps({"phase": phase, **fields, **CARD}), flush=True)


PHASE_SECONDS = {}  # each phase's seconds, in the order they ran


def mesh_of(train: str) -> str:
    """The mesh phase that follows a training phase: train_<x> ->
    train_mesh_<x>."""
    return train.replace("train", "train_mesh", 1)


def timed(name: str, fn, *args):
    """``fn(*args)``, its seconds kept in PHASE_SECONDS and printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    emit("phase_seconds", of=name, seconds=PHASE_SECONDS[name])
    return out


def _event_ms(run, count: int, reps: int) -> float:
    """Median over ``reps`` of the CUDA-event time of ``run()`` / ``count``."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / count)
    return statistics.median(times)


def device_ms(fn, *, count: int = 20, reps: int = 20) -> float:
    """Device time of one ``fn()``: ``count`` calls captured in a CUDA
    graph and replayed, so the host's launch cost is not in the time;
    median of ``reps`` replays after warm-up."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(count):
            fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    return _event_ms(graph.replay, count, reps)


def call_ms(fn, *, count: int = 20, reps: int = 20) -> float:
    """Time of one eager ``fn()`` as a caller sees it, host launch cost and
    any copies included: events around ``count`` calls in a row."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(count):
            fn()
    return _event_ms(run, count, reps)


# --- workloads (the shapes of benchmarks/fs_macro.py) ---------------------------------


def fileserver(v, loops: int, root: str = "/srv") -> int:
    """fs_macro.fileserver: 50 files of 64 KiB, write/append/read/stat,
    an unlink every 5th loop and an fsync every 16th."""
    v.makedirs(root)
    blob = b"f" * 65536
    rng = np.random.default_rng(11)
    ops = 0
    for i in range(loops):
        name = f"{root}/file{int(rng.integers(50)):04d}"
        v.write_file(name, blob)
        v.append(name, b"tail" * 256)
        data = v.read_file(name)  # write_file does not truncate
        assert data[:65536] == blob and data.endswith(b"tail" * 256)
        v.stat(name)
        if i % 5 == 4:
            v.unlink(name)
        ops += 5
        if i % 16 == 15:
            v.fsync(name if v.exists(name) else root)
            ops += 1
    return ops


def varmail(v, loops: int, root: str = "/mail") -> int:
    """fs_macro.varmail: the fsync-heavy mail-server loop."""
    v.makedirs(root)
    v.create(f"{root}/op.log")
    msg = b"m" * 8192
    ops = 0
    for i in range(loops):
        name = f"{root}/msg{i % 64:04d}"
        v.write_file(name, msg)
        v.append(f"{root}/op.log", b"delivered %d\n" % i)
        v.fsync(f"{root}/op.log")
        assert v.read_file(name) == msg
        if i % 4 == 3:
            v.unlink(name)
        ops += 4
    return ops


def submit_batches(mf, n_batches: int, *, launches=None):
    """``n_batches`` submissions of 128 writes of 512 bytes over a 64 KiB
    file plus a trailing fsync: each commits as ONE journal transaction,
    so it must cost one checksum_batch call (one kernel launch on CUDA).
    Returns (ops, per-batch checksum_batch calls, per-batch launches)."""
    from repro_torch.core.interface import SubmissionEntry

    v, ks = mf.view, mf.services
    ino = v.create("/batch.dat").ino
    calls, launched = [], []
    for b in range(n_batches):
        entries = [SubmissionEntry(
            "write", (ino, (i * 512) % 65536, bytes([(b + i) % 251]) * 512),
            user_data=i) for i in range(128)]
        entries.append(SubmissionEntry("fsync", (ino,), user_data="fsync"))
        c0 = ks.counters["checksum_batch_calls"] if ks else 0
        l0 = launches() if launches else 0
        comps = mf.mount.submit(entries)
        assert all(c.ok for c in comps), [c.errno for c in comps if not c.ok]
        # a fuse mount's services are in its daemon: nothing to count here
        calls.append(ks.counters["checksum_batch_calls"] - c0 if ks else None)
        launched.append((launches() - l0) if launches else None)
    return n_batches * 129, calls, launched


def image(dev) -> np.ndarray:
    data = dev._data
    return data if isinstance(data, np.ndarray) else data.cpu().numpy()


def checksum_calls(ks) -> int:
    return ks.counters["checksum_batch_calls"] + ks.counters["checksum_calls"]


def time_checksums(ks) -> dict:
    """Accumulate the host time spent in ``ks``'s checksum functions (each
    call returns Python ints, so it has waited for the device) into the
    returned dict's ``"s"``."""
    spent = {"s": 0.0}

    def timed(fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent["s"] += time.perf_counter() - t0
        return run

    ks._checksum = timed(ks._checksum)
    ks._checksum_batch = timed(ks._checksum_batch)
    return spent


# --- phases ------------------------------------------------------------------------------


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    assert smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}"
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    CARD["card"] = card
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)
    return card


def phase_build():
    """Build every CUDA source at once, one nvcc each."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_lines(name) for name in SOURCES}
    emit("build", sources=list(SOURCES), seconds=build_s, ptxas=ptxas)


def blockhash_exact(blocks, dev) -> tuple:
    """Hash ``blocks`` (one word count) with the CUDA blockhash on their
    words in device memory, with the plain version on the same words and
    as the main path runs it (``ops._Staging.hash``: the kernel reads
    mapped pinned host words); each must equal the numpy oracle exactly.
    Returns (words on the host, on the card, powers on the card, the
    oracle's hashes, the largest |kernel - oracle|)."""
    import torch

    from repro_torch.kernels.blockhash import kernel as K
    from repro_torch.kernels.blockhash import ops, ref

    w = ops._words(blocks)
    n, wpb = w.shape
    pows_np = ref.powers(wpb)
    words_cpu = torch.from_numpy(w.view(np.int32).copy())
    words = words_cpu.to(dev)
    pows = torch.from_numpy(pows_np.view(np.int32).copy()).to(dev)

    got = K.blockhash_batch(words, pows)
    plain = ref.blockhash(words, pows)
    pinned = ops.staging(dev).hash(blocks)
    torch.cuda.synchronize()
    # the numpy oracle, whole array: u64 products summed with u64
    # wraparound keep the low 32 bits exact (ref.blockhash_np's method)
    want = (w.astype(np.uint64) * pows_np.astype(np.uint64)).sum(
        axis=1) & 0xFFFFFFFF
    got_u32 = got.cpu().numpy().view(np.uint32).astype(np.uint64)
    sample = sorted({0, n - 1, *range(0, n, max(1, n // 16))})
    exact = (torch.equal(got, plain)
             and np.array_equal(got_u32, want)
             and pinned == want.tolist()
             and all(int(got_u32[i]) == ref.blockhash_np(w[i].tobytes())
                     for i in sample))
    max_abs_err = int(np.abs(got_u32.astype(np.int64)
                             - want.astype(np.int64)).max())
    assert exact, f"blockhash disagrees at {(n, wpb)}"
    return words_cpu, words, pows, want, max_abs_err


def phase_kernel():
    """Hold the CUDA blockhash against the plain version on the card and
    against the numpy oracle, exactly, at every shape: through the public
    wrapper on words in device memory, and as the main path runs it
    (``ops._Staging.hash``: the kernel reads mapped pinned host words).
    Time both; the main path's way is bounded by the host link."""
    import torch

    from repro_torch.kernels.blockhash import kernel as K
    from repro_torch.kernels.blockhash import ops, ref

    rng = np.random.default_rng(2024)
    dev = torch.device("cuda", torch.cuda.current_device())
    st = ops.staging(dev)
    rows = []
    for n, wpb in KERNEL_SHAPES:
        if (n, wpb) == (1, 2):
            blocks = [b"probe"]
        elif (n, wpb) == (1, 1024):
            blocks = [rng.integers(0, 256, 4093, dtype=np.uint8).tobytes()]
        else:
            w = rng.integers(0, 2**32, (n, wpb), dtype=np.uint64)
            w = w.astype(np.uint32)
            w[0] = 0xFFFFFFFF
            w[-1] = 0xFFFFFFFF
            blocks = [row.tobytes() for row in w]
        words_cpu, words, pows, want, max_abs_err = blockhash_exact(
            blocks, dev)
        assert words.shape == (n, wpb)

        # the main path's launch on the words it staged, without its wait
        # (a wait cannot be captured in a CUDA graph); then with the wait,
        # events around 20 calls in a row, the host's launch cost included
        def launch_pinned(wait=False):
            K.hash_pinned(st.host_words.data_ptr(), ops._pows(wpb, dev)
                          .data_ptr(), st.host_out.data_ptr(), n, wpb,
                          torch.cuda.current_stream().cuda_stream, wait)
        ms = device_ms(launch_pinned, **KERNEL_TIMING)
        pinned_call = call_ms(lambda: launch_pinned(wait=True),
                              **KERNEL_TIMING)
        assert st.out_u32[:n].tolist() == want.tolist()
        resident_ms = device_ms(lambda: K.blockhash_batch(words, pows),
                                **KERNEL_TIMING)
        eager_ms = call_ms(lambda: K.blockhash_batch(words, pows),
                           **KERNEL_TIMING)
        ms_with_copies = call_ms(
            lambda: K.blockhash_batch(words_cpu.to(dev), pows).cpu(),
            **KERNEL_TIMING)
        plain_ms = device_ms(lambda: ref.blockhash(words, pows),
                             **KERNEL_TIMING)
        nbytes = n * wpb * 4 + wpb * 4 + n * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * n * wpb / CUDA_CORE_OPS_PER_S * 1e3
        # the main path's words cross the host link to the card
        link_ms = n * wpb * 4 / HOST_LINK_BYTES_PER_S * 1e3
        row = {"shape": [n, wpb], "exact": True, "max_abs_err": max_abs_err,
               "ms": ms, "pinned_call_ms": pinned_call,
               "device_resident_ms": resident_ms, "eager_call_ms": eager_ms,
               "ms_with_copies": ms_with_copies,
               "plain_ms": plain_ms, "bytes": nbytes,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "host_link_bound_ms": max(link_ms, bytes_ms, ops_ms),
               "host_link_share": max(link_ms, bytes_ms, ops_ms) / ms,
               "link_GBps": n * wpb * 4 / (ms * 1e-3) / 1e9,
               "device_resident_GBps": nbytes / (resident_ms * 1e-3) / 1e9}
        if (n, wpb) == HEADLINE_SHAPE:
            row.update(blockhash_call(rng))
        rows.append(row)
        emit("kernel", name="blockhash", **row)
        del words, words_cpu, pows
    torch.cuda.empty_cache()
    return rows


def blockhash_call(rng, reps: int = 200, threads: int = 4) -> dict:
    """The host's time for one ``ops.checksum_batch`` at one commit (63
    random blocks of 4096 bytes), as the journal calls it: the median of
    ``reps`` calls on the host clock; the same calls split by stage, from
    the stamps ``ops._Staging.hash`` keeps of its last call (each stage's
    median; ``entry`` is the device lookup before ``hash``, ``return``
    what follows it); the call as the first port made it (per-block padding,
    ``np.stack``, a pageable copy, the checked wrapper, ``.tolist()``) on
    the same blocks; ``threads`` callers at once, each with its own
    blocks, which the staging lock serialises (calls a second, all
    threads together, against one thread's); and ``torch.profiler``'s CPU
    operations over 20 calls."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.blockhash import kernel as K
    from repro_torch.kernels.blockhash import ops

    def commit():
        return [rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
                for _ in range(HEADLINE_SHAPE[0])]

    blocks = commit()
    want = [ops.ref.blockhash_np(b) for b in blocks]
    dev = torch.device("cuda", torch.cuda.current_device())
    st = ops.staging(dev)
    assert ops.checksum_batch(blocks, device=dev) == want

    def host_ms(fn):
        for _ in range(10):
            fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def parent_call():
        words = torch.from_numpy(np.stack([
            np.frombuffer(b + b"\0" * (-len(b) % 4), dtype=np.uint32)
            for b in blocks]).view(np.int32)).to(dev)
        out = K.blockhash_batch(words, ops._pows(words.shape[1], dev))
        return [x & 0xFFFFFFFF for x in out.tolist()]

    assert parent_call() == want
    l0 = K.launches()
    call = host_ms(lambda: ops.checksum_batch(blocks, device=dev))
    assert K.launches() - l0 == reps + 10  # one launch a call
    parent = host_ms(parent_call)

    split = []
    for _ in range(reps):
        t0 = time.perf_counter()
        got = ops.checksum_batch(blocks, device=dev)
        split.append(np.diff([t0, *st.stamps, time.perf_counter()]) * 1e3)
        assert got == want
    split_ms = dict(zip(("entry", *st.STAGES, "return"),
                        np.median(split, axis=0).tolist()))

    batches = [commit() for _ in range(threads)]
    wants = [[ops.ref.blockhash_np(b) for b in bs] for bs in batches]
    barrier = threading.Barrier(threads)
    got = [None] * threads

    def run(i):
        barrier.wait()
        got[i] = [ops.checksum_batch(batches[i], device=dev)
                  for _ in range(reps)]

    workers = [threading.Thread(target=run, args=(i,))
               for i in range(threads)]
    t0 = time.perf_counter()
    for th in workers:
        th.start()
    for th in workers:
        th.join()
    together_s = time.perf_counter() - t0
    assert got == [[w] * reps for w in wants]

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(20):
            ops.checksum_batch(blocks, device=dev)
    top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"call_ms": call, "parent_call_ms": parent,
            "call_split_ms": split_ms,
            "calls_per_s_one_thread": 1e3 / call,
            f"calls_per_s_{threads}_threads": threads * reps / together_s,
            "call_profile_top": [
                {"name": e.key[:60], "self_cpu_us_per_call":
                 e.self_cpu_time_total / 20, "count": e.count}
                for e in top[:8]]}


def phase_bento():
    """The main path: a bento mount on the card, driven by the fileserver
    and varmail mixes and 128-entry Mount.submit batches, with the
    launch counter set to 0 just before and read just after."""
    from repro_torch.fs.mounts import make_mount
    from repro_torch.kernels.blockhash import kernel as K

    def drive(mf, launches=None):
        v = mf.view
        spent = time_checksums(mf.services)
        t0 = time.perf_counter()
        n_fs = fileserver(v, 120)
        t1 = time.perf_counter()
        n_vm = varmail(v, 120)
        t2 = time.perf_counter()
        n_sb, calls, launched = submit_batches(mf, 8, launches=launches)
        t3 = time.perf_counter()
        return {"fileserver_ops_per_s": n_fs / (t1 - t0),
                "varmail_ops_per_s": n_vm / (t2 - t1),
                "submit_ops_per_s": n_sb / (t3 - t2),
                "ops": n_fs + n_vm + n_sb, "wall_s": t3 - t0,
                "checksum_s": spent["s"],
                "checksum_share": spent["s"] / (t3 - t0)}, calls, launched

    mf = make_mount("bento", n_blocks=32768)  # device defaults to cuda
    ks = mf.services
    c0 = checksum_calls(ks)
    K.reset_launches()
    rates, calls, launched = drive(mf, launches=K.launches)
    main_launches = K.launches()
    delta = checksum_calls(ks) - c0
    assert main_launches > 0 and main_launches == delta, (main_launches, delta)
    assert calls == [1] * len(calls) and launched == [1] * len(launched), (
        calls, launched)
    blocks = ks.counters["checksum_blocks"]
    mf.close()

    cpu = make_mount("bento", n_blocks=32768, device="cpu")
    cpu_rates, cpu_calls, _ = drive(cpu)
    cpu.close()
    same = np.array_equal(image(mf.dev), image(cpu.dev))
    assert same, "bento image on cuda differs from the cpu run"
    assert cpu_calls == calls
    emit("bento", launches=main_launches, checksum_batch_calls=delta,
         checksum_ms_per_call=rates["checksum_s"] / delta * 1e3,
         blocks_per_launch=blocks / max(1, ks.counters["checksum_batch_calls"]),
         launches_per_flushed_batch=launched, image_identical_to_cpu=same,
         cuda=rates, cpu=cpu_rates)
    return main_launches, rates


def phase_trace():
    """Where the time goes on the card: a short fileserver + varmail window
    on a bento mount under ``torch.profiler``; the device's busy time is
    the sum of its kernels' and copies' own times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fs.mounts import make_mount

    mf = make_mount("bento", n_blocks=32768)
    fileserver(mf.view, 10, root="/warm")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ops = fileserver(mf.view, 40) + varmail(mf.view, 40)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    mf.close()
    # the raw events' window against key_averages()'s, on this small
    # profile: the training and serve profiles read the raw events alone
    fast, ref = device_window(prof), _device_window(prof.key_averages())
    assert fast.keys() == ref.keys() and all(
        fast[k][1] == ref[k][1] and math.isclose(fast[k][0], ref[k][0],
                                                 rel_tol=1e-6, abs_tol=1e-3)
        for k in ref), (fast, ref)
    by_name = {k[:60]: v for k, v in ref.items()}
    busy_s = sum(us for us, _ in by_name.values()) * 1e-6
    assert busy_s > 0, "the profiler saw no device time"
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    emit("trace", ops=ops, wall_s=wall, device_busy_s=busy_s,
         device_idle_share=1 - busy_s / wall,
         device_top=[{"name": k, "us": us, "count": c}
                     for k, (us, c) in top])


def phase_other_kinds():
    from repro_torch.fs.mounts import make_mount
    from repro_torch.kernels.blockhash import kernel as K

    for kind in ("vfs", "ext4like"):
        mf = make_mount(kind, n_blocks=16384)
        ks = mf.services
        c0, l0 = checksum_calls(ks), K.launches()
        t0 = time.perf_counter()
        ops = fileserver(mf.view, 40) + varmail(mf.view, 40)
        wall = time.perf_counter() - t0
        launches = K.launches() - l0
        assert launches > 0 and launches == checksum_calls(ks) - c0
        mf.close()
        cpu = make_mount(kind, n_blocks=16384, device="cpu")
        fileserver(cpu.view, 40)
        varmail(cpu.view, 40)
        cpu.close()
        same = np.array_equal(image(mf.dev), image(cpu.dev))
        assert same, f"{kind} image on cuda differs from the cpu run"
        emit(kind, launches=launches, ops=ops, ops_per_s=ops / wall,
             launches_per_op=launches / ops, image_identical_to_cpu=same)


def phase_dedup():
    from repro_torch.core.interface import Errno, FsError
    from repro_torch.fs.mounts import make_mount
    from repro_torch.kernels.blockhash import kernel as K

    mf = make_mount("dedup-bento", n_blocks=32768)
    v, ks, fs = mf.view, mf.services, mf.mount.module
    c0, l0 = checksum_calls(ks), K.launches()

    # a 4:1 duplicate corpus (fs_micro --dedup): 24 files of 8 blocks
    # drawn from a pool of 48 unique blocks, in flushed batches of 8 files
    rng = np.random.default_rng(7)
    pool = [rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
            for _ in range(48)]
    files = {f"/d{f:03d}": b"".join(pool[int(rng.integers(48))]
                                    for _ in range(8)) for f in range(24)}
    paths = sorted(files)
    free0 = v.statfs()["free_blocks_est"]
    for i in range(0, len(paths), 8):
        v.write_many([(p, 0, files[p]) for p in paths[i:i + 8]],
                     create=True, fsync=True)
    physical = free0 - v.statfs()["free_blocks_est"]
    saving = 24 * 8 / max(1, physical)
    assert saving >= 2.0, saving

    # corrupt one data block behind the cache: EIO on exactly its file
    solo = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    v.write_file("/solo", solo)
    v.fsync("/solo")
    blk = fs._bmap_ro(fs._iget(v.stat("/solo").ino), 0, {})
    raw = bytearray(mf.dev.read_block(blk))
    raw[:16] = b"torn-by-smoke!!!"
    mf.dev.write_block(blk, bytes(raw))
    ks.sb_invalidate_blocks(fs.sb_cap, [blk])
    got = v.read_many([(p, 0, len(files[p])) for p in paths] + ["/solo"],
                      strict=False)
    bad = [p for p, r in zip(paths + ["/solo"], got)
           if isinstance(r, FsError)]
    assert bad == ["/solo"] and got[-1].errno == Errno.EIO, bad
    assert all(r == files[p] for p, r in zip(paths, got))

    # a file larger than the buffer cache (4096 blocks), read back whole in
    # three verified reads of 2048 blocks: each fetches its blocks from the
    # device and hashes them in one launch. (One read of the whole file
    # fails with EIO in both packages: BufferCache.bread_many evicts hits
    # of its own request while inserting the misses — ROADMAP Queue 3.)
    big_blocks, piece = 6144, 2048
    chunk = 48
    for b0 in range(0, big_blocks, chunk):
        v.write_many([("/big", (b0 + i) * 4096,
                       (b"%08d" % (b0 + i)) * 512) for i in range(chunk)],
                     create=True, fsync=True)
    verified0 = fs._blockstore.stats["verified_blocks"]
    b_calls0, b_blocks0 = (ks.counters["checksum_batch_calls"],
                           ks.counters["checksum_blocks"])
    data = b"".join(v.read_many([("/big", off * 4096, piece * 4096)])[0]
                    for off in range(0, big_blocks, piece))
    assert len(data) == big_blocks * 4096
    assert all(data[i * 4096:i * 4096 + 8] == b"%08d" % i
               for i in range(0, big_blocks, 97))
    verified = fs._blockstore.stats["verified_blocks"] - verified0
    read_calls = ks.counters["checksum_batch_calls"] - b_calls0
    read_blocks = ks.counters["checksum_blocks"] - b_blocks0
    launches = K.launches() - l0
    assert launches > 0 and launches == checksum_calls(ks) - c0
    assert verified >= 1000 and read_calls >= 1, (verified, read_calls)
    emit("dedup-bento", space_saving=saving, eio_files=bad,
         launches=launches, big_file_blocks=big_blocks,
         big_read_verified_blocks=verified, big_read_launches=read_calls,
         big_read_blocks_per_launch=read_blocks / read_calls,
         checksum_blocks_per_call=ks.counters["checksum_blocks"]
         / ks.counters["checksum_batch_calls"])
    mf.close()


def phase_parallel_drain(threads: int = 4, blocks: int = 512,
                         piece: int = 128, rounds: int = 4):
    """Verified reads from ``threads`` submitters at once on a dedup-bento
    mount, first with the serial drain, then with a pool of ``threads``
    workers (``Mount.enable_parallel_drain``), which runs read-only
    groups on different files at once, so their checksum calls meet at
    the blockhash staging lock. Each submitter reads its own file of
    ``blocks`` blocks in pieces of ``piece``, ``rounds`` times, the files'
    blocks dropped from the buffer cache before each round, so every read
    fetches from the device and hashes what it fetched. (The files
    together stay inside the cache: a request that meets a full cache
    can evict its own hits, the reference's fault in ROADMAP Queue 3.)
    Every read is checked; launches equal checksum calls; the host ms per
    checksum call (the lock's wait included) and the wall time, serial
    against parallel."""
    import threading

    from repro_torch.core.interface import SubmissionEntry
    from repro_torch.fs.mounts import make_mount
    from repro_torch.kernels.blockhash import kernel as K

    mf = make_mount("dedup-bento", n_blocks=32768)
    v, ks, m = mf.view, mf.services, mf.mount
    fs = m.module
    paths = [f"/p{t}" for t in range(threads)]

    def content(t, blk):
        return (b"%4s%012d" % (paths[t].encode(), blk)) * 256

    for t, path in enumerate(paths):
        for b0 in range(0, blocks, 48):
            v.write_many([(path, b * 4096, content(t, b))
                          for b in range(b0, min(b0 + 48, blocks))],
                         create=True, fsync=True)
    # made beforehand, so the readers hold the interpreter lock briefly
    want = {(t, b0): b"".join(content(t, b) for b in range(b0, b0 + piece))
            for t in range(threads) for b0 in range(0, blocks, piece)}
    inos = [v.stat(path).ino for path in paths]
    homes = [fs._bmap_ro(fs._iget(ino), b, {}) for ino in inos
             for b in range(blocks)]
    spent = time_checksums(ks)
    stats = fs._blockstore.stats

    def read_all():
        bad = []

        def run(t, barrier):
            barrier.wait()
            for b0 in range(0, blocks, piece):
                comp, = m.submit([SubmissionEntry(
                    "read", (inos[t], b0 * 4096, piece * 4096))])
                if not comp.ok or comp.result != want[t, b0]:
                    bad.append((t, b0, comp.errno))

        c0, l0, s0 = checksum_calls(ks), K.launches(), spent["s"]
        v0, x0 = stats["verified_blocks"], stats["corruptions_detected"]
        wall = 0.0
        for _ in range(rounds):
            ks.sb_invalidate_blocks(fs.sb_cap, homes)
            barrier = threading.Barrier(threads)
            workers = [threading.Thread(target=run, args=(t, barrier))
                       for t in range(threads)]
            t0 = time.perf_counter()
            for th in workers:
                th.start()
            for th in workers:
                th.join()
            wall += time.perf_counter() - t0
        calls = checksum_calls(ks) - c0
        assert not bad and stats["corruptions_detected"] == x0, (
            bad[:4], stats["corruptions_detected"] - x0)
        assert stats["verified_blocks"] - v0 == rounds * len(homes)
        assert calls > 0 and K.launches() - l0 == calls, (
            calls, K.launches() - l0)
        return {"wall_s": wall, "checksum_calls": calls,
                "verified_blocks": stats["verified_blocks"] - v0,
                "checksum_ms_per_call": (spent["s"] - s0) / calls * 1e3,
                "checksum_share": (spent["s"] - s0) / wall}

    serial = read_all()
    m.enable_parallel_drain(threads)
    parallel = read_all()
    mf.close()
    emit("parallel_drain", threads=threads, file_blocks=blocks, piece=piece,
         rounds=rounds, serial=serial, parallel=parallel)


def _crash_image(device, point: int, torn: int = -1):
    """On a fresh bento mount: a durable /keep, then /f written and lost
    ``point`` device writes into the fsync that commits it."""
    from repro_torch.fs.blockdev import BlockDeviceError
    from repro_torch.fs.mounts import make_mount

    mf = make_mount("bento", n_blocks=4096, device=device)
    v = mf.view
    v.write_file("/keep", b"k" * 9000)
    v.fsync("/keep")
    v.write_file("/f", bytes(range(256)) * 48)
    mf.dev.fail_after_writes = point
    mf.dev.fail_torn_bytes = torn
    mf.dev._writes_seen = 0
    try:
        v.fsync("/f")
    except BlockDeviceError:
        return image(mf.dev).copy()
    raise AssertionError(f"no crash at write {point}")


def _header_index(device) -> int:
    from repro_torch.fs.mounts import make_mount

    mf = make_mount("bento", n_blocks=4096, device=device)
    v = mf.view
    v.write_file("/keep", b"k" * 9000)
    v.fsync("/keep")
    v.write_file("/f", bytes(range(256)) * 48)
    logstart = mf.mount.module.geo.logstart
    seen = []
    orig = mf.dev.write_block

    def spy(blockno, data):
        seen.append((blockno, any(data[:4])))
        orig(blockno, data)

    mf.dev.write_block = spy
    v.fsync("/f")
    return seen.index((logstart, True))


def _recover(img, device, torch_dev: bool = False):
    from repro_torch.core.services import kernel_binding
    from repro_torch.fs.blockdev import MemBlockDevice, TorchBlockDevice
    from repro_torch.fs.mounts import DirectMount
    from repro_torch.fs.xv6 import Xv6FileSystem, Xv6Options

    dev = (TorchBlockDevice.from_image(img, device=device) if torch_dev
           else MemBlockDevice.from_image(img))
    ks = kernel_binding(dev, device=device)
    fs = Xv6FileSystem(Xv6Options(group_commit=True, batched_install=True))
    fs.init(ks.superblock(), ks)
    return image(dev).copy(), DirectMount(fs), ks


def phase_recovery():
    from repro_torch.core.interface import ROOT_INO
    from repro_torch.fs.mounts import make_mount
    from repro_torch.fs.posix import PosixView
    from repro_torch.kernels.blockhash import kernel as K

    hdr = _header_index("cuda")
    assert hdr == _header_index("cpu") and hdr >= 2
    results = {}
    for case, point, torn in (("after_commit_record", hdr + 1, -1),
                              ("torn_commit_record", hdr, 20)):
        img = _crash_image("cuda", point, torn)
        assert np.array_equal(img, _crash_image("cpu", point, torn))
        l0 = K.launches()
        rec_cuda, m, ks = _recover(img, "cuda")
        launches = K.launches() - l0
        rec_cpu, _, _ = _recover(img, "cpu")
        assert np.array_equal(rec_cuda, rec_cpu), case
        installed = int((rec_cuda != img).any(axis=1).sum())
        if case == "after_commit_record":
            assert installed > 2
            ino = m.lookup(ROOT_INO, "f").ino
            assert m.read(ino, 0, 1 << 14) == bytes(range(256)) * 48
        else:
            assert installed == 0
        # the probe, plus the recovery's one checksum of the journal
        assert launches == 1 + ks.counters["checksum_batch_calls"] >= 2
        results[case] = {"blocks_installed": installed, "launches": launches}

    # an image built by the plain path (device="cpu"; the CPU tests hold
    # it byte-identical to the JAX reference's) opens on the card
    ref = make_mount("ext4like", n_blocks=4096, device="cpu")
    ref.view.makedirs("/etc")
    ref.view.write_file("/etc/motd", b"built on the host\n" * 300)
    ref.close()
    for torch_dev in (False, True):
        _img, m, _ks = _recover(image(ref.dev), "cuda", torch_dev=torch_dev)
        v = PosixView(m)
        assert v.read_file("/etc/motd") == b"built on the host\n" * 300
    emit("recovery", header_write=hdr, cases=results,
         host_image_reads_back_on_card=True)


def phase_upgrade():
    from repro_torch.core.upgrade import upgrade
    from repro_torch.fs.ext4like import Ext4LikeFileSystem
    from repro_torch.fs.mounts import make_mount
    from repro_torch.kernels.blockhash import kernel as K

    def run(device):
        mf = make_mount("bento", n_blocks=16384, device=device)
        v = mf.view
        fileserver(v, 30)
        l0 = K.launches()
        stats = upgrade(mf.mount, Ext4LikeFileSystem(),
                        migrate=lambda s, o, n: {**s, "dirindex": {}})
        assert type(mf.mount.module).__name__ == "Ext4LikeFileSystem"
        l1 = K.launches()
        varmail(v, 30)
        fileserver(v, 20, root="/srv2")
        assert len(v.listdir("/srv")) > 0
        l2 = K.launches()
        mf.close()
        return mf, stats, (l0, l1, l2)

    mf, stats, (l0, l1, l2) = run("cuda")
    cpu, _, _ = run("cpu")
    assert l2 > l1 >= l0
    same = np.array_equal(image(mf.dev), image(cpu.dev))
    assert same, "upgraded image on cuda differs from the cpu run"
    emit("upgrade", pause_ms=stats["total_s"] * 1e3,
         launches_after_upgrade=l2 - l1, image_identical_to_cpu=same)


# --- the sixth slice: overlay tenants, provenance, FUSE, crash sweeps --------------


def blockhash_launches(run):
    """Run ``run()`` with the blockhash launch count set to 0 just before;
    returns (its result, the launches it made)."""
    from repro_torch.kernels.blockhash import kernel as K

    K.reset_launches()
    out = run()
    return out, K.launches()


def counted(run):
    """``blockhash_launches(run)`` that also tallies what should have
    launched: every kernel binding made on a CUDA device in the window
    (its bind-time probe) and every ``checksum``/``checksum_batch`` call
    on such a binding's services. Returns (result, launches, tally)."""
    from repro_torch.core.services import KernelServices as KS

    tally = {"calls": 0, "probes": 0}
    real_init, real_one, real_batch = KS.__init__, KS.checksum, KS.checksum_batch

    def on_card(ks):
        return ks.binding == "kernel" and ks.device.type == "cuda"

    def init(self, *args, **kw):
        real_init(self, *args, **kw)
        tally["probes"] += on_card(self)

    def one(self, data):
        tally["calls"] += on_card(self)
        return real_one(self, data)

    def batch(self, blocks):
        tally["calls"] += on_card(self)
        return real_batch(self, blocks)

    KS.__init__, KS.checksum, KS.checksum_batch = init, one, batch
    try:
        out, launches = blockhash_launches(run)
    finally:
        KS.__init__, KS.checksum, KS.checksum_batch = \
            real_init, real_one, real_batch
    return out, launches, tally


def overlay_run(device) -> dict:
    """benchmarks/fs_coldstart.run in the port: ``tenants`` overlay tenants
    over ONE base image, then, in each, a read of base content, a private
    write over a base file (copy-up), a new file and a whiteout; then the
    same number of whole-image copies (the benchmark's ``provision_copy``:
    every block through read_block/write_block, then a mount)."""
    from repro_torch.core.registry import mount as bento_mount
    from repro_torch.core.services import kernel_binding
    from repro_torch.fs.blockdev import MemBlockDevice
    from repro_torch.fs.mounts import build_base_image, overlay_tenant
    from repro_torch.fs.posix import PosixView
    from repro_torch.fs.xv6 import Xv6FileSystem, Xv6Options

    n, kind = OVERLAY["tenants"], OVERLAY["fs_kind"]

    def motd(t):  # longer than the base's, which write_file does not cut
        return b"tenant %02d motd, private to this tenant\n" % t

    image = build_base_image(kind, OVERLAY["base_blocks"], device=device)
    image0, writes0 = image._data.copy(), image.writes

    def tenants_path():
        t0 = time.perf_counter()
        tenants = [overlay_tenant(image, kind, device=device)
                   for _ in range(n)]
        lazy_s = time.perf_counter() - t0
        at_provision = [t.mount.module.opts.base_dev.provider_blocks_fetched
                        for t in tenants]
        for t, mf in enumerate(tenants):
            v = mf.view
            assert v.read_file("/etc/hostname") == b"golden\n"
            assert v.read_file("/usr/share/words") == \
                b"alpha beta gamma delta\n" * 64
            v.write_file("/etc/motd", motd(t))  # copy-up over a base file
            v.write_file("/private", b"tenant %d" % t)
            v.unlink("/readme")  # whiteout over a base name
            v.fsync("/private")
        for t, mf in enumerate(tenants):  # no tenant sees another's writes
            v = mf.view
            assert v.read_file("/etc/motd") == motd(t)
            assert v.read_file("/private") == b"tenant %d" % t
            assert not v.exists("/readme")
            assert v.read_file("/etc/hostname") == b"golden\n"
        fetched = [t.mount.module.opts.base_dev.provider_blocks_fetched
                   for t in tenants]
        for mf in tenants:
            mf.close()
        return tenants, lazy_s, at_provision, fetched

    (tenants, lazy_s, at_provision, fetched), launches = \
        blockhash_launches(tenants_path)
    assert image.writes == writes0 and np.array_equal(image._data, image0), \
        "a tenant wrote to the base image"
    counted = sum(checksum_calls(mf.services)
                  + checksum_calls(mf.mount.module.base.ks)
                  for mf in tenants)

    t0 = time.perf_counter()
    copies = []
    for _ in range(n):
        dev = MemBlockDevice(image.n_blocks)
        for b in range(image.n_blocks):
            dev.write_block(b, image.read_block(b))
        ks = kernel_binding(dev, device=device)
        m = bento_mount("copy-tenant", ks, module=Xv6FileSystem(
            Xv6Options(group_commit=True, batched_install=True)))
        copies.append(m)
    copy_s = time.perf_counter() - t0
    for m in copies:
        assert PosixView(m).read_file("/etc/hostname") == b"golden\n"
        m.unmount()
    return {"image": image, "tenants": tenants, "launches": launches,
            "counted_calls": counted, "lazy_s": lazy_s, "copy_s": copy_s,
            "fetched_at_provision": at_provision, "fetched": fetched}


def phase_overlay():
    """CoW overlay tenants on the card (every upper's and base's commit
    and recovery through the blockhash kernel), each tenant's upper image
    held byte-identical to the same run on the CPU."""
    n = OVERLAY["tenants"]
    cuda = overlay_run("cuda")
    cpu = overlay_run("cpu")
    # each overlay_tenant binds twice (upper, base): one probe launch each
    probes = 2 * n
    assert cuda["launches"] > probes, cuda["launches"]
    assert cuda["launches"] == cuda["counted_calls"] + probes, (
        cuda["launches"], cuda["counted_calls"], probes)
    assert cuda["counted_calls"] == cpu["counted_calls"]
    assert np.array_equal(cuda["image"]._data, cpu["image"]._data)
    same = all(np.array_equal(image(a.dev), image(b.dev))
               for a, b in zip(cuda["tenants"], cpu["tenants"]))
    assert same, "an overlay upper on cuda differs from the cpu run"
    emit("overlay", tenants=n, base_blocks=OVERLAY["base_blocks"],
         launches=cuda["launches"], probe_launches=probes,
         checksum_calls=cuda["counted_calls"],
         provision_ms_per_tenant=1e3 * cuda["lazy_s"] / n,
         copy_ms_per_tenant=1e3 * cuda["copy_s"] / n,
         copy_over_provision=cuda["copy_s"] / cuda["lazy_s"],
         blocks_fetched_at_provision_max=max(cuda["fetched_at_provision"]),
         blocks_fetched_per_tenant_max=max(cuda["fetched"]),
         uppers_identical_to_cpu=same,
         cpu={"provision_ms_per_tenant": 1e3 * cpu["lazy_s"] / n,
              "copy_ms_per_tenant": 1e3 * cpu["copy_s"] / n})
    return cuda["launches"]


class Submitter:
    """benchmarks/fs_upgrade._Submitter: rounds of a chained create →
    write(PrevResult) pair plus a getattr through ``mount.submit``, each
    round's completions checked against its submissions and bracketed by
    the mount's generation."""

    def __init__(self, mount, dino: int, t: int, payload: bytes):
        self.m, self.dino, self.t, self.payload = mount, dino, t, payload
        self.rounds, self.errors = [], []

    def run(self, stop) -> None:
        from repro_torch.core.interface import (PrevResult, SQE_LINK,
                                                SubmissionEntry)

        r = 0
        while not stop.is_set():
            name = f"t{self.t}_r{r:05d}"
            entries = [
                SubmissionEntry("create", (self.dino, name),
                                user_data=(r, "c"), flags=SQE_LINK),
                SubmissionEntry("write", (PrevResult("ino"), 0, self.payload),
                                user_data=(r, "w")),
                SubmissionEntry("getattr", (self.dino,), user_data=(r, "g")),
            ]
            gen_before = self.m.generation
            try:
                comps = self.m.submit(entries)
            except Exception as e:  # noqa: BLE001 — asserted by the phase
                self.errors.append(f"t{self.t} r{r}: {type(e).__name__}: {e}")
                return
            gen_after = self.m.generation
            if [c.user_data for c in comps] != [e.user_data for e in entries]:
                self.errors.append(f"t{self.t} r{r}: completions lost/"
                                   f"reordered: {[c.user_data for c in comps]}")
            elif not all(c.ok for c in comps) \
                    or comps[1].result != len(self.payload):
                self.errors.append(
                    f"t{self.t} r{r}: bad completion "
                    f"{[(c.user_data, c.errno, c.result) for c in comps]}")
            self.rounds.append({"name": name, "t_end": time.perf_counter(),
                                "gen_before": gen_before,
                                "gen_after": gen_after})
            r += 1


def phase_prov_upgrade():
    """benchmarks/fs_upgrade.run_under_load on the card: the provenance
    layer swapped onto a live bento mount and off again (plain → prov →
    plain) while 4 submitters hammer it, with its tripwires asserted."""
    import threading

    from repro_torch.core.upgrade import unwrap_layer, wrap_layer
    from repro_torch.fs.mounts import make_mount
    from repro_torch.fs.prov import ProvFilesystem
    from repro_torch.kernels.blockhash import kernel as K

    mf = make_mount("bento", n_blocks=UPGRADE["n_blocks"])
    m, v, ks = mf.mount, mf.view, mf.services
    phase_s = UPGRADE["phase_s"]
    subs = []
    for t in range(UPGRADE["submitters"]):
        v.makedirs(f"/w{t}")
        subs.append(Submitter(m, v.stat(f"/w{t}").ino, t, b"p" * 1024))
    stop = threading.Event()
    threads = [threading.Thread(target=s.run, args=(stop,), daemon=True)
               for s in subs]

    def swap_dance():
        t_start = time.perf_counter()
        for th in threads:
            th.start()
        time.sleep(phase_s)                          # plain window
        t_wrap, l_wrap = time.perf_counter(), K.launches()
        wrap = wrap_layer(m, ProvFilesystem)
        prov_gen = m.generation
        time.sleep(phase_s)                          # prov window
        t_unwrap = time.perf_counter()
        unwrap = unwrap_layer(m)
        l_unwrap = K.launches()
        time.sleep(phase_s)                          # plain again
        stop.set()
        for th in threads:
            th.join(timeout=30)
        return (t_start, t_wrap, t_unwrap, wrap, unwrap, prov_gen,
                l_unwrap - l_wrap)

    c0 = checksum_calls(ks)
    (t_start, t_wrap, t_unwrap, wrap, unwrap, prov_gen, prov_launches), \
        launches = blockhash_launches(swap_dance)
    assert launches > 0 and launches == checksum_calls(ks) - c0, (
        launches, checksum_calls(ks) - c0)
    assert not any(th.is_alive() for th in threads), "submitter deadlocked"
    errors = [e for s in subs for e in s.errors]
    assert not errors, errors[:5]

    wrap_layer(m, ProvFilesystem)  # re-wrap adopts the durable log
    logged = {r["name"] for r in v.read_provenance() if r["op"] == "create"}
    unwrap_layer(m)
    n_prov = n_plain = 0
    for s in subs:
        in_log = [r["name"] in logged for r in s.rounds]
        if True in in_log:
            first = in_log.index(True)
            last = len(in_log) - 1 - in_log[::-1].index(True)
            assert all(in_log[first:last + 1]), \
                f"t{s.t}: provenance window not contiguous"
        for r, lg in zip(s.rounds, in_log):
            if r["gen_before"] == r["gen_after"] == prov_gen:
                n_prov += 1
                assert lg, f"{r['name']} completed under prov, not logged"
            elif r["gen_after"] < prov_gen or r["gen_before"] > prov_gen:
                n_plain += 1
                assert not lg, f"{r['name']} completed plain, yet logged"
    assert n_prov > 0 and n_plain > 0, (n_prov, n_plain)
    budget = UPGRADE["pause_budget_s"]
    assert wrap["total_s"] < budget and unwrap["total_s"] < budget

    def rate(t0, t1):
        k = sum(1 for s in subs for r in s.rounds if t0 <= r["t_end"] < t1)
        return 3 * k / max(t1 - t0, 1e-9)

    gap = 0.0
    for s in subs:
        ts = [r["t_end"] for r in s.rounds]
        gap = max([gap] + [b - a for a, b in zip(ts, ts[1:])])
    plain_rate = rate(t_start, t_wrap)
    prov_rate = rate(t_wrap + wrap["total_s"], t_unwrap)
    rounds = sum(len(s.rounds) for s in subs)
    for s in subs:  # every round's file intact after the last unwrap
        assert len(v.listdir(f"/w{s.t}")) == len(s.rounds)
        assert v.read_file(f"/w{s.t}/{s.rounds[-1]['name']}") == s.payload
    mf.close()
    emit("prov_upgrade", submitters=len(subs), rounds=rounds,
         records=len(logged), prov_certain_rounds=n_prov,
         plain_certain_rounds=n_plain, failed=0,
         wrap_ms=1e3 * wrap["total_s"], unwrap_ms=1e3 * unwrap["total_s"],
         wrap_quiesce_ms=1e3 * wrap["quiesce_s"],
         wrap_transfer_ms=1e3 * wrap["transfer_s"],
         unwrap_quiesce_ms=1e3 * unwrap["quiesce_s"],
         unwrap_transfer_ms=1e3 * unwrap["transfer_s"],
         max_completion_gap_ms=1e3 * gap, plain_ops_per_s=plain_rate,
         prov_ops_per_s=prov_rate, prov_over_plain=prov_rate / plain_rate,
         launches=launches, prov_window_launches=prov_launches)
    return launches


def fs_mix(mf) -> dict:
    """The bento phase's mix: fileserver and varmail at 120 loops, then 8
    submissions of 128 writes + fsync; every read-back checked."""
    v = mf.view
    t0 = time.perf_counter()
    ops = fileserver(v, 120) + varmail(v, 120)
    ops += submit_batches(mf, 8)[0]
    wall = time.perf_counter() - t0
    want = b"".join(bytes([(7 + i) % 251]) * 512 for i in range(128))
    assert v.read_file("/batch.dat") == want
    return {"ops": ops, "wall_s": wall, "ops_per_s": ops / wall}


def phase_fuse():
    """The paper's Table 2 FUSE row on this host: the same mix on a fuse
    mount (xv6 in a daemon process behind a unix socket, userspace
    binding: crc32 over a file-backed device, no kernel) and on a bento
    mount on the card."""
    from repro_torch.fs.mounts import make_mount

    mf = make_mount("fuse", n_blocks=32768)
    calls = [0]
    real_call = mf.mount.call

    def counted_call(op, *args, **kw):
        calls[0] += 1
        return real_call(op, *args, **kw)

    mf.mount.call = counted_call  # PosixView's ops all reach it
    try:
        fuse = fs_mix(mf)
        stats = mf.mount.ctl("stats")
        assert stats["scalar_requests"] == calls[0], (stats, calls[0])
        assert stats["batch_requests"] == mf.mount.mq_submissions == 8, stats
    finally:
        mf.close()

    bento = make_mount("bento", n_blocks=32768)
    c0 = checksum_calls(bento.services)
    result, launches = blockhash_launches(lambda: fs_mix(bento))
    assert launches > 0 and launches == checksum_calls(bento.services) - c0
    bento.close()
    emit("fuse", fuse=fuse, bento=result, daemon_stats=stats,
         client_calls=calls[0],
         fuse_over_bento=fuse["ops_per_s"] / result["ops_per_s"],
         bento_launches=launches)
    return launches


def crash_sweeps(device) -> dict:
    """Each of ``TORTURES``, quick, on xv6: crash points, and each point's
    (crashed, recovered image digest); the launches on a CUDA device,
    beside the counted checksum calls and bind-time probes."""
    import hashlib

    from repro_torch.fs import crashsim

    seen = []
    real_run_one = crashsim.CrashSim.run_one

    def run_one(self, *args, **kw):
        rec = real_run_one(self, *args, **kw)
        seen.append((rec.crash_point, rec.crashed,
                     hashlib.sha256(rec.dev._data.tobytes()).hexdigest()))
        return rec

    out = {}
    crashsim.CrashSim.run_one = run_one
    try:
        for name in TORTURES:
            del seen[:]
            t0 = time.perf_counter()
            points, launches, tally = counted(
                lambda: getattr(crashsim, name)("xv6", quick=True,
                                                device=device))
            out[name] = {"points": points, "verdicts": list(seen),
                         "launches": launches, **tally,
                         "s": time.perf_counter() - t0}
    finally:
        crashsim.CrashSim.run_one = real_run_one
    return out


def phase_crash():
    """The crash simulator's quick sweeps with every mount, commit and
    recovery checksummed on the card, then on the CPU: each sweep's crash
    points, which of them crashed and each recovered image must be
    identical. Provenance records carry ``ks.time()``, which is pinned for
    both runs so the log's bytes repeat."""
    from repro_torch.core.services import KernelServices

    real_time = KernelServices.time
    KernelServices.time = lambda self: 1.7e9
    try:
        cuda = crash_sweeps("cuda")
        cpu = crash_sweeps("cpu")
    finally:
        KernelServices.time = real_time
    for name in TORTURES:
        a, b = cuda[name], cpu[name]
        assert a["points"] == b["points"] == len(a["verdicts"]) > 5, name
        assert a["verdicts"] == b["verdicts"], f"{name}: cuda != cpu"
        assert a["launches"] > 0, name
        assert a["launches"] == a["calls"] + a["probes"], (name, a)
        assert b["launches"] == b["calls"] == b["probes"] == 0, (name, b)
    emit("crash", **{name: {"points": cuda[name]["points"],
                            "crashed": sum(c for _, c, _ in
                                           cuda[name]["verdicts"]),
                            "launches": cuda[name]["launches"],
                            "checksum_calls": cuda[name]["calls"],
                            "probe_launches": cuda[name]["probes"],
                            "s": cuda[name]["s"], "cpu_s": cpu[name]["s"]}
                     for name in TORTURES}, verdicts_identical_to_cpu=True)
    ckpt = "torture_ckpt_shards"
    return (sum(cuda[n]["launches"] for n in TORTURES if n != ckpt),
            cuda[ckpt]["launches"])


# --- the seventh slice: sharded checkpoints, resharding, the data shards ------------

# benchmarks/fs_reshard.py at its full (non --quick) sizes on port mounts:
# the elastic restores at scale 4 on a bento mount of 65536 blocks, the
# serial-vs-overlapped restores at scale 32 through the FUSE daemon, 8
# overlay tenants and 6 dedup copies at scale 3; then the token shards of
# SyntheticLM(rwkv6-7b, batch 4, seq 1024).
RESHARD = {"elastic_scale": 4, "elastic_blocks": 65536, "overlap_scale": 32,
           "overlap_blocks": 65536, "overlap_depth": 2, "overlap_reps": 4,
           "tenants": 8, "tenant_scale": 3, "tenant_base_blocks": 8192,
           "dedup_copies": 6, "dedup_scale": 3, "dedup_blocks": 32768}
RESHARD_SPECS = {"w1": ("data", "model"), "w2": ("model", "data"),
                 "e": ("model", None), "b": ("data",), "r": (), "s": ()}
RESHARD_TOPOS = {"same": (2, 2), "halved": (1, 2), "doubled": (4, 2)}
DATA = {"arch": "rwkv6-7b", "batch": 4, "seq": 1024, "shards": 8,
        "n_blocks": 16384}
# layer 0 of rwkv6-7b at its published shapes, saved from (data, model) =
# (2, 2) and restored onto (1, 2) and (4, 2), virtual meshes of the card
CKPT_MODEL = {"arch": "rwkv6-7b", "layer": 0, "n_blocks": 1 << 17,
              "mesh": (2, 2), "targets": {"halved": (1, 2), "doubled": (4, 2)}}


def reshard_host(scale: int) -> dict:
    """benchmarks/fs_reshard._host_tree: the same seeded arrays."""
    rng = np.random.default_rng(7)
    return {
        "w1": rng.normal(size=(64 * scale, 32 * scale)).astype(np.float32),
        "w2": rng.normal(size=(32 * scale, 16 * scale)).astype(np.float32),
        "e": rng.normal(size=(16 * scale, 8 * scale)).astype(np.float32),
        "b": rng.normal(size=(64 * scale,)).astype(np.float32),
        "r": rng.normal(size=(8, 8)).astype(np.float32),
        "s": np.float32(1.25),
    }


def _whole(t, device="cpu"):
    """A restored leaf whole on ``device``: a MeshArray (a MeshSharding
    target's) gathered from its positions."""
    from repro_torch.distributed.sharding import MeshArray

    return t.gather(device) if isinstance(t, MeshArray) else t.to(device)


def _on(t, dev) -> bool:
    """Whether a restored leaf lies on ``dev``, every position of it."""
    return all(s.device == dev for s in getattr(t, "shards", [t]))


def _same(tree, host) -> bool:
    import torch

    return all(torch.equal(_whole(tree[k]), torch.from_numpy(np.array(v)))
               for k, v in host.items())


def _mesh_shardings(shape, device, specs=RESHARD_SPECS):
    """MeshShardings over a virtual mesh of ``device`` (one card as
    data x model cells)."""
    from repro_torch.distributed.sharding import MeshSharding
    from repro_torch.launch.mesh import make_elastic_mesh

    d, m = shape
    mesh = make_elastic_mesh(d, m, devices=[device] * (d * m))
    return {k: MeshSharding(mesh, spec) for k, spec in specs.items()}


def shard_files_plain(view, man) -> bytes:
    """Read every shard file of the manifest ``man`` back from ``view``
    and hold its checksum to the numpy hash of its bytes (no launch), so
    a kernel that hashes wide rows wrongly but repeatably cannot pass on
    its own agreement; returns the widest file's bytes."""
    from repro_torch.kernels.blockhash import ref

    widest = b""
    for rec in man["leaves"]:
        for sh in rec["shards"]:
            raw = view.read_file(sh["path"])
            assert ref.blockhash_np(raw) == sh["checksum"], sh["path"]
            widest = max(widest, raw, key=len)
    return widest


def _plan(stats) -> list:
    """A restore's per-leaf record without its metered peak: the peak of
    a prefetching restore (depth >= 2) depends on how far the fetch
    thread runs ahead, so only its bound repeats from run to run."""
    return [{k: v for k, v in s.items() if k != "peak_bytes"}
            for s in stats["leaves"]]


def _strict(stats) -> list:
    """Streamed leaves whose target cells are proper sub-cells: their host
    peak must stay below the full leaf."""
    strict = [s for s in stats["leaves"]
              if s["streamed"] and s["max_target_bytes"] < s["full_bytes"]]
    for s in strict:
        assert s["peak_bytes"] < s["full_bytes"], s
    return strict


def reshard_elastic(device) -> dict:
    """fs_reshard.run_elastic: save on (2, 2), restore onto the same, the
    halved (1, 2) and the doubled (4, 2) mesh, every shard checksummed and
    every fetched chunk hashed through the kernel binding on ``device``."""
    import torch

    from repro_torch import checkpoint as ckpt
    from repro_torch.device import resolve_device
    from repro_torch.fs.mounts import make_mount

    dev = resolve_device(device)
    host = reshard_host(RESHARD["elastic_scale"])
    tree = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in host.items()}
    mf = make_mount("bento", n_blocks=RESHARD["elastic_blocks"], device=dev)
    ks = mf.services
    t0 = time.perf_counter()
    man = ckpt.save(mf.view, "/ck/step_1", tree, step=1, checksum=ks.checksum,
                    shardings=_mesh_shardings((2, 2), dev))
    save_s = time.perf_counter() - t0
    assert man["version"] == 2
    n_files = sum(len(r["shards"]) for r in man["leaves"])
    assert n_files > len(man["leaves"]), "nothing actually sharded"
    like = {k: torch.zeros(v.shape) for k, v in host.items()}
    out = {"manifest": man, "save_s": save_s, "shard_files": n_files,
           "leaf_bytes_total": sum(v.nbytes for v in host.values()),
           "restores": {}}
    for name, shape in RESHARD_TOPOS.items():
        stats = {}
        t0 = time.perf_counter()
        back, _ = ckpt.load(mf.view, "/ck/step_1", like,
                            checksum=ks.checksum,
                            checksum_batch=ks.checksum_batch,
                            sharding_tree=_mesh_shardings(shape, dev),
                            stats=stats, device=dev)
        restore_s = time.perf_counter() - t0
        assert all(_on(t, dev) for t in back.values())
        assert _same(back, host), f"elastic/{name}: a leaf differs"
        strict = _strict(stats)
        assert len(strict) >= 2, (name, stats["leaves"])
        out["restores"][name] = {
            "mesh": list(shape), "restore_s": restore_s,
            "leaves": stats["leaves"], "strict_leaves": len(strict),
            "worst_peak_fraction": max(s["peak_bytes"] / s["full_bytes"]
                                       for s in strict)}
    mf.close()
    out["image"] = image(mf.dev)
    return out


def reshard_overlap(device) -> dict:
    """fs_reshard.run_overlap: serial (depth 0) against overlapped (depth
    2) restores through the FUSE daemon, best of 4 each, on the halved and
    doubled meshes; the shard checksums and the fetched chunks' hashes are
    the blockhash kernel's on ``device``, through one kernel binding there
    (the daemon's own services hash with crc32). Speeds are reported, not
    held to a bar; bytes and host peaks are."""
    import torch

    from repro_torch import checkpoint as ckpt
    from repro_torch.core.services import kernel_binding
    from repro_torch.device import resolve_device
    from repro_torch.fs.blockdev import MemBlockDevice
    from repro_torch.fs.mounts import make_mount

    dev = resolve_device(device)
    ks = kernel_binding(MemBlockDevice(1), device=dev)
    cks, cks_b = ks.checksum, ks.checksum_batch
    depth, reps = RESHARD["overlap_depth"], RESHARD["overlap_reps"]
    host = reshard_host(RESHARD["overlap_scale"])
    like = {k: torch.zeros(v.shape) for k, v in host.items()}
    mf = make_mount("fuse", n_blocks=RESHARD["overlap_blocks"])
    try:
        tree = {k: torch.from_numpy(np.array(v)).to(dev)
                for k, v in host.items()}
        man = ckpt.save(mf.view, "/ck/step_1", tree, step=1, checksum=cks,
                        shardings=_mesh_shardings((2, 2), dev))
        shard_files_plain(mf.view, man)
        out = {"depth": depth, "cells": {},
               "leaf_bytes_total": sum(v.nbytes for v in host.values())}
        serial_total = piped_total = 0.0
        for name in ("halved", "doubled"):
            def restore(dep, stats=None, on=dev):
                sh_b = _mesh_shardings(RESHARD_TOPOS[name], on)
                return ckpt.load(mf.view, "/ck/step_1", like, checksum=cks,
                                 checksum_batch=cks_b, sharding_tree=sh_b,
                                 stats=stats, pipeline_depth=dep,
                                 device=on)[0]

            restore(depth)  # warm-up: one-off costs of a new target
            best = {}
            for dep in (0, depth):
                best[dep] = (1e9, None)
                for _ in range(reps):
                    stats = {}
                    t0 = time.perf_counter()
                    back = restore(dep, stats)
                    dt = time.perf_counter() - t0
                    if dt < best[dep][0]:
                        best[dep] = (dt, stats)
                assert _same(back, host), f"overlap/{name} depth {dep}"
            (serial_s, serial_stats), (piped_s, piped_stats) = \
                best[0], best[depth]
            serial_total += serial_s
            piped_total += piped_s
            serial_peak = {s["leaf"]: s["peak_bytes"]
                           for s in serial_stats["leaves"]}
            for s in piped_stats["leaves"]:
                if s["streamed"]:
                    assert s["peak_bytes"] <= depth * serial_peak[s["leaf"]]
            assert len(_strict(piped_stats)) >= 2
            # the same restore onto the CPU: the same bytes, the same peaks
            cpu_stats = {}
            assert _same(restore(depth, cpu_stats, torch.device("cpu")), host)
            assert _plan(cpu_stats) == _plan(piped_stats)
            assert len(_strict(cpu_stats)) >= 2
            out["cells"][name] = {
                "mesh": list(RESHARD_TOPOS[name]), "serial_s": serial_s,
                "pipelined_s": piped_s, "speedup": serial_s / piped_s,
                "pipeline": piped_stats["pipeline"],
                "serial_pipeline": serial_stats["pipeline"]}
        out["speedup_combined"] = serial_total / piped_total
    finally:
        mf.close()
    return out


def _virtual_ckpt_save(view, root: str, host: dict):
    """fs_reshard._virtual_ckpt_save: a 2x2 ShardGrid on every 2-d leaf."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.distributed.resharding import ShardGrid

    grids = {k: (ShardGrid.from_spec(v.shape, ("d", "m"), {"d": 2, "m": 2})
                 if len(v.shape) == 2 and min(v.shape) >= 2 else None)
             for k, v in host.items()}
    return ckpt.save(view, root, host, step=1, shardings=grids)


def reshard_tenants(device) -> dict:
    """fs_reshard.run_tenants: 8 CoW overlay tenants over one base image
    carrying the checkpoint each restore it onto ``device``."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.fs.mounts import build_base_image, overlay_tenant

    n = RESHARD["tenants"]
    host = reshard_host(RESHARD["tenant_scale"])
    img = build_base_image(
        "xv6", n_blocks=RESHARD["tenant_base_blocks"], device=device,
        populate=lambda v: _virtual_ckpt_save(v, "/ckpt/step_1", host))
    img_bytes0 = img._data.tobytes()
    t0 = time.perf_counter()
    tenants = [overlay_tenant(img, "xv6", device=device) for _ in range(n)]
    provision_s = time.perf_counter() - t0
    like = {k: np.zeros(v.shape, v.dtype) for k, v in host.items()}
    t0 = time.perf_counter()
    fetched = []
    for t, mf in enumerate(tenants):
        assert ckpt.latest_step(mf.view, "/ckpt") == 1
        back, man = ckpt.load(mf.view, "/ckpt/step_1", like, device=device)
        assert man["version"] == 2 and _same(back, host), f"tenant {t}"
        mf.view.write_file("/private", b"tenant %d" % t)
        fetched.append(mf.mount.module.opts.base_dev.provider_blocks_fetched)
    restore_s = time.perf_counter() - t0
    assert tenants[0].view.read_file("/private") == b"tenant 0"
    assert img._data.tobytes() == img_bytes0, "a restore wrote the base"
    frac = max(fetched) / img.n_blocks
    assert frac <= 0.25, f"restore materialized {frac:.0%} of the base"
    for mf in tenants:
        mf.close()
    return {"tenants": n, "provision_s": provision_s,
            "restore_ms_per_tenant": 1e3 * restore_s / n,
            "materialized_fraction": frac, "base": img._data.copy(),
            "uppers": [image(mf.dev).copy() for mf in tenants]}


def reshard_dedup(device) -> dict:
    """fs_reshard.run_dedup: 6 identical checkpoints on a dedup mount
    cost about one physically."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.fs.mounts import make_mount

    n = RESHARD["dedup_copies"]
    host = reshard_host(RESHARD["dedup_scale"])
    mf = make_mount("dedup-bento", n_blocks=RESHARD["dedup_blocks"],
                    device=device)
    free0 = mf.view.statfs()["free_blocks_est"]
    _virtual_ckpt_save(mf.view, "/t0/ckpt", host)
    first = free0 - mf.view.statfs()["free_blocks_est"]
    for t in range(1, n):
        _virtual_ckpt_save(mf.view, f"/t{t}/ckpt", host)
    st = mf.view.statfs()
    marginal = (free0 - st["free_blocks_est"] - first) / (n - 1)
    saved = st["free_blocks_logical_est"] - st["free_blocks_est"]
    assert marginal <= 0.30 * first, (marginal, first)
    assert saved >= (n - 1) * first * 0.5, (saved, first)
    like = {k: np.zeros(v.shape, v.dtype) for k, v in host.items()}
    back, _ = ckpt.load(mf.view, f"/t{n - 1}/ckpt", like, device=device)
    assert _same(back, host), "a dedup'd checkpoint differs"
    mf.close()
    return {"copies": n, "first_cost_blocks": first,
            "marginal_blocks_per_copy": marginal, "saved_blocks": saved,
            "image": image(mf.dev).copy()}


def data_shards(device) -> dict:
    """The data tier: SyntheticLM(rwkv6-7b, batch 4, seq 1024) written as
    token shards on a bento mount (every commit hashed on ``device``),
    read back through FsShardReader behind a Prefetcher; each batch must
    be SyntheticLM.batch's, and goes to torch only at the consumer."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.data import (FsShardReader, Prefetcher, SyntheticLM,
                                  write_shards)
    from repro_torch.device import resolve_device
    from repro_torch.fs.mounts import make_mount

    dev = resolve_device(device)
    ds = SyntheticLM(registry.get(DATA["arch"]).model, DATA["batch"],
                     DATA["seq"], seed=0)
    mf = make_mount("bento", n_blocks=DATA["n_blocks"], device=dev)
    t0 = time.perf_counter()
    write_shards(mf.view, ds, n_shards=DATA["shards"])
    write_s = time.perf_counter() - t0
    rd = FsShardReader(mf.view)
    pf = Prefetcher(rd.read, depth=2)
    t0 = time.perf_counter()
    tokens = 0
    try:
        for want in range(DATA["shards"]):
            step, b = pf.next()
            ref = ds.batch(want)
            assert step == want and sorted(b) == sorted(ref)
            assert all(np.array_equal(b[k], ref[k]) for k in ref), want
            toks = torch.from_numpy(b["tokens"]).to(dev)
            tokens += toks.numel()
    finally:
        pf.close()
    read_s = time.perf_counter() - t0
    mf.close()
    return {"shards": DATA["shards"], "batch": DATA["batch"],
            "seq": DATA["seq"], "write_s": write_s, "read_s": read_s,
            "tokens_per_s": tokens / read_s, "retries": rd.retries}


def phase_ckpt_reshard():
    """benchmarks/fs_reshard.py in the port at its full sizes, on port
    mounts on the card, then the data shards; the elastic, tenant and
    dedup parts and the data shards again with ``device="cpu"``: the same
    manifests, host peaks and device images. Launches must equal the
    counted checksum calls plus the bind-time probes."""
    def run(device):
        return {"elastic": reshard_elastic(device),
                "tenants": reshard_tenants(device),
                "dedup": reshard_dedup(device), "data": data_shards(device)}

    t0 = time.perf_counter()
    (cuda, overlap), launches, tally = counted(
        lambda: (run("cuda"), reshard_overlap("cuda")))
    cuda_s = time.perf_counter() - t0
    assert launches > 0
    assert launches == tally["calls"] + tally["probes"], (launches, tally)
    t0 = time.perf_counter()
    cpu = run("cpu")
    cpu_s = time.perf_counter() - t0
    el, el_cpu = cuda["elastic"], cpu["elastic"]
    assert el["manifest"] == el_cpu["manifest"]
    for name in RESHARD_TOPOS:
        assert _plan(el["restores"][name]) == \
            _plan(el_cpu["restores"][name]), name
    assert np.array_equal(el["image"], el_cpu["image"])
    ten, ten_cpu = cuda["tenants"], cpu["tenants"]
    assert np.array_equal(ten["base"], ten_cpu["base"])
    assert all(np.array_equal(a, b)
               for a, b in zip(ten["uppers"], ten_cpu["uppers"]))
    assert np.array_equal(cuda["dedup"]["image"], cpu["dedup"]["image"])
    emit("ckpt_reshard", launches=launches, checksum_calls=tally["calls"],
         probe_launches=tally["probes"],
         identical_to_cpu=True, seconds=cuda_s, cpu_seconds=cpu_s,
         elastic={"leaf_bytes_total": el["leaf_bytes_total"],
                  "shard_files": el["shard_files"],
                  "save_ms": 1e3 * el["save_s"],
                  "restores": {n: {k: v for k, v in r.items()
                                   if k != "leaves"}
                               for n, r in el["restores"].items()}},
         overlap=overlap,
         tenants={k: v for k, v in ten.items() if k not in ("base", "uppers")},
         dedup={k: v for k, v in cuda["dedup"].items() if k != "image"},
         data=cuda["data"], data_cpu=cpu["data"])
    return launches


def phase_torch_device():
    from repro_torch.core.registry import mount as bento_mount
    from repro_torch.core.services import kernel_binding
    from repro_torch.fs.blockdev import MemBlockDevice, TorchBlockDevice
    from repro_torch.fs.posix import PosixView
    from repro_torch.fs.xv6 import Xv6FileSystem, Xv6Options, mkfs

    out = {}
    images = {}
    tdev = TorchBlockDevice(8192)  # the image on the card
    for name, dev in (("torch_block_device", tdev),
                      ("mem_block_device", MemBlockDevice(8192))):
        ks = kernel_binding(dev)
        mkfs(ks)
        m = bento_mount("xv6", ks, module=Xv6FileSystem(Xv6Options(
            group_commit=True, batched_install=True)))
        t0 = time.perf_counter()
        ops = fileserver(PosixView(m), 30)
        m.unmount()
        out[name] = ops / (time.perf_counter() - t0)
        images[name] = image(dev)
    same = np.array_equal(images["torch_block_device"],
                          images["mem_block_device"])
    assert same, "TorchBlockDevice image differs from MemBlockDevice"
    emit("torch_block_device", image_on=str(tdev._data.device),
         ops_per_s=out, image_identical=same)



# --- the rwkv6 serve (models/rwkv -> kernels/wkv6 -> csrc/wkv6.cu) ----------------------


def wkv6_work(B, S, H, K, V, C, esize):
    """(bytes, product operations, other operations) of one WKV6 scan, from
    the formulas in csrc/wkv6.cu's header: each input read once (r, k, v,
    w, u in their dtype, the state in f32), each output written once (y
    and the state in f32). The products are the four matrix products: the
    multiply-adds of r and k under the decays, tmp v (the u bonus on tmp's
    diagonal included), (r exp(Le)) S and kd^T v. The rest is logw, the
    cumulative sums, the decays' exponentials and every scaling. An exp, a
    compare, and a multiply-add's two halves count one operation each."""
    P = C * (C - 1) // 2
    products = (2 * P * K                    # r k^T, s < t
                + 2 * P * V + 2 * C * V      # tmp v, the bonus with it
                + 2 * C * K * V              # (r exp(Le)) S
                + 2 * C * K * V)             # kd^T v
    other = (4 * C * K                       # logw = -exp(w), cumsum, Le
             + 5 * P * K                     # sub, clip, exp, times A
             + 3 * C * K                     # sum_k r u k
             + 2 * C * K + C * V             # r exp(Le), add
             + 3 * C * K + K                 # k exp(Li_last - Li), exp(Li_last)
             + 2 * K * V)                    # decay S
    nbytes = ((B * S * H * (3 * K + V) + H * K) * esize
              + B * S * H * V * 4 + 2 * B * H * K * V * 4)
    n = B * H * (S // C)
    return nbytes, n * products, n * other


def wkv6_bound(B, S, H, K, V, C, dtype):
    """The least time of one WKV6 scan: the bytes at the HBM rate, or the
    operations at the peak rate of their type, added: for bf16 inputs the
    products at the tensor cores' bf16 rate and the rest at the CUDA
    cores' float32 rate, for float32 inputs all at the CUDA cores' rate.
    ``earlier_bound_ms`` is the bound the CUDA-core kernel was given:
    every operation at the CUDA cores' rate, whatever the dtype."""
    esize = 2 if dtype == "bfloat16" else 4
    nbytes, products, other = wkv6_work(B, S, H, K, V, C, esize)
    prod_rate = (BF16_TENSOR_OPS_PER_S if dtype == "bfloat16"
                 else CUDA_CORE_OPS_PER_S)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (products / prod_rate + other / CUDA_CORE_OPS_PER_S) * 1e3
    earlier_ms = max(bytes_ms,
                     (products + other) / CUDA_CORE_OPS_PER_S * 1e3)
    return {"bytes": nbytes, "product_ops": products, "other_ops": other,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "earlier_bound_ms": earlier_ms}


def wkv6_inputs(rng, B, S, H, K, V, regime):
    """r, k, v, w, u, state as float32 numpy arrays. ``smoke`` draws w as
    tests/test_kernels.py does (N(0, 0.3): a decay of about 0.37 a token);
    ``strong``, w ~ N(2, 1), decays down to exp(-50) a token or less;
    ``weak``, w ~ N(-4, 0.5), about 0.98 a token."""
    n = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    r, k, v = n(B, S, H, K) * 0.5, n(B, S, H, K) * 0.5, n(B, S, H, V)
    w = {"smoke": lambda: n(B, S, H, K) * 0.3,
         "strong": lambda: 2.0 + n(B, S, H, K),
         "weak": lambda: -4.0 + 0.5 * n(B, S, H, K)}[regime]()
    return r, k, v, w, n(H, K) * 0.3, n(B, H, K, V) * 0.1


def phase_wkv6_kernel():
    """Hold the CUDA WKV6 scan against the plain version on the card, in
    f32 and bf16, at every shape and, at the serve's shape, under strong
    and weak decay: y and the state each within 1e-4 x max(1, max|ref|)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.wkv6 import kernel as K
    from repro_torch.kernels.wkv6 import ref

    rng = np.random.default_rng(2025)
    dev = torch.device("cuda")
    cases = [(shape, "smoke") for shape in WKV6_SHAPES] + [
        (WKV6_HEADLINE[0], regime) for regime in ("strong", "weak")]
    rows = []
    for (B, S, H, Kd, V, C), regime in cases:
        arrays = wkv6_inputs(rng, B, S, H, Kd, V, regime)
        # the plain version takes 15-18 ms a call at the big shapes: 3
        # replays of 1 call there (the smoke's seconds)
        big = B * S * H >= 1 << 16
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            dt = getattr(torch, dtype)
            r, k, v, w, u = (torch.from_numpy(a).to(dev, dt)
                             for a in arrays[:5])
            s0 = torch.from_numpy(arrays[5]).to(dev)
            y, st = K.wkv6_chunked(r, k, v, w, u, s0, chunk=C)
            y_ref, st_ref = ref.wkv6(r, k, v, w, u, s0, chunk=C)
            torch.cuda.synchronize()
            errs, ok = [], True
            finite = bool(torch.isfinite(y).all() and torch.isfinite(st).all())
            for got, want in ((y, y_ref), (st, st_ref)):
                err = (got - want).abs().max().item()
                ok &= err <= WKV6_TOL * max(1.0, want.abs().max().item())
                errs.append(err)
            assert finite and ok, (f"wkv6 disagrees at {(B, S, H, Kd, V, C)} "
                                   f"{dtype} {regime}: {errs}")
            ms = device_ms(lambda: K.wkv6_chunked(r, k, v, w, u, s0, chunk=C),
                           **KERNEL_TIMING)
            plain_ms = device_ms(lambda: ref.wkv6(r, k, v, w, u, s0, chunk=C),
                                 count=1 if big else 20,
                                 reps=3 if big else 20)
            row = {"shape": [B, S, H, Kd, V, C], "dtype": dtype,
                   "regime": regime,
                   "tensor_cores": K.uses_tensor_cores(Kd, V, C,
                                                       r.element_size()),
                   "max_abs_err": max(errs), "y_err": errs[0],
                   "state_err": errs[1],
                   "y_scale": y_ref.abs().max().item(),
                   "state_scale": st_ref.abs().max().item(),
                   "within_tol": ok, "ms": ms, "plain_ms": plain_ms,
                   "seconds": time.perf_counter() - t0,
                   **wkv6_bound(B, S, H, Kd, V, C, dtype)}
            row["share_of_bound"] = row["bound_ms"] / ms
            rows.append(row)
            emit("wkv6_kernel", **row)
            del r, k, v, w, u, s0, y, st, y_ref, st_ref
    serve = WKV6_HEADLINE[0][3:]
    emit("wkv6_kernel_build", ptxas=ptxas_lines("wkv6"),
         smem_bytes_serve={"bfloat16": K.smem_bytes(*serve, 2),
                           "float32": K.smem_bytes(*serve, 4)},
         blocks_per_sm_by_smem_serve={
             "bfloat16": _build.blocks_per_sm(K.smem_bytes(*serve, 2)),
             "float32": _build.blocks_per_sm(K.smem_bytes(*serve, 4))})
    torch.cuda.empty_cache()
    return rows


def phase_serve_rwkv6():
    """The model path: rwkv6-7b at full width and depth in bf16, seeded
    random weights on the card, batch 4, a 1024-token prompt and 32
    greedy tokens through serve.step, with the wkv6 count set to 0 just
    before and read after the prefill and after each decode step. Then the
    same prefill through the plain version, in bf16 and in f32, and the
    smoke config on the card against the CPU path, which the CPU tests hold
    to the reference."""
    import functools

    import torch

    from repro_torch.configs import registry
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.kernels.wkv6 import kernel as K
    from repro_torch.kernels.wkv6 import ops
    from repro_torch.models import lm, params as P
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    bundle = registry.get(SERVE["arch"])
    base = torch.cuda.memory_allocated()  # what the card holds already
    cfg, run = bundle.model, bundle.run
    ctx = ShardingCtx.null()
    dev = torch.device("cuda")
    B, prompt, gen = SERVE["batch"], SERVE["prompt"], SERVE["gen"]

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    prm = P.materialize(lm.param_specs(cfg), g, dev, dtype=run.compute_dtype)
    tokens = torch.randint(0, cfg.vocab_size, (B, prompt), generator=g,
                           device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    materialize_s = time.perf_counter() - t0
    leaves = list(P.leaves(prm))
    n_params = sum(t.numel() for t in leaves)
    assert n_params == 7_576_621_056, n_params
    assert (cfg.num_layers, cfg.d_model) == (32, 4096)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)

    prefill = make_prefill_step(cfg, run, ctx)
    decode = make_decode_step(cfg, run, ctx)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    tok, cache = prefill(prm, {"tokens": tokens})
    ids = [tok.cpu()]
    prefill_cold_s = time.perf_counter() - t0
    prefill_launches = K.launches()
    step_launches = []
    t0 = time.perf_counter()
    for i in range(gen - 1):
        l0 = K.launches()
        tok, cache = decode(prm, cache, {"tokens": tok[:, None],
                                         "pos": prompt + i})
        ids.append(tok.cpu())
        step_launches.append(K.launches() - l0)
    decode_s = time.perf_counter() - t0
    main_launches = K.launches()
    peak = torch.cuda.max_memory_allocated()
    assert prefill_launches == cfg.num_layers, prefill_launches
    assert step_launches == [0] * (gen - 1), step_launches
    ids = torch.stack(ids, dim=1).numpy()
    assert ids.shape == (B, gen) and ((0 <= ids) & (ids < cfg.vocab_size)).all()
    del cache

    def timed_prefill(params, rn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = lm.prefill_fn(cfg, rn, ctx, params, {"tokens": tokens})
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def through_ref(fn):
        """``fn()`` with ``ops.wkv6`` pointed at the plain version."""
        kernel_wkv = ops.wkv6
        ops.wkv6 = functools.partial(kernel_wkv, use_kernel=False)
        l0 = K.launches()
        out = fn()
        ops.wkv6 = kernel_wkv
        assert K.launches() == l0, "the plain prefill launched the kernel"
        return out

    def rel_by_layer(a, b):
        return [((x - y).abs().max() / y.abs().max()).item()
                for x, y in zip(a, b)]

    def logits_err(a, b):
        scale = max(1.0, b.float().abs().max().item())
        return (a.float() - b.float()).abs().max().item(), scale

    # The same bf16 prefill, warm, through the kernel and the plain
    # version. Layer 0's scan sees identical inputs in both, so its state
    # must agree to f32 rounding; from there each layer's y is rounded to
    # bf16, where an f32 difference near a rounding boundary flips an ulp,
    # and 32 random layers amplify such flips. So the logits are held in
    # f32 below, with the same weights, and reported here.
    (logits, cache), prefill_s = timed_prefill(prm, run)
    (logits_ref, cache_ref), prefill_ref_s = through_ref(
        lambda: timed_prefill(prm, run))
    assert logits.shape == (B, cfg.vocab_size)
    assert torch.isfinite(logits).all() and torch.isfinite(logits_ref).all()
    wkv_rel = rel_by_layer(cache["wkv"], cache_ref["wkv"])
    assert wkv_rel[0] <= 1e-4, f"layer 0 wkv state differs: {wkv_rel[0]}"
    bf16_err, bf16_scale = logits_err(logits, logits_ref)
    first_token_repeats = bool(
        (logits.argmax(-1).cpu().numpy() == ids[:, 0]).all())
    del cache, cache_ref

    # The same prefill in f32 (the bf16 weights widened exactly; matmuls
    # in full f32, TF32 off), through the kernel and the plain version:
    # the last-token logits within 2e-2 x max(1, max|logits|).
    assert not torch.backends.cuda.matmul.allow_tf32
    prm32 = P.tree_map(lambda t: t.float(), prm)
    run32 = run.replace(compute_dtype="float32")
    (logits32, cache32), prefill_f32_s = timed_prefill(prm32, run32)
    (logits32_ref, cache32_ref), _ = through_ref(
        lambda: timed_prefill(prm32, run32))
    wkv32_rel = rel_by_layer(cache32["wkv"], cache32_ref["wkv"])
    assert wkv32_rel[0] <= 1e-4, f"layer 0 f32 wkv state: {wkv32_rel[0]}"
    f32_err, f32_scale = logits_err(logits32, logits32_ref)
    assert f32_err <= 2e-2 * f32_scale, (f32_err, f32_scale)
    bf16_vs_f32_err, _ = logits_err(logits, logits32)
    # the kernel moves the bf16 logits less than bf16 itself moves them
    assert bf16_err < bf16_vs_f32_err, (bf16_err, bf16_vs_f32_err)
    SERVE_F32_LOGITS["serve_rwkv6"] = logits32.cpu()  # serve_mesh_rwkv6's
    del prm32, cache32, cache32_ref, logits_ref, logits32_ref
    torch.cuda.empty_cache()

    # the smoke config in f32, every leaf random, on the card (the CUDA
    # kernel) against the CPU (the plain version)
    smoke, srun = bundle.smoke, run.replace(compute_dtype="float32")
    gcpu = torch.Generator().manual_seed(1)
    sprm = P.materialize(lm.param_specs(smoke), gcpu, "cpu")
    for t in P.leaves(sprm):
        t.add_(0.1 * torch.randn(t.shape, generator=gcpu))
    stoks = torch.randint(0, smoke.vocab_size, (2, 4 * smoke.scan_chunk),
                          generator=gcpu, dtype=torch.int32)
    sprm_dev = P.tree_map(lambda t: t.to(dev), sprm)
    l0 = K.launches()
    with torch.inference_mode():
        s_cpu, _ = lm.prefill_fn(smoke, srun, ctx, sprm, {"tokens": stoks})
        s_dev, _ = lm.prefill_fn(smoke, srun, ctx, sprm_dev,
                                 {"tokens": stoks.to(dev)})
    assert K.launches() - l0 == smoke.num_layers
    smoke_err = (s_dev.cpu() - s_cpu).abs().max().item()
    smoke_scale = max(1.0, s_cpu.abs().max().item())
    assert smoke_err <= 1e-4 * smoke_scale, (smoke_err, smoke_scale)

    emit("serve_rwkv6", arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, params=n_params, param_bytes=param_bytes,
         dtype=run.compute_dtype, batch=B, prompt=prompt, gen=gen,
         materialize_s=materialize_s,
         prefill_ms=prefill_s * 1e3, prefill_cold_ms=prefill_cold_s * 1e3,
         prefill_ref_ms=prefill_ref_s * 1e3,
         prefill_f32_ms=prefill_f32_s * 1e3,
         decode_ms_per_token=decode_s / (gen - 1) * 1e3,
         tokens_per_s=B * (gen - 1) / decode_s,
         request_tokens_per_s=B * gen / (prefill_cold_s + decode_s),
         peak_memory_bytes=peak,
         base_memory_bytes=base,
         wkv6_launches_per_prefill=prefill_launches,
         wkv6_launches_per_decode_step=max(step_launches),
         generated_ids_row0=ids[0].tolist(),
         first_token_repeats_in_warm_prefill=first_token_repeats,
         wkv_rel_err_by_layer=wkv_rel, logits_bf16_max_abs_err=bf16_err,
         logits_bf16_scale=bf16_scale,
         wkv_rel_err_by_layer_f32=wkv32_rel, logits_f32_max_abs_err=f32_err,
         logits_f32_scale=f32_scale, logits_bf16_vs_f32_err=bf16_vs_f32_err,
         smoke_card_vs_cpu_err=smoke_err)
    return main_launches, prm, tokens, logits


def _paired(a, b):
    """(leaf of ``a``, leaf of ``b``) at each key path of two trees of
    nested dicts, whatever their key order."""
    if isinstance(b, dict):
        for k in b:
            yield from _paired(a[k], b[k])
    else:
        yield a, b


def phase_ckpt_model(prm, tokens, logits_serve):
    """A real model's weights at full width: every leaf of rwkv6-7b's
    layer 0 (d_model 4096, d_ff 14336) on the card, sharded by the port's
    ShardingCtx rules over a virtual (data, model) = (2, 2) mesh and saved
    to a bento mount with the default cache and depth, then restored onto
    (1, 2) and (4, 2): each restored leaf equal to the original, and a
    prefill with layer 0 taken from the restore giving the serve phase's
    logits bit for bit. Launches must equal the counted checksum calls
    plus the bind-time probe. Every shard file, read back from the mount,
    must carry the plain hash of its bytes in the manifest, and the kernel
    is held exactly against its plain version at the widest shard file
    and the widest restore batch the path hashed."""
    import torch

    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import registry
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.fs.mounts import make_mount
    from repro_torch.kernels.blockhash import kernel as K
    from repro_torch.kernels.blockhash import ops
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.models import lm, params as P

    bundle = registry.get(CKPT_MODEL["arch"])
    cfg, run = bundle.model, bundle.run
    dev = torch.device("cuda", torch.cuda.current_device())
    specs = lm.param_specs(cfg)["stack"]
    layer = P.layer(prm["stack"], CKPT_MODEL["layer"])
    leaves = list(P.leaves(layer))
    n_params = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    assert all(t.device == dev and t.is_contiguous() for t in leaves)

    def shardings(shape):
        d, m = shape
        mesh = make_elastic_mesh(d, m, devices=[dev] * (d * m))
        ctx = ShardingCtx.for_mesh(mesh)
        return P.map_specs(
            lambda sp: ctx.sharding(sp.logical[1:], sp.shape[1:]), specs)

    widest = {"file": b"", "batch": []}

    def path():
        mf = make_mount("bento", n_blocks=CKPT_MODEL["n_blocks"], device=dev)
        ks, root = mf.services, "/ckpt/rwkv6_layer0"

        def checksum_batch(blocks):  # the binding's call; keeps the widest
            blocks = list(blocks)
            if sum(map(len, blocks)) > sum(map(len, widest["batch"])):
                widest["batch"] = blocks
            return ks.checksum_batch(blocks)

        t0 = time.perf_counter()
        man = ckpt.save(mf.view, root, layer, step=0, checksum=ks.checksum,
                        shardings=shardings(CKPT_MODEL["mesh"]))
        save_s = time.perf_counter() - t0
        restores, restored = {}, None
        for name, shape in CKPT_MODEL["targets"].items():
            stats = {}
            t0 = time.perf_counter()
            back, _ = ckpt.load(mf.view, root, layer, checksum=ks.checksum,
                                checksum_batch=checksum_batch,
                                sharding_tree=shardings(shape), stats=stats,
                                device=dev)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            pairs = list(_paired(back, layer))
            assert len(pairs) == len(leaves)
            assert all(_on(g, dev) and torch.equal(_whole(g, dev), w)
                       for g, w in pairs), name
            restores[name] = {
                "mesh": list(shape), "restore_s": restore_s,
                "restore_mb_per_s": nbytes / restore_s / 1e6,
                "host_peak_bytes": max(x["peak_bytes"]
                                       for x in stats["leaves"]),
                "largest_leaf_bytes": max(x["full_bytes"]
                                          for x in stats["leaves"]),
                "fetch_s": stats["pipeline"]["fetch_s"],
                "assemble_s": stats["pipeline"]["assemble_s"],
                "overlap_ratio": stats["pipeline"]["overlap_ratio"],
                "depth": stats["pipeline"]["depth"],
                "leaves": stats["leaves"]}
            restored = back
        t0 = time.perf_counter()
        widest["file"] = shard_files_plain(mf.view, man)
        readback_s = time.perf_counter() - t0
        calls = checksum_calls(ks)
        mf.close()
        shard_files = sum(len(r["shards"]) for r in man["leaves"])
        return save_s, restores, restored, shard_files, readback_s, calls, \
            ks.counters["checksum_calls"]

    (save_s, restores, restored, shard_files, readback_s, calls,
     shard_hashes), launches, tally = counted(path)
    assert launches == tally["calls"] + tally["probes"] == calls + 1, (
        launches, tally, calls)
    assert shard_hashes == shard_files  # one launch a shard on the save

    # the kernel at the widest rows the path gave it, on card tensors
    st = ops.staging(dev)
    wide = {}
    for what, blocks in (("save_file", [widest["file"]]),
                         ("restore_batch", widest["batch"])):
        _, words, pows, _, err = blockhash_exact(blocks, dev)
        n, wpb = words.shape

        def launch_pinned():  # the main path's launch, on the staged words
            K.hash_pinned(st.host_words.data_ptr(), ops._pows(wpb, dev)
                          .data_ptr(), st.host_out.data_ptr(), n, wpb,
                          torch.cuda.current_stream().cuda_stream, False)
        bytes_ms = (n * wpb * 4 + wpb * 4 + n * 4) / HBM_BYTES_PER_S * 1e3
        wide[what] = {
            "shape": [n, wpb], "max_abs_err": err,
            "ms": device_ms(launch_pinned, count=3, reps=3),
            "device_resident_ms": device_ms(
                lambda: K.blockhash_batch(words, pows), count=3, reps=3),
            "bound_ms": max(bytes_ms, 2 * n * wpb / CUDA_CORE_OPS_PER_S * 1e3),
            "host_link_bound_ms": max(
                n * wpb * 4 / HOST_LINK_BYTES_PER_S * 1e3, bytes_ms)}
        del words, pows
    del widest["file"], widest["batch"]

    # the prefill with layer 0 from the restore: zeroed first, so the
    # logits can only come out right from the restored bytes
    for w in leaves:
        w.zero_()
    for r, w in _paired(restored, layer):
        w.copy_(_whole(r, dev))
    del restored
    with torch.inference_mode():
        logits, _ = lm.prefill_fn(cfg, run, ShardingCtx.null(), prm,
                                  {"tokens": tokens})
    identical = torch.equal(logits, logits_serve)
    assert identical, "prefill from the restored layer 0 differs"
    torch.cuda.empty_cache()
    emit("ckpt_model", arch=cfg.name, layer=CKPT_MODEL["layer"],
         params=n_params, bytes=nbytes, leaves=len(leaves),
         shard_files=shard_files, mesh=list(CKPT_MODEL["mesh"]),
         n_blocks=CKPT_MODEL["n_blocks"], save_s=save_s,
         save_mb_per_s=nbytes / save_s / 1e6,
         restores={n: {k: v for k, v in r.items() if k != "leaves"}
                   for n, r in restores.items()},
         restore_leaves=restores["doubled"]["leaves"],
         launches=launches, checksum_calls=tally["calls"],
         probe_launches=tally["probes"], shard_checksums=shard_hashes,
         shard_files_read_back=shard_files, readback_s=readback_s,
         kernel_at_widest=wide, logits_identical_to_serve=identical)
    return launches


def device_window(prof) -> dict:
    """(device µs, count) by kernel name of a ``torch.profiler`` profile,
    read from its raw device events: what ``_device_window`` makes of
    its ``key_averages()`` (phase_trace holds the two equal), without
    building the profile's event tree, which took 21 s after one rwkv6
    training step (hundreds of thousands of events)."""
    import torch
    from torch.autograd.profiler_util import _rewrite_name

    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or \
                e.is_hidden_event():
            continue
        key = _rewrite_name(name=e.name(), with_wildcard=True)
        us, n = by_name.get(key, (0.0, 0))
        by_name[key] = (us + e.duration_ns() / 1e3, n + 1)
    return {k: v for k, v in by_name.items() if v[0] > 0}


def _device_window(avgs) -> dict:
    """(device µs, count) by kernel name, from a profile's
    ``key_averages()``: the reference ``device_window`` is held to."""
    import torch

    by_name = {}
    for e in avgs:  # device events only: no double count
        us = e.self_device_time_total
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            by_name[e.key] = (us, e.count)
    return by_name


def _kernel_kind(name: str) -> str:
    """A device kernel's kind, from its name in the profiler: the port's
    SSD, flash and WKV6 kernels, cuBLAS matrix products (``nvjet``, ``gemv`` and
    the older ``gemm``/``xmma`` names), PyTorch's elementwise and
    reduction kernels, copies, or other."""
    low = name.lower()
    for kind, keys in (("ssd", ("ssd_kernel",)), ("flash", ("flash_fwd",)),
                       ("wkv6", ("wkv6_kernel",)),
                       ("matmul", ("gemm", "gemv", "xmma", "nvjet", "cutlass",
                                   "cublas")),
                       ("elementwise", ("elementwise",)),
                       ("reduction", ("reduce",)),
                       ("copy", ("memcpy", "memset", "copy"))):
        if any(k in low for k in keys):
            return kind
    return "other"


def phase_serve_trace(prm, tokens):
    """Where the time goes in the serve: one prefill, then 8 decode steps,
    each under ``torch.profiler``; the device's busy time is the sum of
    its kernels' and copies' own times. The launches are the wkv6 kernel's
    own counter; the profiler's count of wkv6 events is printed beside it,
    since the profiler can lose a share of the device events of a window
    (then every kernel kind comes up short, and the busy time is a lower
    bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.kernels.wkv6 import kernel as K
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    bundle = registry.get(SERVE["arch"])
    cfg, run = bundle.model, bundle.run
    ctx = ShardingCtx.null()
    prefill = make_prefill_step(cfg, run, ctx)
    decode = make_decode_step(cfg, run, ctx)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    l0 = K.launches()
    with profile(activities=acts) as prof_p:
        t0 = time.perf_counter()
        tok, cache = prefill(prm, {"tokens": tokens})
        tok.cpu()
        prefill_wall = time.perf_counter() - t0
    l1 = K.launches()
    with profile(activities=acts) as prof_d:
        t0 = time.perf_counter()
        for i in range(8):
            tok, cache = decode(prm, cache, {"tokens": tok[:, None],
                                             "pos": SERVE["prompt"] + i})
            tok.cpu()
        decode_wall = time.perf_counter() - t0
    l2 = K.launches()
    out = {}
    for name, prof, wall, launched in (
            ("prefill", prof_p, prefill_wall, l1 - l0),
            ("decode_8_steps", prof_d, decode_wall, l2 - l1)):
        by_name = device_window(prof)
        busy_s = sum(us for us, _ in by_name.values()) * 1e-6
        assert busy_s > 0, f"the profiler saw no device time in {name}"
        wkv_us = sum(us for k, (us, _) in by_name.items() if "wkv6" in k)
        wkv_n = sum(c for k, (_, c) in by_name.items() if "wkv6" in k)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        out[name] = {"wall_s": wall, "device_busy_s": busy_s,
                     "device_idle_share": 1 - busy_s / wall,
                     "wkv6_us": wkv_us, "wkv6_launches": launched,
                     "wkv6_events_seen": wkv_n,
                     "wkv6_share_of_device": wkv_us * 1e-6 / busy_s,
                     "device_top": [{"name": k[:80], "us": us, "count": c}
                                    for k, (us, c) in top]}
    pre, dec = out["prefill"], out["decode_8_steps"]
    assert pre["wkv6_launches"] == cfg.num_layers, pre
    assert 0 < pre["wkv6_events_seen"] <= pre["wkv6_launches"], pre
    assert dec["wkv6_launches"] == dec["wkv6_events_seen"] == 0, dec
    emit("serve_trace", **out)


# --- the zamba2 serve (models/mamba2 -> kernels/ssd, kernels/flash_attention) ------------


def bound(nbytes: int, ops: int, dtype: str) -> dict:
    """The least time the card could take: the bytes at the HBM rate, or
    the operations at the peak rate of their type (the tensor cores' bf16
    rate for bf16 inputs, the CUDA cores' float32 rate for float32)."""
    rate = BF16_TENSOR_OPS_PER_S if dtype == "bfloat16" else CUDA_CORE_OPS_PER_S
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rate * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "peak_ops_per_s": rate}


def ssd_work(b, S, H, P, N, C, esize):
    """(bytes, operations) of one SSD scan: each input read once (x, B, C
    in their dtype; dt, A_log, D and the state in f32), each output written
    once (y and the state in f32); the operations of csrc/ssd.cu's header,
    counting only the C(C+1)/2 pairs s <= t of the C x C products, a
    multiply-add's two halves and an exp one operation each. B and C are
    shared by the heads, so the products C_t . B_s are counted once per
    (batch, chunk), everything else once per (batch, head, chunk)."""
    pairs = C * (C + 1) // 2
    shared = 2 * pairs * N                   # C_t . B_s
    per_head = (2 * C                        # dt * A, cumsum
                + 6 * pairs                  # sub, clip, exp, two products
                + 2 * pairs * P              # M x
                + 4 * C                      # exp(Li), the state's weights
                + 2 * C * N * P + 4 * C * P  # exp(Li) (h C_t), D x, sums
                + C * P + 2 * C * P * N + 2 * P * N)  # the state update
    nbytes = ((b * S * H * P + 2 * b * S * N) * esize + b * S * H * 4
              + 2 * H * 4 + b * S * H * P * 4 + 2 * b * H * P * N * 4)
    return nbytes, b * (S // C) * (shared + H * per_head)


def flash_work(B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, esize):
    """(bytes, operations) of one attention forward: q, k, v read once and
    o written once in their dtype; for every admissible (query, key) pair,
    the two D-long products and five operations of the online softmax
    (scale, max, subtract, exp, sum), two more under a softcap."""
    i = np.arange(Sq)
    hi = np.minimum(i, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(Sq, int)
    pairs = int(np.maximum(hi - lo + 1, 0).sum())
    ops = B * Hq * pairs * (4 * D + 5 + (2 if softcap > 0 else 0))
    nbytes = (2 * B * Sq * Hq * D + 2 * B * Skv * Hkv * D) * esize
    return nbytes, ops


def ptxas_lines(name: str) -> list:
    from repro_torch.kernels import _build

    return [ln.strip() for ln in _build.build_log(name).splitlines()
            if any(w in ln for w in ("entry function", "registers", "spill"))]


def phase_ssd_kernel():
    """Hold the CUDA SSD scan against the plain version on the card, in
    f32 and bf16, at every shape: y and the state each within
    2e-4 x max(1, max|ref|)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import kernel as K
    from repro_torch.kernels.ssd import ref

    rng = np.random.default_rng(2026)
    dev = torch.device("cuda")
    rows = []
    for b, S, H, P, N, C in SSD_SHAPES:
        n = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
        arrays = (n(b, S, H, P), np.logaddexp(0, n(b, S, H)).astype(np.float32),
                  n(b, S, N) * 0.5, n(b, S, N) * 0.5, n(H) * 0.3,
                  1 + 0.1 * n(H), n(b, H, P, N) * 0.1)
        big = b * S * H >= 1 << 16
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            x, Bm, Cm = (torch.from_numpy(arrays[i]).to(dev, dt)
                         for i in (0, 2, 3))
            dts, A_log, D, s0 = (torch.from_numpy(arrays[i]).to(dev)
                                 for i in (1, 4, 5, 6))
            args = (x, dts, Bm, Cm, A_log, D, s0)
            y, st = K.ssd_chunked(*args, chunk=C)
            y_ref, st_ref = ref.ssd(*args, chunk=C)
            torch.cuda.synchronize()
            errs, ok = [], True
            for got, want in ((y, y_ref), (st, st_ref)):
                err = (got - want).abs().max().item()
                ok &= err <= SSD_TOL * max(1.0, want.abs().max().item())
                errs.append(err)
            assert ok, f"ssd disagrees at {(b, S, H, P, N, C)} {dtype}: {errs}"
            ms = device_ms(lambda: K.ssd_chunked(*args, chunk=C))
            plain_ms = device_ms(lambda: ref.ssd(*args, chunk=C),
                                 count=5 if big else 20,
                                 reps=10 if big else 20)
            row = {"shape": [b, S, H, P, N, C], "dtype": dtype,
                   "max_abs_err": max(errs), "y_err": errs[0],
                   "state_err": errs[1], "within_tol": ok, "ms": ms,
                   "plain_ms": plain_ms,
                   **bound(*ssd_work(b, S, H, P, N, C, x.element_size()),
                           dtype)}
            row["share_of_bound"] = row["bound_ms"] / ms
            rows.append(row)
            emit("ssd_kernel", **row)
            del x, Bm, Cm, dts, A_log, D, s0, args, y, st, y_ref, st_ref
    emit("ssd_kernel_build", ptxas=ptxas_lines("ssd"),
         smem_bytes_serve={"bfloat16": K.smem_bytes(64, 64, 128, 2),
                           "float32": K.smem_bytes(64, 64, 128, 4)},
         blocks_per_sm_by_smem_serve={
             "bfloat16": _build.blocks_per_sm(K.smem_bytes(64, 64, 128, 2)),
             "float32": _build.blocks_per_sm(K.smem_bytes(64, 64, 128, 4))})
    torch.cuda.empty_cache()
    return rows


def flash_within(got, want, dtype: str) -> tuple:
    """Whether |got - want| <= tol s + tol |want| everywhere, tol FLASH_TOL
    for ``dtype`` and s = min(1, max|want|): the absolute part at the
    output's own scale. With standard-normal inputs a non-causal output
    over Skv keys is about N(0, e / Skv): at 6404 keys its largest value
    is about 0.11, and a flat 2e-2 would pass a kernel that skipped one of
    its key tiles. Returns (within, max |got - want|, tol s)."""
    want = want.float()
    tol = FLASH_TOL[dtype]
    atol = tol * min(1.0, want.abs().max().item())
    diff = (got.float() - want).abs()
    return bool((diff <= atol + tol * want.abs()).all()), \
        diff.max().item(), atol


def flash_dropped_tile(K, q, k, v, want, dtype: str) -> dict:
    """The planted fault: the kernel over all keys but its middle key tile
    (what a kernel that skipped that tile would return), held to the same
    check as the kernel, which must refuse it; and whether a flat
    tol + tol |want| would have passed it."""
    import torch

    a = k.shape[1] // FLASH_KEY_TILE // 2 * FLASH_KEY_TILE
    b = a + FLASH_KEY_TILE
    kd, vd = (torch.cat([x[:, :a], x[:, b:]], dim=1) for x in (k, v))
    bad = K.flash_attention_fwd(q, kd, vd, causal=False)
    within, err, atol = flash_within(bad, want, dtype)
    tol = FLASH_TOL[dtype]
    diff, mag = (bad.float() - want.float()).abs(), want.float().abs()
    outside = (diff > atol + tol * mag).float().mean().item()
    flat_outside = (diff > tol + tol * mag).float().mean().item()
    return {"keys_dropped": [a, b], "max_abs_err": err, "atol": atol,
            "within_tol": within, "share_outside_tol": outside,
            "within_flat_tol": flat_outside == 0,
            "share_outside_flat_tol": flat_outside}


def phase_flash_attention_kernel():
    """Hold the CUDA flash attention against the plain version on the card,
    in f32 and bf16, at every case: |got - want| <= tol s + tol |want|
    (``flash_within``), tol 2e-5 in f32 and 2e-2 in bf16, s = min(1,
    max|want|). At the non-causal cases of FLASH_DROP_MIN_KEYS keys or
    more, the same check must refuse the bf16 kernel run with one key tile
    dropped (``flash_dropped_tile``). Where one PyTorch call computes the
    same function (no window, no softcap), time
    scaled_dot_product_attention on the same inputs as the library's
    yardstick."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref

    dev = torch.device("cuda")
    # the inputs drawn on the card: numpy's draws of the cases' 741 M
    # values on the host took most of the 12 s the phase spent outside its
    # cases' checks and timings
    gen = torch.Generator(device=dev)
    gen.manual_seed(2027)
    rows = []
    for case in FLASH_CASES:
        B, Sq, Skv, Hq, Hkv, D, causal, window, softcap = case
        arrays = [torch.randn(s, generator=gen, device=dev) for s in
                  ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]
        kw = {"causal": causal, "window": window, "softcap": softcap}
        big = flash_work(*case, 4)[1] > FLASH_BIG_OPS
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            timing = FLASH_TIMING[
                dtype if dtype == "float32" else "big" if big else "small"]
            q, k, v = (a.to(getattr(torch, dtype)) for a in arrays)
            out = K.flash_attention_fwd(q, k, v, **kw)
            want = ref.attention(q, k, v, **kw)
            torch.cuda.synchronize()
            ok, err, atol = flash_within(out, want, dtype)
            assert out.dtype == q.dtype and ok, \
                f"flash attention disagrees at {case} {dtype}: {err}"
            dropped = None
            if dtype == "bfloat16" and not causal and window == 0 and \
                    Skv >= FLASH_DROP_MIN_KEYS:
                dropped = flash_dropped_tile(K, q, k, v, want, dtype)
                assert not dropped["within_tol"], \
                    f"the check passes a dropped key tile at {case}: {dropped}"
            check_s = time.perf_counter() - t0
            ms = device_ms(lambda: K.flash_attention_fwd(q, k, v, **kw),
                           **timing[0])
            plain_ms = device_ms(lambda: ref.attention(q, k, v, **kw),
                                 **timing[1])
            library_ms = lib_err = None
            if window == 0 and softcap == 0:
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

                def sdpa():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=Hq != Hkv)
                lib_err = (sdpa().transpose(1, 2).float()
                           - want.float()).abs().max().item()
                library_ms = device_ms(sdpa, **timing[0])
            row = {"case": list(case), "dtype": dtype, "max_abs_err": err,
                   "atol": atol, "within_tol": ok,
                   "dropped_key_tile": dropped, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "library_max_abs_err": lib_err,
                   "timing": timing, "check_s": check_s,
                   "seconds": time.perf_counter() - t0,
                   **bound(*flash_work(*case, q.element_size()), dtype)}
            row["share_of_bound"] = row["bound_ms"] / ms
            rows.append(row)
            emit("flash_attention_kernel", **row)
            del q, k, v, out, want
    emit("flash_attention_kernel_build", ptxas=ptxas_lines("flash_attention"),
         smem_bytes_d112={"bfloat16": K.smem_bytes(112, 2),
                          "float32": K.smem_bytes(112, 4)},
         blocks_per_sm_by_smem_d112={
             "bfloat16": _build.blocks_per_sm(K.smem_bytes(112, 2)),
             "float32": _build.blocks_per_sm(K.smem_bytes(112, 4))})
    torch.cuda.empty_cache()
    return rows


def _kernel_counts():
    from repro_torch.kernels.blockhash import kernel as BH
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.ssd import kernel as SSD
    from repro_torch.kernels.wkv6 import kernel as WKV

    return {"blockhash": BH, "wkv6": WKV, "ssd": SSD, "flash_attention": FA}


def serve_profile(cfg, run, prm, tokens, ranges=(), extra=None,
                  ctx=None, decode_steps: int = 8) -> dict:
    """Where the time goes in a serve (zamba2's, smollm's, olmoe's, the
    VLM's and whisper's, whose stub embeddings come in ``extra``; on a
    mesh with ``ctx``, the partitioned serve's): one
    prefill, then ``decode_steps`` decode steps, each under
    ``profile_device``; the
    device's busy time is the sum of its kernels' and copies' own times,
    the ssd and flash kernels' time and launches are read from it, and
    each named range in ``ranges`` reads its calls and its span on the
    stream."""
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch import serve
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    ctx = ShardingCtx.null() if ctx is None else ctx
    prefill = make_prefill_step(cfg, run, ctx)
    decode = make_decode_step(cfg, run, ctx)
    prompt = tokens.shape[1]
    state = {}

    def run_prefill():
        state["tok"], state["cache"] = prefill(
            prm, {"tokens": tokens, **(extra or {})})
        state["tok"].cpu()

    def run_decode():
        tok, cache = state.pop("tok"), state.pop("cache")
        for i in range(decode_steps):
            tok, cache = decode(prm, cache, {"tokens": tok[:, None],
                                             "pos": prompt + i})
            tok.cpu()

    profs = {"prefill": profile_device(run_prefill, ranges)}
    state["cache"] = serve.pad_cache(cfg, state["cache"], decode_steps, ctx)
    profs[f"decode_{decode_steps}_steps"] = profile_device(run_decode, ranges)
    trace = {}
    for name, prof in profs.items():
        by_name, wall = prof["by_name"], prof["wall_s"]
        busy_s = sum(us for us, _ in by_name.values()) * 1e-6
        assert busy_s > 0, f"the profiler saw no device time in {name}"
        part = {"wall_s": wall, "device_busy_s": busy_s,
                "device_idle_share": 1 - busy_s / wall}
        if ranges:
            part["ranges"] = prof["ranges"]
        kinds = device_kinds(by_name)
        for kname in ("ssd", "flash", "wkv6"):
            kind = kinds.get(kname, {"us": 0.0, "count": 0})
            part[f"{kname}_us"] = kind["us"]
            part[f"{kname}_launches"] = kind["count"]
            part[f"{kname}_share_of_device"] = kind["us"] * 1e-6 / busy_s
        part["device_by_kind"] = kinds
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        part["device_top"] = [{"name": k[:80], "us": us, "count": c}
                              for k, (us, c) in top]
        trace[name] = part
    return trace


def phase_serve_zamba2():
    """The model path: zamba2-7b at full width and depth in bf16, seeded
    random weights on the card, batch 4, a 1024-token prompt and 32 greedy
    tokens through launch/serve.generate, with every kernel count set to 0
    just before and read just after, and the ssd and flash counts read
    after the prefill and after each decode step. Then generate again (the
    same ids), how far the KV cache's length alone moves the bf16 logits, a
    1000-token prefill (both kernels at lengths no block divides), the
    same prefill through the plain versions, in bf16 and in f32, the smoke
    config on the card against the CPU path (which the CPU tests hold to
    the reference), and a profiled prefill and 8 decode steps. Returns
    the main path's launches, the weights and the prompt
    (serve_mesh_zamba2's)."""
    import functools

    import torch

    from repro_torch.configs import registry
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import serve
    from repro_torch.models import lm, params as P
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    kernels = _kernel_counts()
    base = torch.cuda.memory_allocated()  # what the card holds already
    SSD, FA = kernels["ssd"], kernels["flash_attention"]
    bundle = registry.get(ZAMBA["arch"])
    cfg, run = bundle.model, bundle.run
    ctx = ShardingCtx.null()
    dev = torch.device("cuda")
    B, prompt, gen = ZAMBA["batch"], ZAMBA["prompt"], ZAMBA["gen"]
    napp = cfg.num_layers // cfg.shared_attn_every

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    prm = P.materialize(lm.param_specs(cfg), g, dev, dtype=run.compute_dtype)
    tokens = torch.randint(0, cfg.vocab_size, (B, prompt), generator=g,
                           device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    materialize_s = time.perf_counter() - t0
    leaves = list(P.leaves(prm))
    n_params = sum(t.numel() for t in leaves)
    assert n_params == 6_751_130_832, n_params
    assert (cfg.num_layers, cfg.d_model, cfg.head_dim, napp) == (81, 3584, 112, 13)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)

    # the main path: serve.generate (prefill, the KV cache padded for
    # generation, greedy decode), with every count set to 0 just before
    # and read just after
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.reset_launches()
    ids, times = serve.generate(cfg, run, prm, {"tokens": tokens}, gen)
    main_launches = {name: mod.launches() for name, mod in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    assert main_launches == {"blockhash": 0, "wkv6": 0, "ssd": cfg.num_layers,
                             "flash_attention": napp}, main_launches
    assert ids.shape == (B, gen) and ((0 <= ids) & (ids < cfg.vocab_size)).all()

    # the same steps one at a time, with the ssd and flash counts read
    # after the prefill and after each decode step: the same greedy ids
    prefill = make_prefill_step(cfg, run, ctx)
    decode = make_decode_step(cfg, run, ctx)
    l0 = (SSD.launches(), FA.launches())
    tok, cache = prefill(prm, {"tokens": tokens})
    cache = serve.pad_cache(cfg, cache, gen)
    step_ids = [tok.cpu()]
    prefill_launches = (SSD.launches() - l0[0], FA.launches() - l0[1])
    step_launches = []
    for i in range(gen - 1):
        l0 = (SSD.launches(), FA.launches())
        tok, cache = decode(prm, cache, {"tokens": tok[:, None],
                                         "pos": prompt + i})
        step_ids.append(tok.cpu())
        step_launches.append((SSD.launches() - l0[0], FA.launches() - l0[1]))
    del cache
    assert prefill_launches == (cfg.num_layers, napp), prefill_launches
    assert step_launches == [(0, 0)] * (gen - 1), step_launches
    assert (torch.stack(step_ids, dim=1).numpy() == ids).all()

    # run to run, generate gives the same ids
    ids_again, _ = serve.generate(cfg, run, prm, {"tokens": tokens}, gen)
    assert (ids_again == ids).all(), "generate differs from run to run"

    # The KV cache's length alone moves the bf16 logits: one prefill, its
    # cache padded by 4 slots and by gen, the same tokens (generate's ids)
    # fed to both for 3 decode steps. The slots past pos weigh nothing, but
    # the products over the cache run at another length.
    with torch.inference_mode():
        _, cache = lm.prefill_fn(cfg, run, ctx, prm, {"tokens": tokens})
        short, full = (serve.pad_cache(cfg, cache, n) for n in (4, gen))
        del cache
        pad_probe = []
        for i in range(3):
            feed = {"tokens": torch.from_numpy(ids[:, i:i + 1]).to(
                dev, torch.int32), "pos": prompt + i}
            la, short = lm.decode_fn(cfg, run, ctx, prm, short, feed)
            lb, full = lm.decode_fn(cfg, run, ctx, prm, full, feed)
            assert (lb.argmax(-1).cpu().numpy() == ids[:, i + 1]).all()
            top2 = lb.float().topk(2, dim=-1).values
            pad_probe.append({
                "step": i + 1,
                "logits_max_abs_diff": (la.float() - lb.float()).abs().max().item(),
                "argmax_differs_in_rows": (la.argmax(-1) != lb.argmax(-1)
                                           ).nonzero().flatten().tolist(),
                "top2_margin_by_row": (top2[:, 0] - top2[:, 1]).tolist()})
        del short, full, la, lb

    # a prompt that no flash block and no SSD chunk divides goes through
    # both kernels all the same
    odd = ZAMBA["odd_prompt"]
    l0 = (SSD.launches(), FA.launches())
    with torch.inference_mode():
        logits_odd, _ = lm.prefill_fn(cfg, run, ctx, prm,
                                      {"tokens": tokens[:, :odd].contiguous()})
    odd_launches = (SSD.launches() - l0[0], FA.launches() - l0[1])
    assert odd_launches == (cfg.num_layers, napp), odd_launches
    assert torch.isfinite(logits_odd).all()
    del logits_odd

    def timed_prefill(params, rn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = lm.prefill_fn(cfg, rn, ctx, params, {"tokens": tokens})
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def through_ref(fn):
        """``fn()`` with ``ops.ssd`` and ``ops.flash_attention`` pointed at
        the plain versions."""
        kernel_ssd, kernel_fa = ssd_ops.ssd, fa_ops.flash_attention
        ssd_ops.ssd = functools.partial(kernel_ssd, use_kernel=False)
        fa_ops.flash_attention = functools.partial(kernel_fa, use_kernel=False)
        l0 = (SSD.launches(), FA.launches())
        try:
            out = fn()
        finally:
            ssd_ops.ssd, fa_ops.flash_attention = kernel_ssd, kernel_fa
        assert (SSD.launches(), FA.launches()) == l0, \
            "the plain prefill launched a kernel"
        return out

    def rel_by_layer(a, b):
        return [((x - y).abs().max() / y.abs().max()).item()
                for x, y in zip(a, b)]

    def logits_err(a, b):
        scale = max(1.0, b.float().abs().max().item())
        return (a.float() - b.float()).abs().max().item(), scale

    # The same bf16 prefill, warm, through the kernels and the plain
    # versions. Layer 0's scan sees identical inputs in both; from there
    # bf16 rounding of each layer's output amplifies f32 differences, so
    # the logits are held in f32 below and reported here.
    (logits, cache), prefill_s = timed_prefill(prm, run)
    (logits_ref, cache_ref), prefill_ref_s = through_ref(
        lambda: timed_prefill(prm, run))
    assert logits.shape == (B, cfg.vocab_size)
    assert torch.isfinite(logits).all() and torch.isfinite(logits_ref).all()
    ssm_rel = rel_by_layer(cache["mamba"]["ssm"], cache_ref["mamba"]["ssm"])
    assert ssm_rel[0] <= 1e-4, f"layer 0 ssm state differs: {ssm_rel[0]}"
    k_rel = rel_by_layer(cache["attn"]["k"].float(),
                         cache_ref["attn"]["k"].float())
    bf16_err, bf16_scale = logits_err(logits, logits_ref)
    first_token_repeats = bool(
        (logits.argmax(-1).cpu().numpy() == ids[:, 0]).all())
    del cache, cache_ref

    # The same prefill in f32 (the bf16 weights widened exactly; matmuls
    # in full f32, TF32 off), through the kernels and the plain versions:
    # the last-token logits within 2e-2 x max(1, max|logits|).
    assert not torch.backends.cuda.matmul.allow_tf32
    prm32 = P.tree_map(lambda t: t.float(), prm)
    run32 = run.replace(compute_dtype="float32")
    (logits32, cache32), prefill_f32_s = timed_prefill(prm32, run32)
    (logits32_ref, cache32_ref), _ = through_ref(
        lambda: timed_prefill(prm32, run32))
    ssm32_rel = rel_by_layer(cache32["mamba"]["ssm"],
                             cache32_ref["mamba"]["ssm"])
    assert ssm32_rel[0] <= 1e-4, f"layer 0 f32 ssm state: {ssm32_rel[0]}"
    f32_err, f32_scale = logits_err(logits32, logits32_ref)
    assert f32_err <= 2e-2 * f32_scale, (f32_err, f32_scale)
    bf16_vs_f32_err, _ = logits_err(logits, logits32)
    # the kernels move the bf16 logits less than bf16 itself moves them
    assert bf16_err < bf16_vs_f32_err, (bf16_err, bf16_vs_f32_err)
    SERVE_F32_LOGITS["serve_zamba2"] = logits32.cpu()  # serve_mesh_zamba2's
    del prm32, cache32, cache32_ref, logits_ref, logits32_ref
    torch.cuda.empty_cache()

    # the smoke config in f32, every leaf random, on the card (the CUDA
    # kernels) against the CPU (the plain versions); a prompt of 128 tokens
    # is a multiple of the chunk (16) and of a flash block (128), one of
    # 100 of neither
    smoke, srun = bundle.smoke, run.replace(compute_dtype="float32")
    gcpu = torch.Generator().manual_seed(1)
    sprm = P.materialize(lm.param_specs(smoke), gcpu, "cpu")
    for t in P.leaves(sprm):
        t.add_(0.1 * torch.randn(t.shape, generator=gcpu))
    sprm_dev = P.tree_map(lambda t: t.to(dev), sprm)
    smoke_err = {}
    for slen in (128, 100):
        stoks = torch.randint(0, smoke.vocab_size, (2, slen), generator=gcpu,
                              dtype=torch.int32)
        l0 = (SSD.launches(), FA.launches())
        with torch.inference_mode():
            s_cpu, _ = lm.prefill_fn(smoke, srun, ctx, sprm, {"tokens": stoks})
            s_dev, _ = lm.prefill_fn(smoke, srun, ctx, sprm_dev,
                                     {"tokens": stoks.to(dev)})
        assert (SSD.launches() - l0[0], FA.launches() - l0[1]) == (
            smoke.num_layers, smoke.num_layers // smoke.shared_attn_every)
        err = (s_dev.cpu() - s_cpu).abs().max().item()
        scale = max(1.0, s_cpu.abs().max().item())
        assert err <= 1e-4 * scale, (slen, err, scale)
        smoke_err[slen] = err

    decode_flash_check(cfg, run, prm)  # the shared attention
    trace = serve_profile(cfg, run, prm, tokens)
    assert (trace["prefill"]["ssd_launches"],
            trace["prefill"]["flash_launches"]) == (cfg.num_layers, napp)
    assert trace["decode_8_steps"]["ssd_launches"] == 0
    assert trace["decode_8_steps"]["flash_launches"] == 0

    emit("serve_zamba2", arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, shared_block_applications=napp, params=n_params,
         param_bytes=param_bytes, dtype=run.compute_dtype, batch=B,
         prompt=prompt, gen=gen, materialize_s=materialize_s,
         prefill_ms=prefill_s * 1e3, prefill_cold_ms=times["prefill_s"] * 1e3,
         prefill_ref_ms=prefill_ref_s * 1e3,
         prefill_f32_ms=prefill_f32_s * 1e3,
         decode_ms_per_token=times["decode_s_per_token"] * 1e3,
         tokens_per_s=B / times["decode_s_per_token"],
         request_tokens_per_s=B * gen / (
             times["prefill_s"] + (gen - 1) * times["decode_s_per_token"]),
         peak_memory_bytes=peak,
         base_memory_bytes=base,
         ssd_launches_per_prefill=prefill_launches[0],
         flash_launches_per_prefill=prefill_launches[1],
         launches_per_decode_step=[max(n for n, _ in step_launches),
                                   max(n for _, n in step_launches)],
         main_path_launches=main_launches,
         generated_ids_row0=ids[0].tolist(),
         first_token_repeats_in_warm_prefill=first_token_repeats,
         ssm_rel_err_by_layer=ssm_rel, attn_k_rel_err_by_application=k_rel,
         logits_bf16_max_abs_err=bf16_err, logits_bf16_scale=bf16_scale,
         ssm_rel_err_by_layer_f32=ssm32_rel, logits_f32_max_abs_err=f32_err,
         logits_f32_scale=f32_scale, logits_bf16_vs_f32_err=bf16_vs_f32_err,
         smoke_card_vs_cpu_err=smoke_err, rerun_ids_equal=True,
         cache_pad_probe=pad_probe, odd_prompt=odd,
         odd_prompt_launches=list(odd_launches), trace=trace)
    return main_launches, prm, tokens


# --- the dense stack and the trainer (models/transformer -> kernels/flash_attention,
# train/trainer -> checkpoint on a bento mount -> kernels/blockhash) ----------------


def through_plain(fn):
    """``fn()`` with the model's kernel paths (``ops.flash_attention``,
    ``ops.ssd``, ``ops.wkv6``) pointed at their plain versions; fails if a
    kernel launched."""
    import functools

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.wkv6 import ops as wkv_ops

    kernels = _kernel_counts()
    paths = ((fa_ops, "flash_attention"), (ssd_ops, "ssd"), (wkv_ops, "wkv6"))
    real = [getattr(mod, name) for mod, name in paths]
    for (mod, name), fn_k in zip(paths, real):
        setattr(mod, name, functools.partial(fn_k, use_kernel=False))
    l0 = {n: m.launches() for n, m in kernels.items()}
    try:
        out = fn()
    finally:
        for (mod, name), fn_k in zip(paths, real):
            setattr(mod, name, fn_k)
    assert {n: m.launches() for n, m in kernels.items()} == l0, \
        "the plain path launched a kernel"
    return out


class OneBatch:
    """A data source that serves SyntheticLM's batch 0 at every step. On
    fresh random tokens there is nothing to learn but the uniform
    distribution, and 12 steps of the warm-up schedule move smollm's loss
    less than its batch-to-batch noise (on the CPU at full width, depth 2,
    lr 1e-3: 11.3085 -> 11.3172 over 12 steps); on one batch seen at every
    step it must fall (11.3085 -> 9.8943 there)."""

    def __init__(self, data):
        self.b = data.batch(0)

    def batch(self, step):
        return self.b


def draw_gates(prm, seed: int):
    """The VLM's cross-layer gates (``gate_attn``, ``gate_mlp``: zeros at
    init, and tanh(0) = 0 would hide the cross layers) set in place to
    magnitudes drawn uniform in [0.5, 1.5] with random signs from ``seed``.
    Returns the values, or None for a tree with no cross layers."""
    import torch

    from repro_torch.distributed.sharding import MeshArray

    cross = prm["stack"].get("cross")
    if cross is None:
        return None
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name in ("gate_attn", "gate_mlp"):
        t = cross[name]
        # a partitioned trainer's gate: the same whole value in every cell
        copies = t.shards if isinstance(t, MeshArray) else [t]
        mag = 0.5 + torch.rand(t.shape, generator=g)
        sign = torch.randint(0, 2, t.shape, generator=g) * 2 - 1
        with torch.no_grad():
            for c in copies:
                c.copy_((mag * sign).to(c.dtype))
        out[name] = copies[0].float().cpu().tolist()
    return out


def _logits_err(a, b):
    scale = max(1.0, b.float().abs().max().item())
    return (a.float() - b.float()).abs().max().item(), scale


def phase_serve_smollm():
    """The dense model path: smollm-135m whole (30 layers, d_model 576, 9
    heads over 3 kv heads of 64, vocabulary 49152) in bf16, seeded random
    weights on the card, batch 4, a 1024-token prompt and 32 greedy tokens
    through launch/serve.generate, with every kernel count set to 0 just
    before and read just after: the flash kernel launches once a layer in
    the prefill and never in a decode step. Then a 1000-token prompt, the
    same prefill through the plain attention in bf16 and with an f32 copy
    of the weights, and a profiled prefill and 8 decode steps. Returns the
    main path's flash launches, the weights and the prompt (for
    serve_mesh_smollm)."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch import serve
    from repro_torch.models import lm, params as P
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    kernels = _kernel_counts()
    base = torch.cuda.memory_allocated()  # what the card holds already
    FA = kernels["flash_attention"]
    bundle = registry.get(SMOLLM["arch"])
    cfg, run = bundle.model, bundle.run
    ctx = ShardingCtx.null()
    dev = torch.device("cuda")
    B, prompt, gen = SMOLLM["batch"], SMOLLM["prompt"], SMOLLM["gen"]
    L = cfg.num_layers

    g = torch.Generator(device=dev).manual_seed(0)
    prm = P.materialize(lm.param_specs(cfg), g, dev, dtype=run.compute_dtype)
    tokens = torch.randint(0, cfg.vocab_size, (B, prompt), generator=g,
                           device=dev, dtype=torch.int32)
    n_params = sum(t.numel() for t in P.leaves(prm))
    assert n_params == 134_515_008, n_params
    assert (L, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size) == (30, 576, 9, 3, 64, 1536, 49152)

    # the main path, every count set to 0 just before and read just after
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.reset_launches()
    ids, times = serve.generate(cfg, run, prm, {"tokens": tokens}, gen)
    main_launches = {name: mod.launches() for name, mod in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    assert main_launches == {"blockhash": 0, "wkv6": 0, "ssd": 0,
                             "flash_attention": L}, main_launches
    assert ids.shape == (B, gen) and ((0 <= ids) & (ids < cfg.vocab_size)).all()

    # the same steps one at a time: 30 launches in the prefill, 0 in each
    # decode step, the same greedy ids
    prefill = make_prefill_step(cfg, run, ctx)
    decode = make_decode_step(cfg, run, ctx)
    l0 = FA.launches()
    tok, cache = prefill(prm, {"tokens": tokens})
    prefill_launches = FA.launches() - l0
    cache = serve.pad_cache(cfg, cache, gen)
    assert cache["k"].dtype == torch.bfloat16 and tuple(cache["k"].shape) == (
        L, B, prompt + gen, cfg.num_kv_heads, cfg.head_dim)
    step_ids, step_launches = [tok.cpu()], []
    for i in range(gen - 1):
        l0 = FA.launches()
        tok, cache = decode(prm, cache, {"tokens": tok[:, None],
                                         "pos": prompt + i})
        step_ids.append(tok.cpu())
        step_launches.append(FA.launches() - l0)
    del cache
    assert prefill_launches == L, prefill_launches
    assert step_launches == [0] * (gen - 1), step_launches
    assert (torch.stack(step_ids, dim=1).numpy() == ids).all()

    # a prompt that no flash block divides
    odd = SMOLLM["odd_prompt"]
    l0 = FA.launches()
    with torch.inference_mode():
        logits_odd, cache_odd = lm.prefill_fn(
            cfg, run, ctx, prm, {"tokens": tokens[:, :odd].contiguous()})
    odd_launches = FA.launches() - l0
    assert odd_launches == L, odd_launches
    assert torch.isfinite(logits_odd).all() and cache_odd["k"].shape[2] == odd
    del logits_odd, cache_odd

    def timed_prefill(params, rn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = lm.prefill_fn(cfg, rn, ctx, params, {"tokens": tokens})
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # the same prefill through the kernel and through the plain version,
    # in bf16 (reported) and with an f32 copy of the weights (held)
    (logits, _), prefill_s = timed_prefill(prm, run)
    (logits_ref, _), prefill_ref_s = through_plain(
        lambda: timed_prefill(prm, run))
    assert torch.isfinite(logits).all() and torch.isfinite(logits_ref).all()
    bf16_err, bf16_scale = _logits_err(logits, logits_ref)
    assert not torch.backends.cuda.matmul.allow_tf32
    prm32 = P.tree_map(lambda t: t.float(), prm)
    run32 = run.replace(compute_dtype="float32")
    (logits32, _), prefill_f32_s = timed_prefill(prm32, run32)
    (logits32_ref, _), _ = through_plain(
        lambda: timed_prefill(prm32, run32))
    f32_err, f32_scale = _logits_err(logits32, logits32_ref)
    assert f32_err <= 2e-2 * f32_scale, (f32_err, f32_scale)
    # The kernel rounds p to bf16 for its second product, a rounding as
    # large as bf16's own here (9 heads of 64 against zamba2's 32 of 112):
    # its bf16 logits may lie no more than twice as far from the f32 ones
    # as the plain version's bf16 logits do.
    kernel_vs_f32_err, _ = _logits_err(logits, logits32_ref)
    plain_vs_f32_err, _ = _logits_err(logits_ref, logits32_ref)
    assert kernel_vs_f32_err <= 2 * plain_vs_f32_err, (kernel_vs_f32_err,
                                                       plain_vs_f32_err)
    SERVE_F32_LOGITS["serve_smollm"] = logits32_ref.cpu()
    # and the kernel's bf16 logits against the plain version's within the
    # kernel's own bf16 tolerance at the logits' scale (phase
    # flash_attention_kernel holds the kernel itself at this shape)
    tol = FLASH_TOL["bfloat16"]
    bf16_bound = tol + tol * bf16_scale
    assert bf16_err <= bf16_bound, (bf16_err, bf16_bound)
    del prm32, logits32, logits32_ref, logits_ref
    torch.cuda.empty_cache()

    decode_flash_check(cfg, run, prm)
    trace = serve_profile(cfg, run, prm, tokens)
    # the profiler can lose events: its counts are lower bounds
    assert 0 < trace["prefill"]["flash_launches"] <= L, trace["prefill"]
    assert trace["decode_8_steps"]["flash_launches"] == 0
    emit("serve_smollm", arch=cfg.name, layers=L, d_model=cfg.d_model,
         params=n_params, dtype=run.compute_dtype, batch=B, prompt=prompt,
         gen=gen, prefill_ms=prefill_s * 1e3,
         prefill_cold_ms=times["prefill_s"] * 1e3,
         prefill_ref_ms=prefill_ref_s * 1e3,
         prefill_f32_ms=prefill_f32_s * 1e3,
         decode_ms_per_token=times["decode_s_per_token"] * 1e3,
         tokens_per_s=B / times["decode_s_per_token"],
         request_tokens_per_s=B * gen / (
             times["prefill_s"] + (gen - 1) * times["decode_s_per_token"]),
         peak_memory_bytes=peak,
         base_memory_bytes=base, flash_launches_per_prefill=prefill_launches,
         flash_launches_per_decode_step=max(step_launches),
         main_path_launches=main_launches,
         generated_ids_row0=ids[0].tolist(),
         logits_bf16_max_abs_err=bf16_err, logits_bf16_scale=bf16_scale,
         logits_f32_max_abs_err=f32_err, logits_f32_scale=f32_scale,
         logits_f32_tolerance="2e-2 x max(1, max|plain|)",
         logits_bf16_bound=bf16_bound,
         logits_bf16_tolerance=f"{tol} + {tol} max|plain|",
         logits_bf16_kernel_vs_f32_err=kernel_vs_f32_err,
         logits_bf16_plain_vs_f32_err=plain_vs_f32_err, odd_prompt=odd,
         odd_prompt_launches=odd_launches, trace=trace)
    torch.cuda.empty_cache()
    # the weights and prompt for serve_mesh_smollm
    return main_launches["flash_attention"], prm, tokens


def phase_train_smollm():
    """The training path: smollm-135m at full width and depth through
    train.trainer.Trainer on the card, with the bundle's RunConfig (f32
    parameters and optimizer state, bf16 compute, each layer rematerialised
    in the backward, microbatches of 4). Global batch 8 x 2048 tokens from
    SyntheticLM, so 2 microbatches a step; 2 warm-up steps, then 6 timed
    ones, each with the flash count read around it: 30 forward launches
    and 30 rematerialised ones a microbatch, 120 a step. The trainer sees
    one batch at every step (``OneBatch``), on which the loss must fall.
    Then one microbatch in f32 through the kernel and through the plain attention
    (the loss and every gradient leaf held), the autograd Function's bf16
    forward at the training shape against the plain version (its dq, dk,
    dv too, a check of the wiring), the kernel's forward and the recompute
    backward timed alone, and one profiled step."""
    import numpy as np
    import torch
    
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import lm, params as P
    from repro_torch.train.step import num_accum_steps
    from repro_torch.train.trainer import Trainer

    kernels = _kernel_counts()
    base = torch.cuda.memory_allocated()  # what the card holds already
    bundle = registry.get(TRAIN["arch"])
    cfg, run = bundle.model, bundle.run
    assert (run.param_dtype, run.compute_dtype, run.remat,
            run.microbatch_per_data_shard) == ("float32", "bfloat16", "block", 4)
    gb, seq = TRAIN["global_batch"], TRAIN["seq"]
    ctx = ShardingCtx.null()
    n_accum = num_accum_steps(run, ctx, gb)
    L = cfg.num_layers
    per_step = n_accum * 2 * L  # the forward and the remat's, a microbatch
    assert (n_accum, per_step) == (2, 120)
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    t = Trainer(cfg, run, global_batch=gb, seq_len=seq, seed=0,
                data=OneBatch(SyntheticLM(cfg, gb, seq, seed=0)))
    assert t.device.type == "cuda"
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(math.prod(x.shape) for x in P.leaves(t.params))
    assert n_params == 134_515_008, n_params

    # the main path: every count set to 0 just before, read just after
    n_steps = TRAIN["warmup"] + TRAIN["steps"]
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.reset_launches()
    step_s, step_launches = [], []
    for i in range(n_steps):
        l0 = kernels["flash_attention"].launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train(i + 1)  # one step; its metrics reach the host
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        step_launches.append(kernels["flash_attention"].launches() - l0)
    main_launches = {name: mod.launches() for name, mod in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    assert step_launches == [per_step] * n_steps, step_launches
    assert main_launches == {"blockhash": 0, "wkv6": 0, "ssd": 0,
                             "flash_attention": per_step * n_steps}
    losses = [m["loss"] for m in t.metrics_log]
    assert len(losses) == n_steps and all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    timed = step_s[TRAIN["warmup"]:]
    step_med = statistics.median(timed)
    tokens = gb * seq
    flops = train_flops(cfg, n_params, gb, seq)

    # one microbatch in f32, through the kernel and through the plain
    # version: the loss and every gradient leaf
    run32 = run.replace(compute_dtype="float32")
    mb = {k: torch.from_numpy(v[:gb // n_accum]).to(dev)
          for k, v in t.data.batch(0).items()}

    def loss_and_grads():
        prm = P.tree_map(lambda p: p.detach().requires_grad_(), t.params)
        loss, _ = lm.loss_fn(cfg, run32, ctx, prm, mb)
        return loss.item(), torch.autograd.grad(loss, list(P.leaves(prm)))

    l0 = K.launches()
    loss_k, grads_k = loss_and_grads()
    f32_launches = K.launches() - l0
    assert f32_launches == 2 * L, f32_launches
    loss_p, grads_p = through_plain(loss_and_grads)
    f32_loss_err = abs(loss_k - loss_p)
    assert f32_loss_err <= 1e-4 * max(1.0, abs(loss_p)), (loss_k, loss_p)
    grad_rel = [((a - b).abs().max() / max(1.0, b.abs().max().item())).item()
                for a, b in zip(grads_k, grads_p)]
    assert max(grad_rel) <= 1e-3, max(grad_rel)
    del grads_k, grads_p
    torch.cuda.empty_cache()

    # the Function at the training shape in bf16: its forward (the kernel)
    # against the plain version at FLASH_TOL, and dq, dk, dv against
    # autograd through the plain version. Both backwards differentiate
    # ref.attention, so the gradients check the wiring (saved inputs, the
    # mask, dtypes), not the kernel: phase flash_attention_kernel holds the
    # kernel at this shape.
    rng = np.random.default_rng(2029)
    Bm, Hq, Hkv, D = gb // n_accum, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v, go = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                   .to(dev, torch.bfloat16) for s in
                   ((Bm, seq, Hq, D), (Bm, seq, Hkv, D), (Bm, seq, Hkv, D),
                    (Bm, seq, Hq, D)))

    def grads_of(use_kernel):
        qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        out = fa_ops.flash_attention(qq, kk, vv, True, 0, 0.0,
                                     use_kernel=use_kernel)
        return (out.detach(), *torch.autograd.grad(out, (qq, kk, vv), go))

    tol = FLASH_TOL["bfloat16"]
    fn_err = {}
    for name, got, want in zip(("out", "dq", "dk", "dv"), grads_of(True),
                               grads_of(False)):
        diff = (got.float() - want.float()).abs()
        ok = bool((diff <= tol + tol * want.float().abs()).all())
        assert got.dtype == torch.bfloat16 and ok, (name, diff.max().item())
        fn_err[name] = diff.max().item()

    # the kernel's forward and the recompute backward alone, at the shape
    fwd_ms = device_ms(lambda: K.flash_attention_fwd(q, k, v, causal=True),
                       count=5, reps=10)
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))

    def recompute_bwd():
        with torch.enable_grad():
            out = fa_ref.attention(qq, kk, vv, causal=True)
            return torch.autograd.grad(out, (qq, kk, vv), go)
    bwd_ms = call_ms(recompute_bwd, count=3, reps=5)
    del q, k, v, go, qq, kk, vv

    # one profiled step, the device traced alone; the Function's backward
    # runs under the named range "flash_recompute_bwd", timed by CUDA events
    prof = profile_device(lambda: t.train(t.step_idx + 1),
                          ("flash_recompute_bwd",))
    by_name, prof_wall = prof["by_name"], prof["wall_s"]
    busy_s = sum(us for us, _ in by_name.values()) * 1e-6
    assert busy_s > 0, "the profiler saw no device time in the step"
    kinds = device_kinds(by_name)
    bwd_range = prof["ranges"].get("flash_recompute_bwd", {})
    assert bwd_range.get("calls") == n_accum * L, bwd_range
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    profiled = {
        "wall_s": prof_wall, "device_busy_s": busy_s,
        "device_idle_share": 1 - busy_s / prof_wall,
        "device_idle_share_of_unprofiled_step": 1 - busy_s / step_med,
        "flash_fwd_us": kinds.get("flash", {}).get("us", 0.0),
        "flash_fwd_events_seen": kinds.get("flash", {}).get("count", 0),
        "recompute_bwd_span_us": bwd_range["span_us"],
        "recompute_bwd_span_share_of_unprofiled_step":
            bwd_range["span_us"] * 1e-6 / step_med,
        "recompute_bwd_calls": bwd_range["calls"],
        "tables_s": prof["tables_s"],
        "device_by_kind": kinds,
        "device_top": [{"name": kn[:80], "us": us, "count": c}
                       for kn, (us, c) in top]}
    emit("train_smollm", arch=cfg.name, layers=L, params=n_params,
         param_dtype=run.param_dtype, compute_dtype=run.compute_dtype,
         remat=run.remat, global_batch=gb, seq=seq, microbatches=n_accum,
         init_s=init_s, warmup_steps=TRAIN["warmup"], timed_steps=len(timed),
         step_ms=step_med * 1e3, step_ms_all=[x * 1e3 for x in step_s],
         tokens_per_s=tokens / step_med, peak_memory_bytes=peak,
         base_memory_bytes=base,
         model_flops_per_step=flops,
         model_flops_share_of_bf16_peak=flops / step_med / BF16_TENSOR_OPS_PER_S,
         losses=losses, flash_launches_per_step=per_step, main_path_launches=main_launches,
         f32_loss_kernel=loss_k, f32_loss_plain=loss_p,
         f32_loss_err=f32_loss_err, f32_grad_max_rel_err=max(grad_rel),
         f32_tolerance={"loss": "1e-4 x max(1, |plain|)",
                        "grads": "1e-3 x max(1, max|plain|) a leaf"},
         bf16_function_forward_max_abs_err=fn_err.pop("out"),
         bf16_backward_wiring_max_abs_err=fn_err,
         bf16_function_tolerance=f"{tol} + {tol} |plain|",
         flash_fwd_ms=fwd_ms, recompute_bwd_ms=bwd_ms,
         flash_fwd_ms_per_step=fwd_ms * per_step,
         recompute_bwd_ms_per_step=bwd_ms * n_accum * L,
         profiled_step=profiled)
    del mb
    torch.cuda.empty_cache()
    return main_launches["flash_attention"], bwd_ms, t


def phase_train_ckpt():
    """tests/test_system.py's story on the card, at smollm-135m's full
    width: a Trainer on the card with a bento mount of the card for its
    checkpoints (every 3 steps), a WorkerFailure before step 6, 9 steps
    on one batch (``OneBatch``: the loss falls), one recovery from step
    6's checkpoint; the mounted fs upgraded from xv6 to ext4like under
    it; a new trainer restoring step 9 with every leaf equal; 4 decode
    steps from the restored weights. Every journal commit and every
    restore chunk hashes on the blockhash kernel: launches must equal the
    counted checksum calls plus the bind-time probe.

    The trainers run as a user's would, with no mesh: each leaf is one
    shard file, the three embedding-shaped ones (49152 x 576 f32) 113 MB
    each, seven times the 16 MiB buffer cache. One cut, the depth, 30 ->
    2 layers: a full-depth checkpoint is 1.61 GB (f32 parameters, mu and
    nu), and four saves and two restores of it would take minutes at the
    store's rates; the embedding (28.3 M of the 35.4 M parameters left)
    keeps the largest leaves at full size."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.core.upgrade import upgrade
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.fs.ext4like import Ext4LikeFileSystem
    from repro_torch.fs.mounts import make_mount
    from repro_torch.launch import serve
    from repro_torch.models import params as P
    from repro_torch.serve.step import make_decode_step, make_prefill_step
    from repro_torch.train.trainer import Trainer, WorkerFailure

    FA = _kernel_counts()["flash_attention"]
    bundle = registry.get(TRAIN_CKPT["arch"])
    cfg = dataclasses.replace(bundle.model, num_layers=TRAIN_CKPT["layers"])
    # tests/test_system.py's settings: no microbatches, a larger rate
    run = bundle.run.replace(microbatch_per_data_shard=0, learning_rate=1e-3)
    dev = torch.device("cuda", torch.cuda.current_device())
    ctx = ShardingCtx.null()
    gb, seq, steps = (TRAIN_CKPT["global_batch"], TRAIN_CKPT["seq"],
                      TRAIN_CKPT["steps"])
    L, every, fail_at = cfg.num_layers, TRAIN_CKPT["ckpt_every"], TRAIN_CKPT["fail_at"]
    saves, restores = [], []

    def timed(trainer):
        real_save, real_restore = trainer.save_checkpoint, trainer.restore_checkpoint

        def save():
            t0 = time.perf_counter()
            real_save()
            saves.append(time.perf_counter() - t0)

        def restore(step=None):
            t0 = time.perf_counter()
            ok = real_restore(step)
            torch.cuda.synchronize()
            restores.append(time.perf_counter() - t0)
            return ok
        trainer.save_checkpoint, trainer.restore_checkpoint = save, restore

    armed = {"on": True}

    def failure_hook(step):
        if step == fail_at and armed["on"]:
            armed["on"] = False
            raise WorkerFailure("rack power glitch")

    def migrate(state, _o, _n):
        state.setdefault("dirindex", {})
        return state

    def path():
        mf = make_mount("bento", n_blocks=TRAIN_CKPT["n_blocks"], device=dev)
        t = Trainer(cfg, run, global_batch=gb, seq_len=seq,
                    ckpt_view=mf.view, ckpt_every=every,
                    failure_hook=failure_hook, seed=3, device=dev,
                    data=OneBatch(SyntheticLM(cfg, gb, seq, 3)))
        timed(t)
        t0 = time.perf_counter()
        t.train(steps)
        train_s = time.perf_counter() - t0
        stats = upgrade(mf.mount, Ext4LikeFileSystem(), migrate=migrate)
        t2 = Trainer(cfg, run, global_batch=gb, seq_len=seq,
                     ckpt_view=mf.view, seed=3, device=dev)
        timed(t2)
        assert t2.restore_checkpoint() and t2.step_idx == steps
        pairs = list(P.leaves(P.tree_map(
            lambda a, b: (a, b), {"p": t2.params, "o": t2.opt_state},
            {"p": t.params, "o": t.opt_state})))
        equal = all(a.device == dev and torch.equal(a, b) for a, b in pairs)
        nbytes = sum(b.numel() * b.element_size() for _, b in pairs)
        prefill = make_prefill_step(cfg, run, ctx)
        decode = make_decode_step(cfg, run, ctx)
        tok, cache = prefill(t2.params, {"tokens": torch.ones(
            (2, 16), dtype=torch.int32, device=dev)})
        cache = serve.pad_cache(cfg, cache, 8)
        out = [tok.cpu()]
        for i in range(TRAIN_CKPT["decode_steps"]):
            tok, cache = decode(t2.params, cache,
                                {"tokens": tok[:, None], "pos": 16 + i})
            out.append(tok.cpu())
        calls = checksum_calls(mf.services)
        ckpts = sorted(mf.view.listdir(t.ckpt_root))
        last = f"{t.ckpt_root}/{ckpts[-1]}"
        sizes = [mf.view.stat(f"{last}/{n}").size
                 for n in mf.view.listdir(last)]
        mf.close()
        return (t, train_s, stats, equal, len(pairs), nbytes,
                torch.stack(out, dim=1), calls, ckpts, sizes,
                t2.last_restore_stats)

    FA.reset_launches()
    (t, train_s, stats, equal, n_leaves, nbytes, ids, calls, ckpts,
     sizes, restore_stats), launches, tally = counted(path)
    flash_launches = FA.launches()
    losses = [m["loss"] for m in t.metrics_log]
    assert t.recoveries == 1 and t.step_idx == steps
    assert [m["step"] for m in t.metrics_log] == list(range(steps))
    assert losses[-1] < losses[0], losses
    assert equal, "the restored leaves differ from the trainer's"
    # no mesh: one shard file a leaf, the embedding-shaped ones whole
    largest = max(sizes)
    assert len(sizes) == n_leaves + 1 and largest > 113_246_208, sizes
    assert launches == tally["calls"] + tally["probes"] == calls + 1, (
        launches, tally, calls)
    # saves at steps 3 and 6, the failure before step 6 runs, the recovery
    # from step 6, a save at 9; two restores
    assert ckpts == [f"step_{s:08d}" for s in range(every, steps + 1, every)]
    assert len(saves) == steps // every and len(restores) == 2
    # flash: 2 L a step (the forward and the remat's), one prefill
    assert flash_launches == steps * 2 * L + L, flash_launches
    assert ids.shape == (2, TRAIN_CKPT["decode_steps"] + 1)
    pipe = restore_stats.get("pipeline", {})
    emit("train_ckpt", arch=cfg.name, layers=L, d_model=cfg.d_model,
         cut="depth 30 -> 2: a full-depth checkpoint is 1.61 GB (f32 params, "
             "mu, nu); three saves and two restores of it would take minutes",
         mesh=None, shard_files=len(sizes) - 1,
         largest_shard_file_bytes=largest,
         global_batch=gb, seq=seq, steps=steps, ckpt_every=every,
         fail_at=fail_at, recoveries=t.recoveries, losses=losses,
         train_s=train_s,
         checkpoints=ckpts, checkpoint_bytes=nbytes, leaves=n_leaves,
         save_s=saves, save_mb_per_s=[nbytes / x / 1e6 for x in saves],
         restore_s=restores, restore_mb_per_s=[nbytes / x / 1e6
                                               for x in restores],
         recovery_restore_s=restores[0],
         restore_fetch_s=pipe.get("fetch_s"),
         restore_assemble_s=pipe.get("assemble_s"),
         upgrade_pause_ms=stats["total_s"] * 1e3,
         restored_leaves_equal=equal, decoded_ids=ids.numpy().tolist(),
         launches=launches, checksum_calls=tally["calls"],
         probe_launches=tally["probes"], flash_launches=flash_launches)
    del t
    torch.cuda.empty_cache()
    return launches, flash_launches


# --- ssm/hybrid training and the MoE family (kernels/{wkv6,ssd}/ops: the
# kernels' autograd Functions; models/moe; train/trainer) -------------------------

# (shape, chunk) of each scan at its model's training microbatch (4 x 2048):
# rwkv6-7b's 64 heads of 64 at chunk 32 (B, S, H, K, V, chunk); zamba2-7b's
# 112 heads, P = N = 64, at chunk 128 (b, S, H, P, N, chunk).
SCAN_GRAD = {"wkv6": (4, 2048, 64, 64, 64, 32),
             "ssd": (4, 2048, 112, 64, 64, 128)}
GRAD_TOL = 1e-3  # x max(1, max|plain|), each gradient (tests/test_kernels.py)
# The training phases: each model at full width with the bundle's
# RunConfig and its depth cut, since the whole model's f32 parameters,
# gradients and Adam moments (16 bytes a parameter) do not fit one card:
# rwkv6-7b 32 -> 8 layers (one scan group of 8), zamba2-7b 81 -> 18 (two
# groups of 9, three shared-block applications), olmoe-1b-7b 16 -> 4,
# llama-3.2-vision-11b 40 -> 5 (one super-block: 4 self layers and a
# cross layer; depth 10, 3.23 G parameters, takes 51.7 GB before the cross
# layers' recompute, whose f32 scores over 6404 image tokens are 6.7 GB a
# tensor); whisper-small whole (5.35 GB), at its 448-token context
# (arXiv:2212.04356) in place of TRAIN_SHAPE's 2048. ``check``: the depth
# and scan group of the f32 step held through the kernels against the
# same step through the plain versions.
TRAIN_MODELS = {
    "train_rwkv6": {"arch": "rwkv6-7b", "layers": 8,
                    "params": 2_296_811_520, "check": (2, 2)},
    "train_zamba2": {"arch": "zamba2-7b", "layers": 18,
                     "params": 1_838_512_800, "check": (6, 3)},
    "train_olmoe": {"arch": "olmoe-1b-7b", "layers": 4,
                    "params": 1_884_309_504, "check": (2, 0)},
    "train_vlm": {"arch": "llama-3.2-vision-11b", "layers": 5,
                  "params": 2_141_237_250, "check": (5, 0)},
    "train_whisper": {"arch": "whisper-small", "layers": 12,
                      "params": 334_516_224, "check": (12, 0), "seq": 448},
}
TRAIN_SHAPE = {"global_batch": 8, "seq": 2048, "warmup": 2, "steps": 2}
# olmoe-1b-7b whole (16 layers, 64 experts, top 8): nothing cut
SERVE_OLMOE = {"arch": "olmoe-1b-7b", "batch": 4, "prompt": 1024, "gen": 32}
RECOMPUTE_RANGES = ("wkv6_recompute_bwd", "ssd_recompute_bwd",
                    "flash_recompute_bwd")
MOE_RANGES = ("moe_route", "moe_dispatch", "moe_experts", "moe_combine")


def remat_forwards(n_layers: int, group: int, layers) -> int:
    """Forward runs, in one microbatch's forward and backward under block
    remat, of a kernel that runs in each of ``layers``: the forward and
    the layer's recompute, and, where groups of ``group`` layers divide
    the depth, the group's recompute too, which stops after the input of
    the group's last layer (non-reentrant checkpoints stop early).
    tests/test_torch_ssm_train.py finds the same counts on the CPU."""
    grouped = group > 1 and n_layers % group == 0
    return sum(2 + (grouped and i % group != group - 1) for i in layers)


def train_launches(cfg, run) -> dict:
    """Each kernel's launches in one microbatch of training. The VLM nests
    its remat (tests/test_torch_vlm.py counts it on the CPU): a group's
    forward (p-1 self layers and a cross layer), its recompute (all of
    them: the cross layer closes the group and holds saved tensors), each
    self layer's own recompute. whisper checkpoints each encoder and
    decoder layer (tests/test_torch_audio.py): each attention twice."""
    L, G = cfg.num_layers, run.scan_group
    counts = {"blockhash": 0, "wkv6": 0, "ssd": 0, "flash_attention": 0}
    if cfg.family == "vlm":
        s = cfg.cross_attn_every - 1
        counts["flash_attention"] = L // (s + 1) * (3 * s + 2)
    elif cfg.family == "audio":
        counts["flash_attention"] = 2 * (cfg.encoder_layers + 2 * L)
    elif cfg.family == "ssm":
        counts["wkv6"] = remat_forwards(L, G, range(L))
    elif cfg.family == "hybrid":
        e = cfg.shared_attn_every
        counts["ssd"] = remat_forwards(L, G, range(L))
        counts["flash_attention"] = remat_forwards(
            L, G, [i for i in range(L) if i % e == e - 1])
    else:
        counts["flash_attention"] = remat_forwards(L, G, range(L))
    return counts


def recompute_applications(cfg) -> dict:
    """Each kernel's applications in one microbatch's forward: its
    recompute range (the Function's backward) runs once for each."""
    from repro_torch.models import mamba2

    if cfg.family == "ssm":
        return {"wkv6": cfg.num_layers}
    if cfg.family == "hybrid":
        return {"ssd": cfg.num_layers,
                "flash": mamba2.n_shared_applications(cfg)}
    if cfg.family == "audio":
        return {"flash": cfg.encoder_layers + 2 * cfg.num_layers}
    return {"flash": cfg.num_layers}  # dense, MoE; the VLM's self and cross


def moe_range_calls(cfg, tokens: int, forwards: int) -> dict:
    """Each MoE range's calls in ``forwards`` runs of a MoE layer over
    ``tokens`` tokens (every layer of the MoE family, so as many as its
    attention's): one a token group, ``models.moe.moe_apply`` cutting
    groups of MOE_GROUP tokens, or one of all of them where that does not
    divide them. None outside the MoE family."""
    from repro_torch.models import moe

    if cfg.family != "moe":
        return {}
    group = min(moe.MOE_GROUP, tokens)
    groups = tokens // group if tokens % group == 0 else 1
    return {r: forwards * groups for r in MOE_RANGES}


def profile_device(fn, range_names=()) -> dict:
    """``fn()`` under ``torch.profiler`` tracing the device alone (no host
    operators: a training step's host events, hundreds of thousands, made
    each ``key_averages()`` take tens of seconds), with the ranges in
    ``range_names`` (``repro_torch.ranges``) timed by CUDA events: each
    range's calls and its span on the stream, idle included. Returns the
    wall seconds of ``fn``, the device's (µs, count) by kernel name, the
    ranges, and the seconds the profiler's tables took."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import ranges as R

    torch.cuda.synchronize()
    with R.timed(range_names, "cuda") as ranges:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_name = device_window(prof)
    return {"wall_s": wall, "by_name": by_name, "ranges": ranges,
            "tables_s": time.perf_counter() - t0}


def device_kinds(by_name: dict) -> dict:
    """Device µs and count by kernel kind (``_kernel_kind``)."""
    kinds = {}
    for kname, (us, c) in by_name.items():
        kind = kinds.setdefault(_kernel_kind(kname), {"us": 0.0, "count": 0})
        kind["us"] += us
        kind["count"] += c
    return kinds


def _scan_arrays(name, rng):
    """The inputs of one scan at its training shape, float32 numpy, as the
    kernel phases draw them; and which of them the model hands the kernel
    in the compute dtype (the rest stay float32)."""
    if name == "wkv6":
        B, S, H, Kd, V, C = SCAN_GRAD[name]
        return wkv6_inputs(rng, B, S, H, Kd, V, "smoke"), (0, 1, 2, 3)
    b, S, H, P, N, C = SCAN_GRAD[name]
    n = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    return (n(b, S, H, P), np.logaddexp(0, n(b, S, H)).astype(np.float32),
            n(b, S, N) * 0.5, n(b, S, N) * 0.5, n(H) * 0.3, 1 + 0.1 * n(H),
            n(b, H, P, N) * 0.1), (0, 2, 3)


def phase_scan_grad(name):
    """The scan's autograd Function (``_WKV6`` or ``_SSD``) at its model's
    training shape, in f32 and bf16: its forward (the kernel, one launch)
    against the plain forward within the kernel's tolerance; the input
    gradients of its backward (a recompute through the plain version, no
    launch) against autograd through the plain version within 1e-3 x
    max(1, max|plain|) each, in the input's dtype (both differentiate the
    plain version: this checks the wiring); the recompute backward's time
    a call by CUDA events and its memory peak above what was allocated."""
    import torch

    from repro_torch.kernels.ssd import kernel as SK, ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.kernels.wkv6 import kernel as WK, ops as wkv_ops
    from repro_torch.kernels.wkv6 import ref as wkv_ref

    K, kernel, op, plain, tol = {
        "wkv6": (WK, WK.wkv6_chunked, wkv_ops.wkv6, wkv_ref.wkv6, WKV6_TOL),
        "ssd": (SK, SK.ssd_chunked, ssd_ops.ssd, ssd_ref.ssd, SSD_TOL)}[name]
    shape = SCAN_GRAD[name]
    C = shape[-1]
    rng = np.random.default_rng(2030)
    arrays, low = _scan_arrays(name, rng)
    out_shape = arrays[2].shape if name == "wkv6" else arrays[0].shape
    dev = torch.device("cuda")
    gy = torch.from_numpy(rng.standard_normal(out_shape, dtype=np.float32)
                          ).to(dev)
    gs = torch.from_numpy(rng.standard_normal(arrays[-1].shape,
                                              dtype=np.float32)).to(dev)
    rows = []
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        args = [torch.from_numpy(a).to(dev, dt if i in low else torch.float32)
                .requires_grad_() for i, a in enumerate(arrays)]
        l0 = K.launches()
        y, st = op(*args, chunk=C, use_kernel=True)
        with torch.no_grad():
            y_ref, st_ref = plain(*args, chunk=C)
        fwd_err, ok = [], True
        for got, want in ((y, y_ref), (st, st_ref)):
            err = (got - want).abs().max().item()
            ok &= err <= tol * max(1.0, want.abs().max().item())
            fwd_err.append(err)
        assert y.grad_fn is not None and ok, (name, dtype, fwd_err)
        del y_ref, st_ref
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = torch.autograd.grad((y, st), args, (gy, gs), retain_graph=True)
        torch.cuda.synchronize()
        bwd_peak = torch.cuda.max_memory_allocated() - base
        launched = K.launches() - l0
        assert launched == 1, launched  # the backward launched nothing
        yp, sp = plain(*args, chunk=C)
        want = torch.autograd.grad((yp, sp), args, (gy, gs))
        del yp, sp
        grad_rel = []
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == b.dtype == args[i].dtype, (i, a.dtype, b.dtype)
            grad_rel.append(((a.float() - b.float()).abs().max() / max(
                1.0, b.float().abs().max().item())).item())
        assert max(grad_rel) <= GRAD_TOL, (name, dtype, grad_rel)
        del got, want
        bwd_ms = call_ms(lambda: torch.autograd.grad(
            (y, st), args, (gy, gs), retain_graph=True), count=2, reps=3)
        plain_args = [a.detach() for a in args]
        fwd_ms = device_ms(lambda: kernel(*plain_args, chunk=C), count=5,
                           reps=10)
        fwd_bound = (wkv6_bound(*shape, dtype) if name == "wkv6" else
                     bound(*ssd_work(*shape, args[0].element_size()), dtype))
        row = {"shape": list(shape), "dtype": dtype, "forward_err": fwd_err,
               "kernel_fwd_bound_ms": fwd_bound["bound_ms"],
               "kernel_fwd_bound_by": fwd_bound["bound_by"],
               "forward_tolerance": f"{tol} x max(1, max|plain|)",
               "grad_max_rel_err": max(grad_rel),
               "grad_rel_err_by_input": grad_rel,
               "grad_tolerance": f"{GRAD_TOL} x max(1, max|plain|)",
               "launches": launched, "kernel_fwd_ms": fwd_ms,
               "recompute_bwd_ms": bwd_ms,
               "recompute_bwd_peak_bytes": bwd_peak}
        rows.append(row)
        emit(f"{name}_grad", **row)
        del y, st, args
        torch.cuda.empty_cache()
    return rows


def attention_pairs(cfg, seq: int) -> int:
    """(query, key) pairs a sequence's softmax attention scores, summed
    over the model's attention applications: causal over the tokens in
    the dense and MoE layers, zamba2's shared block and the decoders;
    every image token in the VLM's cross layers; every frame in whisper's
    encoder and in its cross attention; none in rwkv6."""
    from repro_torch.models import mamba2

    causal = seq * (seq + 1) // 2
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return mamba2.n_shared_applications(cfg) * causal
    if cfg.family == "vlm":
        groups = cfg.num_layers // cfg.cross_attn_every
        return ((cfg.num_layers - groups) * causal
                + groups * seq * cfg.num_image_tokens)
    if cfg.family == "audio":
        T = cfg.encoder_seq
        return (cfg.encoder_layers * T * T
                + cfg.num_layers * (causal + seq * T))
    return cfg.num_layers * causal


def context_params(cfg) -> tuple:
    """(parameters that run on the context, its length a sequence): the
    VLM's cross key and value projections on the image tokens; whisper's
    encoder and its cross key and value projections on the frames."""
    kv = 2 * cfg.d_model * cfg.kv_dim
    if cfg.family == "vlm":
        return cfg.num_layers // cfg.cross_attn_every * kv, cfg.num_image_tokens
    if cfg.family == "audio":
        d, ff = cfg.d_model, cfg.d_ff
        enc_layer = 2 * d + 2 * d * cfg.q_dim + kv + 3 * d * ff
        return (cfg.encoder_layers * enc_layer + d + cfg.num_layers * kv,
                cfg.encoder_seq)
    return 0, 0


def train_flops(cfg, n_params: int, batch: int, seq: int) -> int:
    """Model operations of one training step: 6 N a token for the
    parameters' products (the forward and both halves of the backward; N
    the active parameters of a MoE), those that run on a context (image
    tokens, audio frames) counted a context token instead, plus the
    attention's two products over its pairs (``attention_pairs``), 3 times
    (the forward and the backward). The remat's forwards are not counted:
    they are work the model does not need; nor are the WKV6 and SSD scans'
    own operations, under 1 % of the products'."""
    ctx_n, ctx_len = context_params(cfg)
    attn_fwd = (2 * 2 * batch * cfg.num_heads * cfg.head_dim
                * attention_pairs(cfg, seq))
    return (6 * (n_params - ctx_n) * batch * seq
            + 6 * ctx_n * batch * ctx_len + 3 * attn_fwd)


def phase_train_model(name):
    """A training path beyond the dense one: rwkv6-7b (``train_rwkv6``),
    zamba2-7b (``train_zamba2``), olmoe-1b-7b (``train_olmoe``),
    llama-3.2-vision-11b (``train_vlm``, its gates drawn from the seed) or
    whisper-small (``train_whisper``) at full width through
    train.trainer.Trainer on the card, with the bundle's RunConfig (f32
    parameters and moments, bf16 compute, block remat in groups of
    ``scan_group`` layers or the VLM's nested groups, microbatches of
    ``microbatch_per_data_shard``) and the depth TRAIN_MODELS gives. 8 x
    2048 tokens a step (whisper: 8 x 448) on one repeated batch
    (``OneBatch``: the loss must fall; SyntheticLM draws the stub
    embeddings); 2 warm-up steps and 3 timed ones, each kernel's count
    read around each step and held to ``train_launches``. Then one
    profiled step (the device traced alone; the recompute backwards'
    ranges timed by CUDA events, their calls held to the applications),
    and, with the trainer freed, one microbatch in f32 at the check depth
    through the kernels and through the plain versions: the loss and every
    gradient leaf."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.models import lm, params as P
    from repro_torch.train.step import num_accum_steps
    from repro_torch.train.trainer import Trainer

    spec = TRAIN_MODELS[name]
    kernels = _kernel_counts()
    base = torch.cuda.memory_allocated()  # what the card holds already
    bundle = registry.get(spec["arch"])
    cfg = dataclasses.replace(bundle.model, num_layers=spec["layers"])
    run = bundle.run
    assert (run.param_dtype, run.moment_dtype, run.compute_dtype,
            run.remat) == ("float32", "float32", "bfloat16", "block")
    gb, seq = TRAIN_SHAPE["global_batch"], spec.get("seq", TRAIN_SHAPE["seq"])
    ctx = ShardingCtx.null()
    n_accum = num_accum_steps(run, ctx, gb)
    per_micro = train_launches(cfg, run)
    per_step = {k: n_accum * v for k, v in per_micro.items()}
    dev = torch.device("cuda")
    seconds = {}  # where the phase's own time goes

    t0 = time.perf_counter()
    t = Trainer(cfg, run, global_batch=gb, seq_len=seq, seed=0,
                data=OneBatch(SyntheticLM(cfg, gb, seq, seed=0)))
    assert t.device.type == "cuda"
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(math.prod(x.shape) for x in P.leaves(t.params))
    assert n_params == spec["params"] == cfg.param_count(), n_params
    active = cfg.active_param_count()
    gates = draw_gates(t.params, seed=0)

    # the main path: every count set to 0 just before, read just after
    n_steps = TRAIN_SHAPE["warmup"] + TRAIN_SHAPE["steps"]
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.reset_launches()
    step_s, step_launches = [], []
    for i in range(n_steps):
        l0 = {k: m.launches() for k, m in kernels.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train(i + 1)  # one step; its metrics reach the host
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        step_launches.append({k: m.launches() - l0[k]
                              for k, m in kernels.items()})
        held = TRAIN_MESH_CROSS.get(mesh_of(name))
        if held and i + 1 == held["steps"]:
            # what the mesh phase's partitioned trainer holds after its
            # steps (on the host: the mesh phase's state and cells need
            # the card)
            TRAIN_STATE_AT[name] = state_copy(t, "cpu")
    main_launches = {k: m.launches() for k, m in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    assert step_launches == [per_step] * n_steps, (step_launches, per_step)
    assert main_launches == {k: v * n_steps for k, v in per_step.items()}
    losses = [m["loss"] for m in t.metrics_log]
    assert len(losses) == n_steps and all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    timed = step_s[TRAIN_SHAPE["warmup"]:]
    step_med = statistics.median(timed)
    flops = train_flops(cfg, active, gb, seq)
    seconds["steps"] = sum(step_s)

    # one profiled step, the device traced alone: the recompute backwards
    # and the MoE layer's parts under their named ranges, timed by CUDA
    # events
    t_prof = time.perf_counter()
    prof = profile_device(lambda: t.train(t.step_idx + 1),
                          RECOMPUTE_RANGES + MOE_RANGES)
    seconds["profiled_step_with_trace"] = time.perf_counter() - t_prof
    seconds["profile_tables"] = prof["tables_s"]
    by_name, ranges, prof_wall = prof["by_name"], prof["ranges"], prof["wall_s"]
    busy_us = sum(us for us, _ in by_name.values())
    assert busy_us > 0, "the profiler saw no device time in the step"
    kinds = device_kinds(by_name)
    recompute_us = sum(ranges[r]["span_us"] for r in RECOMPUTE_RANGES
                       if r in ranges)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    profiled = {
        "wall_s": prof_wall, "device_busy_s": busy_us * 1e-6,
        "device_idle_share": 1 - busy_us * 1e-6 / prof_wall,
        "ranges": ranges, "recompute_bwd_span_us": recompute_us,
        "recompute_bwd_span_share_of_unprofiled_step":
            recompute_us * 1e-6 / step_med,
        "device_by_kind": kinds,
        "device_top": [{"name": kn[:80], "us": us, "count": c}
                       for kn, (us, c) in top]}
    recompute_ms = {r.split("_")[0]: ranges[r]["span_us"] / ranges[r][
        "calls"] * 1e-3 for r in RECOMPUTE_RANGES
        if ranges.get(r, {}).get("calls")}
    # a range counts its Function's backwards, one an application of the
    # kernel a microbatch, and none of its forwards
    range_calls = {r.split("_")[0]: ranges[r]["calls"]
                   for r in RECOMPUTE_RANGES if r in ranges}
    assert range_calls == {k: n_accum * v for k, v in
                           recompute_applications(cfg).items()}, range_calls
    # and each MoE range one call a token group in each forward of a layer
    moe_calls = {r: ranges[r]["calls"] for r in MOE_RANGES if r in ranges}
    assert moe_calls == moe_range_calls(
        cfg, gb // n_accum * seq, per_step["flash_attention"]), moe_calls
    del t
    torch.cuda.empty_cache()

    # one microbatch in f32 at the check depth, through the kernels and
    # through the plain versions: the loss and every gradient leaf
    t_check = time.perf_counter()
    check_layers, check_group = spec["check"]
    ccfg = dataclasses.replace(bundle.model, num_layers=check_layers)
    crun = run.replace(compute_dtype="float32", scan_group=check_group)
    prm = P.materialize(lm.param_specs(ccfg),
                        torch.Generator(device=dev).manual_seed(1), dev)
    draw_gates(prm, seed=1)
    mb = {k: torch.from_numpy(v[:gb // n_accum]).to(dev)
          for k, v in SyntheticLM(ccfg, gb, seq, seed=0).batch(0).items()}

    def loss_and_grads():
        p = P.tree_map(lambda x: x.detach().requires_grad_(), prm)
        loss, _ = lm.loss_fn(ccfg, crun, ctx, p, mb)
        return loss.item(), torch.autograd.grad(loss, list(P.leaves(p)))

    l0 = {k: m.launches() for k, m in kernels.items()}
    loss_k, grads_k = loss_and_grads()
    check_launches = {k: m.launches() - l0[k] for k, m in kernels.items()}
    assert check_launches == train_launches(ccfg, crun), check_launches
    loss_p, grads_p = through_plain(loss_and_grads)
    f32_loss_err = abs(loss_k - loss_p)
    assert f32_loss_err <= 1e-4 * max(1.0, abs(loss_p)), (loss_k, loss_p)
    grad_rel = [((a - b).abs().max() / max(1.0, b.abs().max().item())).item()
                for a, b in zip(grads_k, grads_p)]
    assert max(grad_rel) <= GRAD_TOL, max(grad_rel)
    del prm, mb, grads_k, grads_p
    torch.cuda.empty_cache()
    seconds["f32_check"] = time.perf_counter() - t_check

    cut = None if cfg.num_layers == bundle.model.num_layers else (
        f"depth {bundle.model.num_layers} -> {cfg.num_layers}: f32 "
        f"parameters, gradients and Adam moments at 16 bytes a parameter")
    emit(name, arch=cfg.name, layers=cfg.num_layers, cut=cut,
         gates=gates, d_model=cfg.d_model, params=n_params,
         active_params=active, param_dtype=run.param_dtype,
         moment_dtype=run.moment_dtype, compute_dtype=run.compute_dtype,
         remat=run.remat, scan_group=run.scan_group, global_batch=gb,
         seq=seq, microbatches=n_accum, init_s=init_s,
         warmup_steps=TRAIN_SHAPE["warmup"], timed_steps=len(timed),
         step_ms=step_med * 1e3, step_ms_all=[x * 1e3 for x in step_s],
         tokens_per_s=gb * seq / step_med, peak_memory_bytes=peak,
         base_memory_bytes=base,
         model_flops_per_step=flops,
         model_flops_share_of_bf16_peak=flops / step_med / BF16_TENSOR_OPS_PER_S,
         losses=losses, launches_per_microbatch=per_micro,
         launches_per_step=per_step, main_path_launches=main_launches,
         check_layers=check_layers, check_scan_group=check_group,
         check_launches=check_launches, f32_loss_kernel=loss_k,
         f32_loss_plain=loss_p, f32_loss_err=f32_loss_err,
         f32_grad_max_rel_err=max(grad_rel),
         f32_tolerance={"loss": "1e-4 x max(1, |plain|)",
                        "grads": f"{GRAD_TOL} x max(1, max|plain|) a leaf"},
         recompute_bwd_ms_per_call=recompute_ms, profiled_step=profiled,
         seconds=seconds)
    return main_launches, recompute_ms


def logits_against_plain(cfg, run, prm, batch, keep=None) -> dict:
    """One prefill of ``batch`` through the kernels and through the plain
    versions (``through_plain``), in bf16 and with an f32 copy of the
    weights, each timed on the host clock. The f32 logits are held within
    2e-2 x max(1, max|plain|). In bf16 the kernel's logits may lie no
    further from the f32 ones than twice the plain version's bf16 logits
    do, as serve_smollm holds; and serve_smollm's absolute bound, the
    kernel's bf16 tolerance at the logits' scale, holds them against the
    plain version's wherever bf16 itself stays within it: where the plain
    version's own bf16 logits lie further than that from the f32 ones (a
    router's flipped top-8 choice moves a token by more than any
    attention's rounding), the bound is void for every attention (phase
    flash_attention_kernel holds the kernel itself at FLASH_TOL at the
    prefill's shapes). Returns the times, errors and bounds."""
    import torch

    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.models import lm, params as P

    ctx = ShardingCtx.null()

    def timed_prefill(params, rn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, _ = lm.prefill_fn(cfg, rn, ctx, params, batch)
        torch.cuda.synchronize()
        return logits, time.perf_counter() - t0

    logits, prefill_s = timed_prefill(prm, run)
    logits_ref, prefill_ref_s = through_plain(lambda: timed_prefill(prm, run))
    assert torch.isfinite(logits).all() and torch.isfinite(logits_ref).all()
    bf16_err, bf16_scale = _logits_err(logits, logits_ref)
    assert not torch.backends.cuda.matmul.allow_tf32
    prm32 = P.tree_map(lambda t: t.float(), prm)
    run32 = run.replace(compute_dtype="float32")
    logits32, prefill_f32_s = timed_prefill(prm32, run32)
    logits32_ref, _ = through_plain(lambda: timed_prefill(prm32, run32))
    if keep is not None:  # for the partitioned serve of the same weights
        SERVE_F32_LOGITS[keep] = logits32_ref.cpu()
    del prm32
    torch.cuda.empty_cache()
    f32_err, f32_scale = _logits_err(logits32, logits32_ref)
    assert f32_err <= 2e-2 * f32_scale, (f32_err, f32_scale)
    kernel_vs_f32_err, _ = _logits_err(logits, logits32_ref)
    plain_vs_f32_err, _ = _logits_err(logits_ref, logits32_ref)
    assert kernel_vs_f32_err <= 2 * plain_vs_f32_err, (kernel_vs_f32_err,
                                                       plain_vs_f32_err)
    tol = FLASH_TOL["bfloat16"]
    bf16_bound = tol + tol * bf16_scale
    bf16_bound_applies = plain_vs_f32_err <= bf16_bound
    assert bf16_err <= bf16_bound or not bf16_bound_applies, (bf16_err,
                                                              bf16_bound)
    return {"prefill_ms": prefill_s * 1e3,
            "prefill_ref_ms": prefill_ref_s * 1e3,
            "prefill_f32_ms": prefill_f32_s * 1e3,
            "logits_bf16_max_abs_err": bf16_err,
            "logits_bf16_scale": bf16_scale,
            "logits_f32_max_abs_err": f32_err, "logits_f32_scale": f32_scale,
            "logits_f32_tolerance": "2e-2 x max(1, max|plain|)",
            "logits_bf16_bound": bf16_bound,
            "logits_bf16_tolerance": f"{tol} + {tol} max|plain|",
            "logits_bf16_bound_applies": bf16_bound_applies,
            "logits_bf16_kernel_vs_f32_err": kernel_vs_f32_err,
            "logits_bf16_plain_vs_f32_err": plain_vs_f32_err}


def phase_serve_olmoe():
    """The MoE model path: olmoe-1b-7b whole (16 layers, d_model 2048, 16
    heads of 128, 64 experts of d_ff 1024, top 8, vocabulary 50304) in
    bf16, seeded random weights on the card, batch 4, a 1024-token prompt
    and 32 greedy tokens through launch/serve.generate, every kernel count
    set to 0 just before and read just after: flash launches once a layer
    in the prefill and never in a decode step. The prefill through the
    kernel and through the plain attention with an f32 copy of the
    weights (held within 2e-2 x max(1, max|plain|)) and in bf16, where the
    attention's rounding may flip a router's top-8 choice and move a
    token's output by a whole expert's share: there the kernel's logits
    are held no further from the f32 ones than twice the plain version's,
    and within serve_smollm's absolute bound against the plain version's
    wherever the plain version's own bf16 logits lie within it of the f32
    ones. Then a profiled prefill and 8 decode steps, the MoE layer's four parts
    under their named ranges."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch import serve
    from repro_torch.models import lm, params as P
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    kernels = _kernel_counts()
    base = torch.cuda.memory_allocated()  # what the card holds already
    FA = kernels["flash_attention"]
    bundle = registry.get(SERVE_OLMOE["arch"])
    cfg, run = bundle.model, bundle.run
    ctx = ShardingCtx.null()
    dev = torch.device("cuda")
    B, prompt, gen = (SERVE_OLMOE["batch"], SERVE_OLMOE["prompt"],
                      SERVE_OLMOE["gen"])
    L = cfg.num_layers

    g = torch.Generator(device=dev).manual_seed(0)
    prm = P.materialize(lm.param_specs(cfg), g, dev, dtype=run.compute_dtype)
    tokens = torch.randint(0, cfg.vocab_size, (B, prompt), generator=g,
                           device=dev, dtype=torch.int32)
    n_params = sum(t.numel() for t in P.leaves(prm))
    assert n_params == 6_919_096_320 == cfg.param_count(), n_params
    assert (L, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.num_experts,
            cfg.experts_per_token) == (16, 2048, 16, 16, 128, 1024, 50304,
                                       64, 8)

    # the main path, every count set to 0 just before and read just after
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.reset_launches()
    ids, times = serve.generate(cfg, run, prm, {"tokens": tokens}, gen)
    main_launches = {name: mod.launches() for name, mod in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    assert main_launches == {"blockhash": 0, "wkv6": 0, "ssd": 0,
                             "flash_attention": L}, main_launches
    assert ids.shape == (B, gen) and ((0 <= ids) & (ids < cfg.vocab_size)).all()

    # one prefill and one decode step alone: L launches, then none
    prefill = make_prefill_step(cfg, run, ctx)
    decode = make_decode_step(cfg, run, ctx)
    l0 = FA.launches()
    tok, cache = prefill(prm, {"tokens": tokens})
    prefill_launches = FA.launches() - l0
    cache = serve.pad_cache(cfg, cache, 1)
    l0 = FA.launches()
    tok2, cache = decode(prm, cache, {"tokens": tok[:, None], "pos": prompt})
    decode_launches = FA.launches() - l0
    assert (prefill_launches, decode_launches) == (L, 0)
    assert (tok.cpu().numpy() == ids[:, 0]).all()
    assert (tok2.cpu().numpy() == ids[:, 1]).all()
    del cache

    chk = logits_against_plain(cfg, run, prm, {"tokens": tokens},
                               keep="serve_olmoe")
    trace = serve_profile(cfg, run, prm, tokens, ranges=MOE_RANGES)
    assert 0 < trace["prefill"]["flash_launches"] <= L, trace["prefill"]
    assert trace["decode_8_steps"]["flash_launches"] == 0
    for part, tok_n, forwards in (("prefill", B * prompt, L),
                                  ("decode_8_steps", B, 8 * L)):
        calls = {r: v["calls"] for r, v in trace[part]["ranges"].items()}
        assert calls == moe_range_calls(cfg, tok_n, forwards), (part, calls)
    emit("serve_olmoe", arch=cfg.name, layers=L, d_model=cfg.d_model,
         experts=cfg.num_experts, experts_per_token=cfg.experts_per_token,
         params=n_params, active_params=cfg.active_param_count(),
         dtype=run.compute_dtype, batch=B, prompt=prompt, gen=gen,
         prefill_cold_ms=times["prefill_s"] * 1e3,
         decode_ms_per_token=times["decode_s_per_token"] * 1e3,
         tokens_per_s=B / times["decode_s_per_token"],
         peak_memory_bytes=peak,
         base_memory_bytes=base, flash_launches_per_prefill=prefill_launches,
         flash_launches_per_decode_step=decode_launches,
         main_path_launches=main_launches,
         generated_ids_row0=ids[0].tolist(), **chk, trace=trace)
    return main_launches["flash_attention"], prm, tokens


# The cross-attention families served whole in bf16, seed 0: the VLM
# (llama-3.2-vision-11b; 32 self layers and 8 gated cross layers over
# 6404 stub image tokens a row) and whisper-small (12 encoder layers over
# 1500 stub frames, 12 decoder layers with cross attention; its prompt
# and 32 greedy tokens inside its 448-token context). ``launches``: flash
# a prefill (VLM: 32 self + 8 cross; whisper: 12 encoder + 12 decoder
# self + 12 cross).
SERVE_CROSS = {
    "serve_vlm": {"arch": "llama-3.2-vision-11b", "batch": 4, "prompt": 1024,
                  "gen": 32, "params": 9_775_157_264, "launches": 40,
                  "embeds": "image_embeds"},
    "serve_whisper": {"arch": "whisper-small", "batch": 4, "prompt": 384,
                      "gen": 32, "params": 334_516_224, "launches": 36,
                      "embeds": "frame_embeds"},
}


def phase_serve_cross(name):
    """A cross-attention family served whole (``serve_vlm``,
    ``serve_whisper``): seeded random weights in bf16 on the card (the
    VLM's gates drawn from the seed, away from 0), stub embeddings drawn
    from the seed at SyntheticLM's scale (0.02), batch 4, its prompt and
    32 greedy tokens through launch/serve.generate, every kernel count set
    to 0 just before and read just after: flash launches once an attention
    in the prefill (the VLM's self and cross layers; whisper's encoder
    layers and its decoder's self and cross attention) and never in a
    decode step. Then the prefill through the kernel and the plain
    version (``logits_against_plain``, its f32 plain logits kept for the
    partitioned serve), the same prefill with the gates at 0 (the VLM: the
    cross layers must move the logits by more than the kernel's bf16
    bound), and a profiled prefill and 8 decode steps. Returns the flash
    launches, the weights and the batch (tokens and embeddings), which
    the partitioned serve of the same model takes (``phase_serve_mesh``)."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch import serve
    from repro_torch.models import lm, params as P
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    spec = SERVE_CROSS[name]
    kernels = _kernel_counts()
    base = torch.cuda.memory_allocated()  # what the card holds already
    FA = kernels["flash_attention"]
    bundle = registry.get(spec["arch"])
    cfg, run = bundle.model, bundle.run
    ctx = ShardingCtx.null()
    dev = torch.device("cuda")
    B, prompt, gen = spec["batch"], spec["prompt"], spec["gen"]
    n_ctx = (cfg.num_image_tokens if cfg.family == "vlm"
             else cfg.encoder_seq)
    seconds = {}

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    prm = P.materialize(lm.param_specs(cfg), g, dev, dtype=run.compute_dtype)
    tokens = torch.randint(0, cfg.vocab_size, (B, prompt), generator=g,
                           device=dev, dtype=torch.int32)
    embeds = (0.02 * torch.randn((B, n_ctx, cfg.d_model), generator=g,
                                 device=dev)).to(torch.bfloat16)
    batch = {"tokens": tokens, spec["embeds"]: embeds}
    gates = draw_gates(prm, seed=0)
    n_params = sum(t.numel() for t in P.leaves(prm))
    assert n_params == spec["params"] == cfg.param_count(), n_params
    if cfg.family == "audio":
        assert prompt + gen <= 448  # whisper's context
    torch.cuda.synchronize()
    seconds["init"] = time.perf_counter() - t0

    # the main path, every count set to 0 just before and read just after
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.reset_launches()
    ids, times = serve.generate(cfg, run, prm, batch, gen)
    main_launches = {k: mod.launches() for k, mod in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    assert main_launches == {"blockhash": 0, "wkv6": 0, "ssd": 0,
                             "flash_attention": spec["launches"]}, \
        main_launches
    assert ids.shape == (B, gen) and ((0 <= ids) & (ids < cfg.vocab_size)).all()

    # the same steps one at a time: the prefill's launches, none in each
    # decode step, the same greedy ids
    t0 = time.perf_counter()
    prefill = make_prefill_step(cfg, run, ctx)
    decode = make_decode_step(cfg, run, ctx)
    l0 = FA.launches()
    tok, cache = prefill(prm, batch)
    prefill_launches = FA.launches() - l0
    cache = serve.pad_cache(cfg, cache, gen)
    step_ids, step_launches = [tok.cpu()], []
    for i in range(gen - 1):
        l0 = FA.launches()
        tok, cache = decode(prm, cache, {"tokens": tok[:, None],
                                         "pos": prompt + i})
        step_ids.append(tok.cpu())
        step_launches.append(FA.launches() - l0)
    del cache
    assert prefill_launches == spec["launches"], prefill_launches
    assert step_launches == [0] * (gen - 1), step_launches
    assert (torch.stack(step_ids, dim=1).numpy() == ids).all()
    seconds["steps"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    chk = logits_against_plain(cfg, run, prm, batch, keep=name)
    seconds["logits_against_plain"] = time.perf_counter() - t0
    moved = None
    if gates is not None:  # the cross layers move the logits
        cross = prm["stack"]["cross"]
        with torch.no_grad():
            gated, _ = lm.prefill_fn(cfg, run, ctx, prm, batch)
            saved = {k: cross[k].clone() for k in ("gate_attn", "gate_mlp")}
            for k in saved:
                cross[k].zero_()
            ungated, _ = lm.prefill_fn(cfg, run, ctx, prm, batch)
            for k, v in saved.items():
                cross[k].copy_(v)
        moved = (gated.float() - ungated.float()).abs().max().item()
        assert moved > chk["logits_bf16_bound"], (moved, chk)
        del gated, ungated

    decode_flash_check(cfg, run, prm, extra={spec["embeds"]: embeds})
    t0 = time.perf_counter()
    trace = serve_profile(cfg, run, prm, tokens,
                          extra={spec["embeds"]: embeds})
    assert 0 < trace["prefill"]["flash_launches"] <= spec["launches"], \
        trace["prefill"]
    assert trace["decode_8_steps"]["flash_launches"] == 0
    seconds["profile"] = time.perf_counter() - t0
    emit(name, arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
         heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
         head_dim=cfg.head_dim, context_tokens=n_ctx, params=n_params,
         dtype=run.compute_dtype, batch=B, prompt=prompt, gen=gen,
         gates=gates, prefill_cold_ms=times["prefill_s"] * 1e3,
         decode_ms_per_token=times["decode_s_per_token"] * 1e3,
         tokens_per_s=B / times["decode_s_per_token"],
         peak_memory_bytes=peak,
         base_memory_bytes=base, flash_launches_per_prefill=prefill_launches,
         flash_launches_per_decode_step=max(step_launches),
         main_path_launches=main_launches,
         generated_ids_row0=ids[0].tolist(),
         logits_moved_by_the_gates=moved, **chk, trace=trace,
         seconds=seconds)
    return main_launches["flash_attention"], prm, batch


# --- the mesh-parallel paths, on virtual meshes of the card -----------------------
#
# spmd.shard_map runs one thread per mesh cell; on a virtual mesh every cell
# is this one card, so the times below are those of one card doing every
# cell's work in turn, not of several cards.

SPMD_SHAPE = (4, 512, 1024)  # the whole tensor: one (512, 1024) slice a cell
# olmoe-1b-7b's prefill and decode under moe_impl="a2a" on a (data, model) =
# (1, 4) mesh: 16 of its 64 experts a cell; ``cell_flash``: the flash
# kernel's (q, k) in each cell's prefill layers (4 rows, 4 of the 16 heads)
A2A = {"mesh": (1, 4), "decode_steps": 4,
       "cell_flash": ((4, 1024, 4, 128), (4, 1024, 4, 128))}
# decode_flash: a prompt whose first decode positions lie in the first of 4
# cache shards (the 3 others fully masked), the cache padded to 4 shards
DECODE_FLASH = {"mesh": (1, 4), "steps": 2,
                "smollm-135m": (240, 1024), "zamba2-7b": (240, 1024),
                "llama-3.2-vision-11b": (240, 1024),
                "whisper-small": (96, 448)}
DECODE_FLASH_RESULTS = {}  # filled by the serve phases that hold the weights
# 10 of smollm-135m's 30 blocks a stage on a ("pod",) mesh of 3 cells, 6
# microbatches of 2 x 2048; each stage runs its blocks at each of M + S - 1
# ticks, and the flash kernel once a block (the backward recomputes through
# the plain version)
PIPELINE = {"stages": 3, "microbatches": 6, "mb": 2, "seq": 2048}
COMPRESSION = {"cells": 4, "steps": 3}


def phase_spmd():
    """Each collective of ``repro_torch.distributed.spmd`` on a virtual
    4-cell mesh of the card, inside ``shard_map``, held against its
    definition on the whole (4, 512, 1024) tensor: forward, and the
    gradient of its inner product with a random cotangent (the
    transposes); the
    joint axes on a (2, 2) mesh. Sums in cell order: 1e-6 x max(1,
    max|definition|)."""
    import torch

    from repro_torch.distributed import spmd
    from repro_torch.launch.mesh import make_mesh

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn(SPMD_SHAPE, generator=g, device=dev)
    line = make_mesh((4,), ("model",), [dev] * 4)
    square = make_mesh((2, 2), ("data", "model"), [dev] * 4)
    ring = [(i, (i + 1) % 4) for i in range(4)]
    n = SPMD_SHAPE[0]

    def a2a_def(x):  # chunk i of every source's rows, in source order
        return torch.stack([torch.cat([x[j].chunk(n, 0)[i] for j in range(n)])
                            for i in range(n)])

    cases = {
        "psum": (line, lambda x: spmd.psum(x, "model"),
                 lambda x: x.sum(0, keepdim=True).expand_as(x)),
        "pmax": (line, lambda x: spmd.pmax(x, "model"),
                 lambda x: x.amax(0, keepdim=True).expand_as(x)),
        "pmean": (line, lambda x: spmd.pmean(x, "model"),
                  lambda x: x.mean(0, keepdim=True).expand_as(x)),
        "all_gather": (line, lambda x: spmd.all_gather(x, "model", axis=1),
                       lambda x: torch.cat(list(x), 0)[None].expand(n, -1, -1)),
        # as moe_a2a sends: split dim 0 of the group's size, stacked at 0
        "all_to_all": (line, lambda x: spmd.all_to_all(
            x.reshape(n, -1, x.shape[-1]), "model", 0, 0).reshape(x.shape),
            a2a_def),
        "ppermute": (line, lambda x: spmd.ppermute(x, "model", ring),
                     lambda x: torch.roll(x, 1, dims=0)),
        "psum_joint": (square, lambda x: spmd.psum(x, ("data", "model")),
                       lambda x: x.sum(0, keepdim=True).expand_as(x)),
    }
    rows = {}
    for name, (mesh, fn, definition) in cases.items():
        axes = tuple(mesh.axis_names)
        spec = (axes,) if len(axes) > 1 else axes
        x = X.clone().requires_grad_()
        t0 = time.perf_counter()
        got = spmd.shard_map(fn, mesh, in_specs=(spec,), out_specs=spec)(x)
        G = torch.randn(got.shape, generator=g, device=dev)
        (got * G).sum().backward()
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        xd = X.clone().requires_grad_()
        want = definition(xd)
        (want * G).sum().backward()
        err = (got - want).abs().max().item()
        grad_err = (x.grad - xd.grad).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        gscale = max(1.0, xd.grad.abs().max().item())
        assert got.device.type == "cuda" and got.shape == want.shape, name
        assert err <= 1e-6 * scale and grad_err <= 1e-6 * gscale, (
            name, err, grad_err)
        rows[name] = {"max_abs_err": err, "grad_max_abs_err": grad_err,
                      "forward_backward_ms": call_s * 1e3}

    # a failing cell re-raises in the caller; the others do not hang
    def failing(x):
        if spmd.axis_index("model") == 2:
            raise KeyError("cell 2")
        return spmd.psum(x, "model")
    try:
        spmd.shard_map(failing, line, in_specs=(("model",),),
                       out_specs=("model",))(X)
        raise AssertionError("a failing cell was not re-raised")
    except KeyError:
        pass
    emit("spmd", mesh_cells=4, shape=list(SPMD_SHAPE), device="virtual",
         tolerance="1e-6 x max(1, max|definition|)", collectives=rows)
    return rows


def a2a_dropped_tokens(cfg, router, x, n_ranks: int):
    """The tokens of ``x`` (T, d), as a (T,) bool tensor on the host, at
    least one of whose top-k assignments moe_a2a's packing drops: each
    rank routes its slice of T / n_ranks tokens (the same product on the
    same rows as moe_a2a's), and an expert keeps its first C
    (``_pair_capacity``) in token order."""
    import torch

    from repro_torch.models.moe_a2a import _pair_capacity

    t_m = x.shape[0] // n_ranks
    C = _pair_capacity(t_m, cfg)
    out = []
    for r in range(n_ranks):
        logits = (x[r * t_m:(r + 1) * t_m] @ router.to(x.dtype)).float()
        ids = torch.topk(torch.softmax(logits, dim=-1),
                         cfg.experts_per_token, dim=-1)[1]
        picked = torch.zeros(t_m, cfg.num_experts, device=x.device)
        picked.scatter_(1, ids, 1.0)
        nth = picked.cumsum(dim=0) * picked  # 1-based, per expert
        out.append((nth > C).any(dim=1).cpu())
    return torch.cat(out)


def plain_a2a_moe(n_ranks: int, dropped: list):
    """``moe_a2a_apply``'s function written plainly, for ``n_ranks``
    model ranks: each rank's slice of the tokens routed on its own (the
    same product on the same rows), every expert keeping its first C
    (``_pair_capacity``) assignments of a rank in token order, each
    expert's kept tokens gathered and run through its FFN, the
    contributions added in f32 in expert order; no packing, no
    collectives. Appends each call's count of dropped assignments to
    ``dropped``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.common import mlp_apply
    from repro_torch.models.moe_a2a import _pair_capacity

    def apply(cfg, ctx, w, x):
        dt = x.dtype
        B, S, d = x.shape
        xt = x.reshape(-1, d)
        t_m = xt.shape[0] // n_ranks
        C = _pair_capacity(t_m, cfg)
        E = cfg.num_experts
        y = torch.zeros(xt.shape, dtype=torch.float32, device=x.device)
        aux, n_dropped = 0.0, 0
        for r in range(n_ranks):
            x_m = xt[r * t_m:(r + 1) * t_m]
            probs = torch.softmax((x_m @ w["router"].to(dt)).float(), dim=-1)
            wk, ids = torch.topk(probs, cfg.experts_per_token, dim=-1)
            wk = wk / torch.clamp(wk.sum(dim=-1, keepdim=True), min=1e-9)
            for e in range(E):
                tok, j = (ids == e).nonzero(as_tuple=True)  # token order
                n_dropped += max(0, tok.numel() - C)
                tok, j = tok[:C], j[:C]
                xe = x_m[tok]
                h = F.silu(xe @ w["w_gate"][e].to(dt)) * (
                    xe @ w["w_up"][e].to(dt))
                y.index_add_(0, r * t_m + tok, (h @ w["w_down"][e].to(dt))
                             .float() * wk[tok, j][:, None])
            counts = torch.bincount(ids.reshape(-1), minlength=E).float()
            aux = aux + E * torch.sum(counts / counts.sum().clamp(min=1)
                                      * probs.mean(dim=0))
        dropped.append(n_dropped)
        y = y.to(dt).reshape(B, S, d)
        if cfg.shared_expert:
            y = y + mlp_apply(w["shared"], x, ctx, cfg.act)
        return y, aux / n_ranks * cfg.router_aux_loss

    return apply


def a2a_logits_against_plain(cfg, run, a2a_ctx, prm, tokens, steps) -> dict:
    """The a2a serve's logits from the programs serve_olmoe_a2a times:
    serve/step's prefill and decode steps, partitioned over
    ``a2a_ctx``'s mesh, in bf16 and with an f32 copy of the weights,
    held with logits_against_plain's bounds: f32 within 2e-2 x
    max(1, max|plain|); bf16 no further from the f32 plain logits than
    twice the bf16 plain logits are, and within FLASH_TOL's bf16
    tolerance at the logits' scale of the bf16 plain logits wherever
    those stay within it of the f32 ones. The prefill is held against
    the same model unpartitioned with every MoE layer through
    ``plain_a2a_moe`` (the a2a path drops assignments where a rank's
    expert overflows its C slots, the dense dispatch's group capacity
    does not: the dense prefill computes another function). Each of
    ``steps`` decode steps is held against the dense serve's step from
    the same cache (the dense serve's, cut over the mesh by the step):
    one token a row, each rank routes 1 token, C = 8, nothing is
    dropped, and the two compute the same function. Both dtypes are fed
    the f32 dense serve's greedy tokens. Each step's greedy tokens (the
    group's argmax over the cells' vocabulary columns) are held equal to
    ``torch.argmax`` of its whole logits."""
    import torch

    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch import serve
    from repro_torch.models import lm, moe_a2a, params as P
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    null = ShardingCtx.null()
    B, prompt = tokens.shape
    prm32 = P.tree_map(lambda t: t.float(), prm)
    runs = {"bf16": (run, prm),
            "f32": (run.replace(compute_dtype="float32"), prm32)}
    real_a2a = moe_a2a.moe_a2a_apply
    dropped, decoders, greedy = {}, {}, []

    def held_greedy(tok, logits):
        greedy.append(bool(torch.equal(
            tok.cpu(), logits.argmax(-1).to(torch.int32).cpu())))
        return logits

    out, caches = {}, {}
    with torch.inference_mode():
        for name, (rn, params) in runs.items():
            a2a_run = rn.replace(moe_impl="a2a")
            decoders[name] = make_decode_step(cfg, a2a_run, a2a_ctx)
            tok, _, logits = make_prefill_step(cfg, a2a_run, a2a_ctx)(
                params, {"tokens": tokens}, logits=True)
            out["a2a_" + name] = held_greedy(tok, logits)
            dropped[name] = []
            moe_a2a.moe_a2a_apply = plain_a2a_moe(
                a2a_ctx.mesh.devices.size, dropped[name])
            try:
                out["plain_" + name], _ = lm.prefill_fn(
                    cfg, a2a_run, a2a_ctx, params, {"tokens": tokens})
            finally:
                moe_a2a.moe_a2a_apply = real_a2a
            assert len(dropped[name]) == cfg.num_layers, dropped
            out["dense_" + name], caches[name] = lm.prefill_fn(
                cfg, rn, null, params, {"tokens": tokens})
            caches[name] = serve.pad_cache(cfg, caches[name], steps)
        rows = [_held_row(out, "a2a", "plain")]
        tok = out["dense_f32"].argmax(-1).to(torch.int32)  # both dtypes'
        for i in range(steps):
            batch = {"tokens": tok[:, None], "pos": prompt + i}
            for name, (rn, params) in runs.items():
                tok, _, logits = decoders[name](params, caches[name], batch,
                                                logits=True)
                out["a2a_" + name] = held_greedy(tok, logits)
                out["dense_" + name], caches[name] = lm.decode_fn(
                    cfg, rn, null, params, caches[name], batch)
            tok = out["dense_f32"].argmax(-1).to(torch.int32)
            rows.append(_held_row(out, "a2a", "dense"))
    del prm32, caches, out
    torch.cuda.empty_cache()
    for r in rows:
        assert r["f32_err"] <= r["f32_bound"], rows
        assert r["bf16_vs_f32_err"] <= 2 * r["plain_bf16_vs_f32_err"], rows
        assert r["bf16_err"] <= r["bf16_bound"] or \
            not r["bf16_bound_applies"], rows
    assert all(greedy), greedy
    return {"greedy_equal_to_argmax": greedy,
            "prefill_against_plain_a2a": rows[0],
            "prefill_assignments_dropped_per_layer": dropped,
            "decode_steps_against_dense": rows[1:],
            "tolerance": {"f32": "2e-2 x max(1, max|plain|)",
                          "bf16": "2 x max|plain bf16 - plain f32|, against "
                                  "plain f32; FLASH_TOL bf16 at the scale "
                                  "where it applies"}}


def _held_row(out, got: str, plain: str) -> dict:
    """One a2a_logits_against_plain comparison of ``got`` with ``plain``."""
    f32_err, f32_scale = _logits_err(out[got + "_f32"], out[plain + "_f32"])
    bf16_err, bf16_scale = _logits_err(out[got + "_bf16"],
                                       out[plain + "_bf16"])
    plain_vs_f32, _ = _logits_err(out[plain + "_bf16"], out[plain + "_f32"])
    tol = FLASH_TOL["bfloat16"]
    bound = tol + tol * bf16_scale
    return {"f32_err": f32_err, "f32_bound": 2e-2 * f32_scale,
            "bf16_err": bf16_err, "bf16_bound": bound,
            "bf16_bound_applies": plain_vs_f32 <= bound,
            "bf16_vs_f32_err": _logits_err(out[got + "_bf16"],
                                           out[plain + "_f32"])[0],
            "plain_bf16_vs_f32_err": plain_vs_f32}


def phase_serve_olmoe_a2a(prm, tokens):
    """olmoe-1b-7b, on serve_olmoe's bf16 weights, served with
    ``moe_impl="a2a"`` on a virtual (data, model) = (1, 4) mesh of the
    card (16 experts a cell) through serve/step's prefill and decode
    steps, partitioned over the mesh (each cell its 4 of the 16 heads):
    every kernel count set to 0 just before the prefill and 4
    decode steps and read just after (flash: 16 a cell's prefill, at the
    cell's (q, k) shapes, 0 a decode step), each timed on the host clock
    warm, beside the dense dispatch's (``ShardingCtx.null()``) on the
    same card; the greedy ids beside the dense dispatch's are reported,
    not held (bf16 near ties and the a2a's dropped assignments move
    them). Then layer 0's MoE layer,
    on the normed embeddings of the prompt with an f32 copy of its
    weights, through ``impl="a2a"`` on the mesh and ``impl="dense"``:
    the reference's 2e-2 on y at every token neither path drops (the
    dense path's capacity of a 4096-token group, 640, is not reached
    here; the a2a path's, 160 a rank's 1024 tokens, may be: those tokens
    are counted), and 1e-3 on aux. Then the partitioned steps' logits of
    the prefill and of each decode step from the same cache
    (``a2a_logits_against_plain``), and last the f32 hold of the
    partitioned serve on this mesh against the a2a serve unpartitioned at
    SERVE_MESH_F32's depth (``mesh_serve_f32_hold``)."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.models import moe, params as P
    from repro_torch.models.common import embed_tokens, rms_norm
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    kernels = _kernel_counts()
    bundle = registry.get(SERVE_OLMOE["arch"])
    cfg = bundle.model
    dev = torch.device("cuda")
    d, m = A2A["mesh"]
    mesh = make_elastic_mesh(d, m, devices=[dev] * (d * m))
    a2a_ctx = ShardingCtx.for_mesh(mesh)
    runs = {"a2a": (bundle.run.replace(moe_impl="a2a"), a2a_ctx),
            "dense": (bundle.run, ShardingCtx.null())}
    B, prompt = tokens.shape
    L, steps = cfg.num_layers, A2A["decode_steps"]

    FA = kernels["flash_attention"]

    def serve_once(run, ctx):
        """Greedy ids, prefill s, decode s a step, flash launches of the
        prefill and of the decode steps."""
        prefill = make_prefill_step(cfg, run, ctx)
        decode = make_decode_step(cfg, run, ctx)
        torch.cuda.synchronize()
        l0, t0 = FA.launches(), time.perf_counter()
        tok, cache = prefill(prm, {"tokens": tokens})
        ids = [tok.cpu()]
        prefill_s, l1 = time.perf_counter() - t0, FA.launches()
        cache = serve.pad_cache(cfg, cache, steps)
        t0 = time.perf_counter()
        for i in range(steps):
            tok, cache = decode(prm, cache, {"tokens": tok[:, None],
                                             "pos": prompt + i})
            ids.append(tok.cpu())
        decode_s = (time.perf_counter() - t0) / steps
        return (torch.stack(ids, dim=1), prefill_s, decode_s,
                (l1 - l0, FA.launches() - l1))

    serve_once(*runs["a2a"])  # warm
    for mod in kernels.values():
        mod.reset_launches()
    with FlashShapes() as flash:
        ids_a2a, prefill_s, decode_s, launches = serve_once(*runs["a2a"])
    main_launches = {k: mod.launches() for k, mod in kernels.items()}
    cells = d * m
    assert main_launches == {"blockhash": 0, "wkv6": 0, "ssd": 0,
                             "flash_attention": cells * L}, main_launches
    assert launches == (cells * L, 0), launches
    assert set(flash.pairs) == {A2A["cell_flash"]}, set(flash.pairs)
    assert ids_a2a.shape == (B, steps + 1)
    assert ((0 <= ids_a2a) & (ids_a2a < cfg.vocab_size)).all()
    ids_dense, dense_prefill_s, dense_decode_s, _ = serve_once(
        *runs["dense"])

    # layer 0's MoE layer, f32, a2a against dense
    w0 = P.tree_map(lambda t: t.float(), P.layer(
        prm["stack"]["layers"], 0)["moe"])
    with torch.no_grad():
        x = rms_norm(embed_tokens(prm["embed"], tokens, ShardingCtx.null(),
                                  torch.float32),
                     P.layer(prm["stack"]["layers"], 0)["ln2"].float(),
                     cfg.norm_eps)
        y_a2a, aux_a2a = moe.moe_apply(cfg, a2a_ctx, w0, x, impl="a2a")
        y_dense, aux_dense = moe.moe_apply(cfg, ShardingCtx.null(), w0, x)
        err = (y_a2a - y_dense).abs().amax(dim=-1).reshape(-1).cpu()
        dropped = a2a_dropped_tokens(cfg, w0["router"],
                                     x.reshape(-1, cfg.d_model), d * m)
    kept_err = err[~dropped].max().item()
    n_dropped = int(dropped.sum())
    aux_err = abs(aux_a2a.item() - aux_dense.item())
    assert kept_err <= 2e-2 and aux_err <= 1e-3, (kept_err, aux_err)
    assert n_dropped <= 0.01 * err.shape[0], n_dropped
    del w0, x, y_a2a, y_dense
    logits = a2a_logits_against_plain(cfg, bundle.run, a2a_ctx, prm, tokens,
                                      steps)
    cut = dataclasses.replace(cfg, num_layers=SERVE_MESH_F32["layers"])
    hold = mesh_serve_f32_hold(cut, bundle.run, mesh, cut_layers(prm, cut),
                               tokens, "a2a", SERVE_MESH_F32["steps"])
    assert hold["held"], hold
    emit("serve_olmoe_a2a", arch=cfg.name, mesh=list(A2A["mesh"]),
         device="virtual", experts_per_cell=cfg.num_experts // (d * m),
         batch=B, prompt=prompt, decode_steps=steps,
         prefill_ms=prefill_s * 1e3, decode_ms_per_token=decode_s * 1e3,
         dense_prefill_ms=dense_prefill_s * 1e3,
         dense_decode_ms_per_token=dense_decode_s * 1e3,
         main_path_launches=main_launches,
         flash_launches_per_prefill=launches[0],
         flash_launches_in_decode_steps=launches[1],
         flash_cell_shapes=[list(q) for q in A2A["cell_flash"]],
         greedy_ids_equal_to_dense=float(
             (ids_a2a == ids_dense).float().mean()),
         layer0_y_max_abs_err_kept_tokens=kept_err,
         layer0_y_max_abs_err_all_tokens=err.max().item(),
         layer0_tokens_dropped_by_a2a=n_dropped,
         layer0_aux_a2a=aux_a2a.item(), layer0_aux_dense=aux_dense.item(),
         layer0_aux_abs_err=aux_err,
         tolerance="y 2e-2 at every kept token, aux 1e-3 (f32)",
         logits=logits, f32_hold=hold)
    return main_launches["flash_attention"]


# The serve programs partitioned over a virtual (2, 2) ("data", "model")
# mesh of the card (serve.step), on a serve phase's own bf16 weights and
# prompt (and stub embeddings), right after it: smollm-135m (its 9 heads
# over 3 kv heads do not split over 2: each cell runs all of them on its 2
# rows, and keeps its sequence block of the cache), olmoe-1b-7b (each cell
# its 8 of the 16 heads, 32 of the 64 experts, half the vocabulary),
# llama-3.2-vision-11b (16 of the 32 q heads over 4 of the 8 kv heads in
# its self and cross layers, its image KV's 4 kv heads, half the
# vocabulary) and whisper-small (6 of the 12 heads in its encoder, decoder
# and cross attention, its cross KV's 6 heads; its 51865-row vocabulary
# splits over no axis: each cell looks up and computes all the logits),
# rwkv6-7b (each cell's time mix on 32 of the 64 WKV heads, from and into
# its shard of the WKV state, its channel mix on half the columns, half
# the vocabulary; the token shifts whole) and zamba2-7b (each cell's
# Mamba2 blocks on 56 of the 112 SSD heads, its even block of 3648 of the
# conv state's 7296 channels, its shared block on 16 of the 32 heads and
# its shard of that block's KV cache, half the vocabulary), all whole,
# batch 4, their serve phase's prompt and greedy tokens through
# launch/serve.generate: 8, not the serve phases' 32 (SERVE_MESH_CUT: a
# partitioned decode step on a virtual mesh costs 0.6-1.0 s of the host's
# time, its 4 cells taking turns, and the smoke keeps to its time limit).
# Each phase's ``cell_launches``: for each model kernel, each of its
# shapes in a cell's prefill (flash: (q, k); WKV6: r's; SSD: x's) and how
# many launches each cell makes at it; ``impls``: the MoE dispatches of
# its f32 hold, the decision (each partitioned serve against the same
# depth unpartitioned, at ``f32_layers`` deep, default SERVE_MESH_F32's;
# None: whole); ``f32_err``: the serve phase's field of its bf16 logits'
# distance from its f32 logits (SERVE_F32_LOGITS); ``trace``: the phase
# whose line holds the unpartitioned serve's profile, where it is not the
# serve phase's own ``trace``; ``rules``: the serve's ruleset, baseline
# where unset. Under ``decode_flash`` (serve_mesh_flash_smollm and
# serve_mesh_flash_olmoe, right after serve_mesh_smollm and
# serve_mesh_olmoe, on the same weights and prompt): a decode step 2-D
# tensor parallel on each cell's weight shards, no weight gathered (held:
# 0 of a step's collectives a weight's gather), the residual stream's
# features over data, every kv head and the cell's rows and sequence
# block in its attention; the prefill on the cell's 2 rows, its weights
# gathered over data a layer at a time, its attention on its own q heads
# and the kv heads they read (olmoe's 8 of 16), on all of them where the
# q heads do not split (smollm's 9); ``baseline``: the phase of the same
# model under the baseline rules, whose figures its line repeats beside
# its own.
SERVE_MESH = {
    "serve_mesh_smollm": {"serve": "serve_smollm", "arch": "smollm-135m",
                          "impls": ("dense",),
                          "cell_launches": {"flash_attention": {
                              ((2, 1024, 9, 64), (2, 1024, 3, 64)): 30}}},
    "serve_mesh_olmoe": {"serve": "serve_olmoe", "arch": "olmoe-1b-7b",
                         "impls": ("dense", "a2a"),
                         "cell_launches": {"flash_attention": {
                             ((2, 1024, 8, 128), (2, 1024, 8, 128)): 16}}},
    "serve_mesh_flash_smollm": {
        "serve": "serve_smollm", "arch": "smollm-135m", "impls": ("dense",),
        "rules": "decode_flash", "baseline": "serve_mesh_smollm",
        "cell_launches": {"flash_attention": {
            ((2, 1024, 9, 64), (2, 1024, 3, 64)): 30}}},
    "serve_mesh_flash_olmoe": {
        "serve": "serve_olmoe", "arch": "olmoe-1b-7b", "impls": ("dense",),
        "rules": "decode_flash", "baseline": "serve_mesh_olmoe",
        "cell_launches": {"flash_attention": {
            ((2, 1024, 8, 128), (2, 1024, 8, 128)): 16}}},
    # one super-block: 4 self layers and a cross layer (``_vlm_groups``
    # takes no fewer)
    "serve_mesh_vlm": {"serve": "serve_vlm", "arch": "llama-3.2-vision-11b",
                       "impls": ("dense",), "f32_layers": 5,
                       "cell_launches": {"flash_attention": {
                           ((2, 1024, 16, 128), (2, 1024, 4, 128)): 32,
                           ((2, 1024, 16, 128), (2, 6404, 4, 128)): 8}}},
    "serve_mesh_whisper": {"serve": "serve_whisper", "arch": "whisper-small",
                           "impls": ("dense",), "f32_layers": None,
                           "cell_launches": {"flash_attention": {
                               ((2, 1500, 6, 64), (2, 1500, 6, 64)): 12,
                               ((2, 384, 6, 64), (2, 384, 6, 64)): 12,
                               ((2, 384, 6, 64), (2, 1500, 6, 64)): 12}}},
    "serve_mesh_rwkv6": {"serve": "serve_rwkv6", "arch": "rwkv6-7b",
                         "impls": ("dense",), "trace": "serve_trace",
                         "f32_err": "logits_bf16_vs_f32_err",
                         "cell_launches": {"wkv6": {
                             (2, 1024, 32, 64): 32}}},
    # 6 layers: the fewest that hold an application of the shared block
    # (after layer 5)
    "serve_mesh_zamba2": {"serve": "serve_zamba2", "arch": "zamba2-7b",
                          "impls": ("dense",), "f32_layers": 6,
                          "f32_err": "logits_bf16_vs_f32_err",
                          "cell_launches": {
                              "ssd": {(2, 1024, 56, 64): 81},
                              "flash_attention": {
                                  ((2, 1024, 16, 112),
                                   (2, 1024, 16, 112)): 13}}},
}
SERVE_MESH_SHAPE = (2, 2)  # (data, model)
SERVE_MESH_GEN = 8
SERVE_MESH_CUT = "gen 32 -> 8 (the smoke's seconds)"
SERVE_MESH_F32 = {"layers": 2, "steps": 3}
# the decode steps of the profile (the serve phases profile 8; a
# partitioned step's host cost is several times theirs)
SERVE_MESH_PROFILED_STEPS = 2
SERVE_F32_LOGITS = {}  # a serve phase's f32 plain prefill logits, on the host
SERVE_MESH_TOL = 1e-4  # x max(1, max|unpartitioned|): f32 logits and cache


def cache_shard_gap(got, want) -> dict:
    """A cell's bf16 cache shard against the unpartitioned cache's block
    at the same index, both the rounding of an f32 value: each element
    within SERVE_MESH_TOL x max(1, max|want|) plus one bf16 ulp of its
    magnitude (a pair that straddles a rounding boundary), and such
    flips rare (under 1 % of the elements), as the CPU tests hold it."""
    import torch

    got, want = got.float(), want.float()
    diff = (got - want).abs()
    mag = torch.maximum(got.abs(), want.abs()).clamp(min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    bound = SERVE_MESH_TOL * max(1.0, want.abs().max().item()) + ulp
    return {"excess": (diff - bound).max().item(),
            "differ_share": (diff > 0).float().mean().item()}


def cut_layers(prm, cfg):
    """A model's weights ``prm`` cut to ``cfg.num_layers`` layers, the
    VLM's to its first ``cfg.num_layers // cross_attn_every``
    super-blocks (views of the first ones); zamba2's shared block, which
    no layer axis stacks, whole."""
    from repro_torch.models import params as P

    stack = prm["stack"]
    n = (cfg.num_layers // cfg.cross_attn_every if cfg.family == "vlm"
         else cfg.num_layers)
    return {**prm, "stack": {k: v if k == "shared" else
                             P.tree_map(lambda t: t[:n], v)
                             for k, v in stack.items()}}


def mesh_serve_f32_hold(cfg, run, mesh, prm, tokens, impl: str, steps: int,
                        extra=None) -> dict:
    """The partitioned serve (``serve.step`` over ``mesh``) against the
    same model unpartitioned (``lm.prefill_fn``/``decode_fn``: with no
    mesh for the dense dispatch, the a2a's own shard_map on ``mesh`` for
    ``impl="a2a"``), in f32 compute on an f32 copy of ``prm``: the prefill
    and ``steps`` decode steps, each decode step from the unpartitioned
    cache laid out as the partitioned one's (a bf16 rounding flip in a
    cache moves the next logits past the tolerance) and fed the
    unpartitioned greedy tokens; ``extra``: the prefill's embeddings;
    the partitioned serve under ``run.sharding_rules`` (the a2a's under
    ``moe_a2a``), whose decode_flash cache takes as many more slots as
    keep its length a multiple of ``model``. Held: the logits within SERVE_MESH_TOL x max(1, max|unpartitioned|),
    every cell's shard of every bf16 cache leaf (the KV cache, the cross
    KV, the conv state) against the unpartitioned cache's block
    (``cache_shard_gap``), of every f32 leaf (the WKV and SSD states, an
    f32 run's token shifts) within SERVE_MESH_TOL x max(1, max|block|)
    with no rounding term, the greedy ids equal."""
    import torch

    from repro_torch.distributed.sharding import ShardingCtx, place
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import mesh_axis_sizes
    from repro_torch.models import lm, params as P
    from repro_torch.serve.step import (laid_out, make_decode_step,
                                        make_prefill_step)

    run32 = run.replace(compute_dtype="float32", moe_impl=impl)
    ruleset = "moe_a2a" if impl == "a2a" else run.sharding_rules
    ctx = ShardingCtx.for_mesh(mesh, ruleset)
    whole_ctx = ctx if impl == "a2a" else ShardingCtx.null()
    prm32 = P.tree_map(lambda t: t.float(), prm)
    mprm = laid_out(cfg, ctx, prm32)
    prefill = make_prefill_step(cfg, run32, ctx)
    decode = make_decode_step(cfg, run32, ctx)
    B, prompt = tokens.shape
    pad = steps
    if ruleset == "decode_flash":  # the slots split over model
        m = mesh_axis_sizes(mesh)["model"]
        pad = -(-(prompt + steps) // m) * m - prompt
    rows, worst = [], {"logits": 0.0, "cache_excess": -1.0,
                       "cache_differ_share": 0.0, "state": 0.0}

    def state_gap(shard, want):  # an f32 leaf's, relative
        return ((shard.float() - want.float()).abs().max()
                / max(1.0, want.abs().max().item())).item()

    def held(name, tok, cache, logits, want_logits, want_cache):
        err = (logits.float() - want_logits.float()).abs().max().item()
        scale = max(1.0, want_logits.abs().max().item())
        shards = [(shard, want[index]) for got, want in zip(
            P.leaves(cache), P.leaves(want_cache))
            for _pos, index, shard in got.addressable_shards]
        gaps = [cache_shard_gap(g, w) for g, w in shards
                if g.dtype == torch.bfloat16] or [
            {"excess": -1.0, "differ_share": 0.0}]
        row = {"at": name, "logits_err": err, "logits_scale": scale,
               "cache_excess": max(g["excess"] for g in gaps),
               "cache_differ_share": max(g["differ_share"] for g in gaps),
               "state_rel_err": max([state_gap(g, w) for g, w in shards
                                     if g.dtype != torch.bfloat16] or [0.0]),
               "ids_equal": bool(torch.equal(
                   tok.cpu(), want_logits.argmax(-1).to(torch.int32).cpu()))}
        worst["logits"] = max(worst["logits"], err / scale)
        worst["cache_excess"] = max(worst["cache_excess"],
                                    row["cache_excess"])
        worst["cache_differ_share"] = max(worst["cache_differ_share"],
                                          row["cache_differ_share"])
        worst["state"] = max(worst["state"], row["state_rel_err"])
        rows.append(row)

    batch = {"tokens": tokens, **(extra or {})}
    with torch.inference_mode():
        want_logits, want_cache = lm.prefill_fn(cfg, run32, whole_ctx, prm32,
                                                batch)
        tok, cache, logits = prefill(mprm, batch, logits=True)
        held("prefill", tok, cache, logits, want_logits, want_cache)
        want_cache = serve.pad_cache(cfg, want_cache, pad)
        cache = serve.pad_cache(cfg, cache, pad, ctx)
        for i in range(steps):
            batch = {"tokens": want_logits.argmax(-1).to(torch.int32)[:, None],
                     "pos": prompt + i}
            fed = P.tree_map(lambda w, t: place(w, t.sharding), want_cache,
                             cache)
            tok, cache, logits = decode(mprm, fed, batch, logits=True)
            want_logits, want_cache = lm.decode_fn(cfg, run32, whole_ctx,
                                                   prm32, want_cache, batch)
            held(f"decode{i}", tok, cache, logits, want_logits, want_cache)
    del prm32, mprm, cache, fed, want_cache
    torch.cuda.empty_cache()
    ok = (worst["logits"] <= SERVE_MESH_TOL and worst["cache_excess"] <= 0
          and worst["cache_differ_share"] <= 1e-2
          and worst["state"] <= SERVE_MESH_TOL
          and all(r["ids_equal"] for r in rows))
    return {"impl": impl, "ruleset": ruleset, "layers": cfg.num_layers,
            "decode_steps": steps, "held": ok, "worst": worst, "rows": rows}


def phase_serve_mesh(name, prm, tokens, extra=None):
    """A model served partitioned over a virtual (2, 2) mesh of the card
    (SERVE_MESH[name]), on its serve phase's bf16 weights, prompt and
    stub embeddings (``extra``: the VLM's image, whisper's frame
    embeddings), whole: each cell holding its FSDP x model shard of every
    weight leaf and its shard of every cache leaf (the KV cache, the
    cross KV, the recurrent states; MeshArrays; each cell's bytes at rest
    held equal to the dry-run's argument bytes of the prefill and decode
    programs), computing on its own heads, columns, experts and
    vocabulary. The main path, through launch/serve.generate with every
    kernel count set to 0 just before and read just after: each model
    kernel in each cell's prefill exactly as often as ``cell_launches``
    says at each of the cell's shapes, never in a decode step. Then a
    warm prefill (its logits held by the serve phase's rule: no further
    from the serve phase's f32 logits than twice the unpartitioned bf16
    logits are) and a profiled prefill and 2 decode steps (the device's
    idle share), each beside the serve phase's unpartitioned figures;
    last the f32 hold at ``f32_layers`` deep (``mesh_serve_f32_hold``),
    the decision. A decode step's collectives a cell and among them the
    weights' gathers (``spmd.observe``: those labelled with a leaf's
    path) are counted; under ``decode_flash`` none may be a weight's.
    Returns the main path's launches by kernel."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import MeshArray, ShardingCtx
    from repro_torch.launch import dryrun, serve
    from repro_torch.launch.mesh import make_elastic_mesh, make_mesh
    from repro_torch.launch.programs import build_program
    from repro_torch.models import params as P
    from repro_torch.serve.step import (laid_out, make_decode_step,
                                        make_prefill_step)

    spec = SERVE_MESH[name]
    unpart = EMITTED[spec["serve"]]
    kernels = _kernel_counts()
    bundle = registry.get(spec["arch"])
    rules = spec.get("rules", "baseline")
    cfg, run = bundle.model, bundle.run.replace(sharding_rules=rules)
    dev = torch.device("cuda")
    d, m = SERVE_MESH_SHAPE
    cells = d * m
    mesh = make_elastic_mesh(d, m, devices=[dev] * cells)
    ctx = ShardingCtx.for_mesh(mesh, rules)
    B, prompt = tokens.shape
    extra = extra or {}
    batch = {"tokens": tokens, **extra}
    gen, L = SERVE_MESH_GEN, cfg.num_layers
    # each kernel's launches a prefill: every cell's at each of its shapes
    cell_launches = spec["cell_launches"]
    launches = {k: cells * sum(cell_launches.get(k, {}).values())
                for k in kernels}
    base = torch.cuda.memory_allocated()

    mprm = laid_out(cfg, ctx, prm)
    assert all(isinstance(t, MeshArray) for t in P.leaves(mprm))
    param_bytes = [sum(t.shards[p].numel() * t.shards[p].element_size()
                       for t in P.leaves(mprm)) for p in range(cells)]
    meta = make_mesh((d, m), ("data", "model"), [torch.device("meta")] * cells)
    mctx = ShardingCtx.for_mesh(meta, rules)

    def dry_bytes(kind, seq, n_args):
        prog = build_program(cfg, run, ShapeSpec(name, kind, seq, B), mctx)
        return dryrun.argument_bytes(dataclasses.replace(
            prog, args=prog.args[:n_args],
            arg_shardings=prog.arg_shardings[:n_args]))

    dry_prefill = dry_bytes("prefill", prompt, 1)
    assert param_bytes == [dry_prefill] * cells, (param_bytes, dry_prefill)

    # the main path, every count set to 0 just before and read just after
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.reset_launches()
    with contextlib.ExitStack() as stack:
        seen = {k: stack.enter_context(LaunchShapes(kernels[k],
                                                    KERNEL_OPS[k]))
                for k in cell_launches}
        ids, times = serve.generate(cfg, run, mprm, batch, gen, ctx)
    main_launches = {k: mod.launches() for k, mod in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    assert main_launches == launches, (main_launches, launches)
    for k, shapes in seen.items():  # flash's by (q, k), the others' by r, x
        got = collections.Counter(shapes.pairs if k == "flash_attention"
                                  else shapes.shapes)
        assert got == {p: cells * n for p, n in cell_launches[k].items()}, \
            (k, got)
    assert ids.shape == (B, gen) and ((0 <= ids) & (ids < cfg.vocab_size)).all()

    # one prefill alone, then each decode step alone: its launches, and
    # the cache at rest in each cell against the dry-run's decode program
    prefill = make_prefill_step(cfg, run, ctx)
    decode = make_decode_step(cfg, run, ctx)
    def counts():
        return {k: mod.launches() for k, mod in kernels.items()}

    torch.cuda.synchronize()
    l0, t0 = counts(), time.perf_counter()
    tok, cache, logits = prefill(mprm, batch, logits=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = {k: n - l0[k] for k, n in counts().items()}
    assert prefill_launches == launches, prefill_launches
    assert (tok.cpu().numpy() == ids[:, 0]).all()
    cache = serve.pad_cache(cfg, cache, gen, ctx)
    assert all(isinstance(t, MeshArray) for t in P.leaves(cache))
    cache_bytes = [sum(t.shards[p].numel() * t.shards[p].element_size()
                       for t in P.leaves(cache)) for p in range(cells)]
    dry_decode = dry_bytes("decode", prompt + gen, 2)
    cell_bytes = [a + b for a, b in zip(param_bytes, cache_bytes)]
    assert cell_bytes == [dry_decode] * cells, (cell_bytes, dry_decode)
    step_launches, collectives = [], []

    def note(op, out, group, cell, *, axes, label):
        if cell == 0:  # every cell issues the same ones
            collectives.append((op, ",".join(axes), label))

    for i in range(2):
        l0 = counts()
        with spmd.observe(note) if i == 0 else contextlib.nullcontext():
            tok, cache = decode(mprm, cache, {"tokens": tok[:, None],
                                              "pos": prompt + i})
        step_launches.append(sum(n - l0[k] for k, n in counts().items()))
        assert (tok.cpu().numpy() == ids[:, i + 1]).all()
    assert step_launches == [0, 0], step_launches
    del cache
    # a weight's gather is labelled with its leaf's path (zamba2's conv
    # state, a cache leaf, with "conv")
    weight_gathers = sum(label not in (None, "conv")
                         for _, _, label in collectives)
    if rules == "decode_flash":
        assert weight_gathers == 0, collectives
    decode_collectives = dict(collections.Counter(
        f"{op} over {axes}" for op, axes, _ in collectives))

    # the bf16 logits, by the serve phase's rule
    f32 = SERVE_F32_LOGITS[spec["serve"]].to(dev)
    mesh_vs_f32 = (logits.float() - f32.float()).abs().max().item()
    whole_vs_f32 = unpart[spec.get("f32_err",
                                   "logits_bf16_kernel_vs_f32_err")]
    assert mesh_vs_f32 <= 2 * whole_vs_f32, (mesh_vs_f32, whole_vs_f32)
    del f32, logits

    trace = serve_profile(cfg, run, mprm, tokens, ctx=ctx, extra=extra,
                          decode_steps=SERVE_MESH_PROFILED_STEPS)
    profiled = f"decode_{SERVE_MESH_PROFILED_STEPS}_steps"
    for k, kind in (("flash_attention", "flash"), ("ssd", "ssd"),
                    ("wkv6", "wkv6")):
        assert 0 < trace["prefill"][f"{kind}_launches"] <= launches[k] \
            or launches[k] == trace["prefill"][f"{kind}_launches"] == 0, k
        assert trace[profiled][f"{kind}_launches"] == 0, k

    # the decision: f32 at f32_layers deep, against the same depth whole
    f32_layers = spec.get("f32_layers", SERVE_MESH_F32["layers"])
    cut = (cfg if f32_layers is None
           else dataclasses.replace(cfg, num_layers=f32_layers))
    cut_prm = prm if f32_layers is None else cut_layers(prm, cut)
    del mprm
    torch.cuda.empty_cache()
    holds = [mesh_serve_f32_hold(cut, run, mesh, cut_prm, tokens, impl,
                                 SERVE_MESH_F32["steps"], extra)
             for impl in spec["impls"]]
    for h in holds:
        assert h["held"], h
    ids_equal = float((ids[0] == np.asarray(
        unpart["generated_ids_row0"][:gen])).mean())
    whole_trace = (EMITTED[spec["trace"]] if "trace" in spec
                   else unpart["trace"])
    baseline = EMITTED.get(spec.get("baseline"), {})
    emit(name, arch=cfg.name, mesh=[d, m], device="virtual", layers=L,
         rules=rules, dtype=run.compute_dtype, batch=B, prompt=prompt,
         gen=gen,
         cut=SERVE_MESH_CUT, plan_repeated=make_prefill_step(
             cfg, run, ctx).plan_at({"tokens": tokens}).repeated(cfg),
         main_path_launches=main_launches,
         launches_per_prefill=prefill_launches,
         launches_per_decode_step=max(step_launches),
         cell_shapes={k: [{"shape": [list(t) for t in p] if k ==
                           "flash_attention" else list(p), "launches": n}
                          for p, n in v.items()]
                      for k, v in cell_launches.items()},
         cell_param_bytes=param_bytes, cell_cache_bytes=cache_bytes,
         dryrun_argument_bytes={"prefill": dry_prefill,
                                "decode": dry_decode},
         prefill_ms=prefill_s * 1e3,
         prefill_cold_ms=times["prefill_s"] * 1e3,
         decode_ms_per_token=times["decode_s_per_token"] * 1e3,
         peak_memory_bytes=peak, base_memory_bytes=base,
         unpartitioned={"prefill_ms": unpart["prefill_ms"],
                        "decode_ms_per_token": unpart["decode_ms_per_token"],
                        "peak_memory_bytes": unpart["peak_memory_bytes"],
                        "base_memory_bytes": unpart["base_memory_bytes"],
                        "prefill_idle_share":
                            whole_trace["prefill"]["device_idle_share"],
                        "decode_idle_share":
                            whole_trace["decode_8_steps"]["device_idle_share"]},
         prefill_idle_share=trace["prefill"]["device_idle_share"],
         decode_idle_share=trace[profiled]["device_idle_share"],
         decode_step_collectives=len(collectives),
         decode_step_collectives_by_axes=decode_collectives,
         decode_step_weight_gathers=weight_gathers,
         baseline_mesh=baseline and {
             "phase": spec["baseline"],
             **{k: baseline[k] for k in (
                 "prefill_ms", "decode_ms_per_token", "peak_memory_bytes",
                 "base_memory_bytes", "prefill_idle_share",
                 "decode_idle_share", "decode_step_collectives",
                 "decode_step_weight_gathers", "cell_param_bytes",
                 "cell_cache_bytes")}},
         logits_bf16_mesh_vs_f32_err=mesh_vs_f32,
         logits_bf16_whole_vs_f32_err=whole_vs_f32,
         logits_bf16_rule="mesh vs f32 plain <= 2 x whole bf16 vs f32 plain",
         generated_ids_row0=ids[0].tolist(),
         ids_equal_to_unpartitioned_row0=ids_equal, f32_layers=cut.num_layers,
         f32_hold=holds, f32_tolerance=f"{SERVE_MESH_TOL} x max(1, "
         "max|unpartitioned|) logits and f32 state shards; bf16 cache "
         "shards the same, plus one bf16 ulp on under 1 % of the elements; "
         "ids equal", trace=trace)
    del cut_prm
    torch.cuda.empty_cache()
    return main_launches


def decode_flash_check(cfg, run, prm, extra=None) -> dict:
    """Decode steps under the ``decode_flash`` ruleset on a virtual (1, 4)
    mesh of the card, each against the baseline decode (``null()``
    context) from the same bf16 cache, at the model's full width: a
    prompt whose decode positions lie in the first of the 4 cache shards,
    so the 3 others are fully masked. Every self attention must go
    through flash_decode, never the dense decode. With an f32 copy of the
    weights the logits are held within 1e-4 x max(1, max|baseline|) (the
    CPU tests' bound); in bf16 they may lie no further from the f32
    baseline's than twice the bf16 baseline's own logits do (the bf16
    bound: flash_decode rounds its unnormalised partial and its scale to
    bf16 where the dense decode rounds p once). The negative control: the
    combine with the first shard's partial zeroed (its ``psum`` input
    multiplied by 0 there) must fail the f32 check with the f32 weights
    and the bf16 bound with the bf16 ones. Kept in
    DECODE_FLASH_RESULTS."""
    import torch

    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.models import attention as A, lm, params as P
    from repro_torch.ranges import count_calls

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    prompt, cache_len = DECODE_FLASH[cfg.name]
    d, m = DECODE_FLASH["mesh"]
    assert cache_len % m == 0 and prompt + DECODE_FLASH["steps"] <= \
        cache_len // m
    mesh = make_elastic_mesh(d, m, devices=[dev] * (d * m))
    flash_ctx = ShardingCtx.for_mesh(mesh, "decode_flash")
    null = ShardingCtx.null()
    run32 = run.replace(compute_dtype="float32")
    prm32 = P.tree_map(lambda t: t.float(), prm)
    runs = {"bf16": (run, prm), "f32": (run32, prm32)}
    g = torch.Generator(device=dev).manual_seed(1)
    B = 4
    tokens = torch.randint(0, cfg.vocab_size, (B, prompt), generator=g,
                           device=dev, dtype=torch.int32)
    with torch.inference_mode():
        _, cache = lm.prefill_fn(cfg, run, null, prm,
                                 {"tokens": tokens, **(extra or {})})
    cache = serve.pad_cache(cfg, cache, cache_len - prompt)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    real_psum = spmd.psum

    def zero_first_partial(x, axis_name):
        # the first psum of flash_decode's combine is the partial outputs
        # (float32, 4-d); the shard at index 0 holds every valid key
        if isinstance(x, torch.Tensor) and x.dim() == 4 and \
                spmd.axis_index(axis_name) == 0:
            x = x * 0
        return real_psum(x, axis_name)

    steps, rows = DECODE_FLASH["steps"], []
    with count_calls(A, ("flash_decode", "decode_attention")) as calls:
        for i in range(steps):
            t_step = time.perf_counter()
            batch = {"tokens": tokens[:, i:i + 1], "pos": prompt + i}
            out = {}
            with torch.inference_mode():
                for name, (rn, params) in runs.items():
                    calls.update(flash_decode=0, decode_attention=0)
                    out[name], new_cache = lm.decode_fn(cfg, rn, null, params,
                                                        cache, batch)
                    n_attn = calls["decode_attention"]
                    if name == "bf16":
                        next_cache = new_cache
                    calls.update(flash_decode=0, decode_attention=0)
                    out["flash_" + name], _ = lm.decode_fn(
                        cfg, rn.replace(sharding_rules="decode_flash"),
                        flash_ctx, params, cache, batch)
                    assert calls == {"flash_decode": n_attn,
                                     "decode_attention": 0}, (calls, n_attn)
                if i == 0:
                    spmd.psum = zero_first_partial
                    try:
                        bad = {name: lm.decode_fn(
                            cfg, rn.replace(sharding_rules="decode_flash"),
                            flash_ctx, params, cache, batch)[0]
                            for name, (rn, params) in runs.items()}
                    finally:
                        spmd.psum = real_psum
            scale = max(1.0, out["f32"].abs().max().item())
            row = {"f32_err": err(out["flash_f32"], out["f32"]),
                   "f32_bound": 1e-4 * scale,
                   "bf16_vs_f32_err": err(out["flash_bf16"], out["f32"]),
                   "bf16_baseline_vs_f32_err": err(out["bf16"], out["f32"]),
                   "bf16_vs_bf16_baseline_err": err(out["flash_bf16"],
                                                    out["bf16"])}
            row["bf16_bound"] = 2 * row["bf16_baseline_vs_f32_err"]
            if i == 0:
                row["zeroed_partial_f32_err"] = err(bad["f32"], out["f32"])
                row["zeroed_partial_bf16_vs_f32_err"] = err(bad["bf16"],
                                                            out["f32"])
            row["seconds"] = time.perf_counter() - t_step
            rows.append(row)
            cache = next_cache
    for r in rows:
        assert r["f32_err"] <= r["f32_bound"], rows
        assert r["bf16_vs_f32_err"] <= r["bf16_bound"], rows
    assert rows[0]["zeroed_partial_f32_err"] > rows[0]["f32_bound"], \
        ("the zeroed partial passed in f32", rows[0])
    assert rows[0]["zeroed_partial_bf16_vs_f32_err"] > rows[0]["bf16_bound"], \
        ("the zeroed partial passed in bf16", rows[0])
    DECODE_FLASH_RESULTS[cfg.name] = {
        "mesh": [d, m], "device": "virtual", "batch": B, "prompt": prompt,
        "cache_len": cache_len, "positions": [prompt, prompt + steps - 1],
        "shard_len": cache_len // m, "flash_decode_calls_per_step": n_attn,
        "steps": rows, "zeroed_partial_refused": True,
        "tolerance": {"f32": "1e-4 x max(1, max|baseline|)",
                      "bf16": "2 x max|bf16 baseline - f32 baseline|, "
                              "against the f32 baseline"},
        "seconds": time.perf_counter() - t_start}
    del cache, prm32
    torch.cuda.empty_cache()
    return DECODE_FLASH_RESULTS[cfg.name]


def phase_pipeline(t):
    """GPipe through ``distributed/pipeline.pipeline_apply`` on a virtual
    ("pod",) mesh of 3 cells of the card: train_smollm's f32 smollm-135m
    parameters, its 30 blocks cut into 3 stages of 10 at full width (d
    576), bf16 compute as its RunConfig has it, 6 microbatches of 2 x 2048
    of SyntheticLM's tokens, embedded. The flash count set to 0 just before the
    pipelined forward and backward and read just after: 3 stages x 8
    ticks x 10 blocks = 240 (counted on the CPU first; the backward
    recomputes through the plain version). The outputs and every gradient
    (each block leaf, and the inputs) against the sequential 30-block
    stack on the card, microbatch by microbatch: 1e-3 x max(1,
    max|sequential|) (GRAD_TOL)."""
    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.pipeline import bubble_fraction, pipeline_apply
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import params as P, transformer as T
    from repro_torch.models.common import compute_dtype, embed_tokens

    kernels = _kernel_counts()
    cfg, run = t.cfg, t.run
    ctx = ShardingCtx.null()
    dev = torch.device("cuda")
    S, M = PIPELINE["stages"], PIPELINE["microbatches"]
    mb, seq = PIPELINE["mb"], PIPELINE["seq"]
    L = cfg.num_layers
    per = L // S
    dt = compute_dtype(run)
    mesh = make_mesh((S,), ("pod",), [dev] * S)
    toks = torch.from_numpy(SyntheticLM(cfg, M * mb, seq, seed=0).batch(0)[
        "tokens"]).to(dev)
    with torch.no_grad():
        xs = embed_tokens(t.params["embed"], toks, ctx, dt).reshape(
            M, mb, seq, cfg.d_model)
    positions = torch.arange(seq, dtype=torch.int32, device=dev).expand(
        mb, seq)
    g = torch.Generator(device=dev).manual_seed(3)
    cot = torch.randn(xs.shape, generator=g, device=dev)

    def blocks(w, x, n):
        for i in range(n):
            x, _ = T.block_apply(cfg, run, ctx, P.layer(w, i), x, positions)
        return x

    def leaves():
        w = P.tree_map(lambda a: a.detach().clone().requires_grad_(),
                       t.params["stack"]["layers"])
        return w, xs.detach().clone().requires_grad_()

    def grads_of(out, w, x):
        (out.float() * cot).sum().backward()
        return [x.grad] + [a.grad for a in P.leaves(w)]

    # the sequential stack, microbatch by microbatch (first: it warms the
    # kernels both run)
    w, x = leaves()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = torch.stack([blocks(w, x[i], L) for i in range(M)])
    want_grads = grads_of(want, w, x)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    want = want.detach()
    del w, x

    # the pipeline: the main path
    w, x = leaves()
    stages = P.tree_map(lambda a: a.reshape(S, per, *a.shape[1:]), w)
    torch.cuda.synchronize()
    for mod in kernels.values():
        mod.reset_launches()
    t0 = time.perf_counter()
    out = pipeline_apply(lambda p, xx: blocks(p, xx, per), stages, x, mesh,
                         axis="pod")
    got_grads = grads_of(out, w, x)
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    main_launches = {k: mod.launches() for k, mod in kernels.items()}
    want_launches = S * (M + S - 1) * per
    assert main_launches == {"blockhash": 0, "wkv6": 0, "ssd": 0,
                             "flash_attention": want_launches}, main_launches
    out = out.detach()
    del w, x, stages

    scale = max(1.0, want.float().abs().max().item())
    out_err = (out.float() - want.float()).abs().max().item()
    grad_rel = [((a - b).abs().max() / max(1.0, b.abs().max().item())).item()
                for a, b in zip(got_grads, want_grads)]
    assert out.shape == want.shape and out_err <= GRAD_TOL * scale, (
        out_err, scale)
    assert max(grad_rel) <= GRAD_TOL, max(grad_rel)
    emit("pipeline", arch=cfg.name, stages=S, blocks_per_stage=per,
         microbatches=M, microbatch=[mb, seq], d_model=cfg.d_model,
         param_dtype=run.param_dtype, compute_dtype=run.compute_dtype,
         mesh=[S], device="virtual", ticks=M + S - 1,
         bubble_fraction=bubble_fraction(S, M),
         main_path_launches=main_launches,
         pipelined_forward_backward_ms=pipe_s * 1e3,
         sequential_forward_backward_ms=seq_s * 1e3,
         out_max_abs_err=out_err, out_scale=scale,
         grad_max_rel_err=max(grad_rel), grad_leaves=len(grad_rel),
         tolerance=f"{GRAD_TOL} x max(1, max|sequential|)")
    del out, want, got_grads, want_grads
    torch.cuda.empty_cache()
    return main_launches["flash_attention"]


def phase_compression(t):
    """Gradient compression on train_smollm's trainer: at each of 3
    training steps, the gradient tree of each of 4 data cells (a
    microbatch of 2 x 2048 of the step's batch each) through
    ``compress_tree_int8`` with its own error-feedback residual (int8
    codes; dequantised plus the new residual equal to the gradient plus
    the old one within 1e-6 x max(1, max|.|); each residual within half a
    quantisation step), the embedding leaf's codes and scale at step 0
    held exactly against the same function on the CPU; and the 4 cells'
    gradients through ``compressed_psum_int8`` inside ``shard_map`` on a
    virtual ("data",) mesh of 4 cells of the card, against the plain mean
    within one quantisation step of each leaf; then the trainer's next
    step."""
    import torch

    from repro_torch.distributed import compression as C
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm, params as P

    cfg, run = t.cfg, t.run
    ctx = ShardingCtx.null()
    dev = torch.device("cuda")
    n, steps = COMPRESSION["cells"], COMPRESSION["steps"]
    mesh = make_mesh((n,), ("data",), [dev] * n)
    batch = t.data.batch(0)
    mb = batch["tokens"].shape[0] // n
    cells = [{k: torch.from_numpy(v[c * mb:(c + 1) * mb]).to(dev)
              for k, v in batch.items()} for c in range(n)]
    residuals = [C.init_residuals(t.params) for _ in range(n)]
    psum = spmd.shard_map(
        lambda tree: P.tree_map(
            lambda a: C.compressed_psum_int8(a[0], "data"), tree),
        mesh, in_specs=(("data",),), out_specs=())

    def rel(a, b):
        return ((a - b).abs().max() / max(1.0, b.abs().max().item())).item()

    rows = []
    for _ in range(steps):
        grads = []
        for c in range(n):
            prm = P.tree_map(lambda p: p.detach().requires_grad_(), t.params)
            loss, _ = lm.loss_fn(cfg, run, ctx, prm, cells[c])
            loss.backward()
            grads.append(P.tree_map(lambda p: p.grad, prm))
        ef_err, res_over, compress_s = 0.0, -0.5, 0.0
        for c in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            qs, scales, new = C.compress_tree_int8(grads[c], residuals[c])
            torch.cuda.synchronize()
            compress_s += time.perf_counter() - t0
            deq = C.decompress_tree_int8(qs, scales)
            for q, d_, r_new, g_, r_old, sc in zip(*map(P.leaves, (
                    qs, deq, new, grads[c], residuals[c], scales))):
                assert q.dtype == torch.int8
                ef_err = max(ef_err, rel(d_ + r_new, g_.float() + r_old))
                res_over = max(res_over, (r_new.abs().max() / sc).item()
                               - 0.5)
            residuals[c] = new
        if not rows:  # the embedding leaf, against the CPU
            g0 = grads[0]["embed"]["embedding"].float()
            q_dev, s_dev = C.quantize_int8(g0)
            q_cpu, s_cpu = C.quantize_int8(g0.cpu())
            assert torch.equal(q_dev.cpu(), q_cpu) and \
                s_dev.item() == s_cpu.item()
        assert ef_err <= 1e-6 and res_over <= 1e-5, (ef_err, res_over)
        stacked = P.tree_map(lambda *gs: torch.stack(gs), *grads)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean_q = psum(stacked)
        torch.cuda.synchronize()
        psum_s = time.perf_counter() - t0
        steps_off = max(
            ((got - st.mean(0)).abs().max() / max(
                st.abs().max().item() / 127.0, 1e-30)).item()
            for got, st in zip(P.leaves(mean_q), P.leaves(stacked)))
        assert steps_off <= 1.0, steps_off
        rows.append({"step": t.step_idx, "ef_max_rel_err": ef_err,
                     "residual_over_half_step": res_over,
                     "compress_tree_ms_per_cell": compress_s / n * 1e3,
                     "compressed_psum_ms": psum_s * 1e3,
                     "psum_err_in_quantisation_steps": steps_off})
        del grads, stacked, mean_q
        t.train(t.step_idx + 1)
    emit("compression", arch=cfg.name, cells=n, mesh=[n], device="virtual",
         microbatch=[mb, batch["tokens"].shape[1]],
         leaves=len(list(P.leaves(t.params))),
         params=sum(p.numel() for p in P.leaves(t.params)), steps=rows,
         tolerance={"error_feedback": "1e-6 x max(1, max|.|)",
                    "residual": "half a quantisation step",
                    "compressed_psum": "one quantisation step"})
    del residuals
    torch.cuda.empty_cache()
    return rows


class LaunchShapes:
    """Within the block, the shape of the first argument of every launch
    of ``module.<name>`` (wrapped: looked up at each call), and the shapes
    of its first two (``pairs``)."""

    def __init__(self, module, name: str):
        self.mod, self.name = module, name

    def __enter__(self):
        self.orig, self.shapes, self.pairs = getattr(self.mod, self.name), \
            [], []

        def launch(a, b, *rest, **kw):
            self.shapes.append(tuple(a.shape))
            self.pairs.append((tuple(a.shape), tuple(b.shape)))
            return self.orig(a, b, *rest, **kw)

        setattr(self.mod, self.name, launch)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


def FlashShapes():
    """``LaunchShapes`` of the flash kernel: its q and (q, k) shapes."""
    from repro_torch.kernels.flash_attention import kernel as K

    return LaunchShapes(K, "flash_attention_fwd")


def state_copy(t, device=None) -> dict:
    """An unpartitioned trainer's parameters and first moments: copies of
    the leaves, in order, on ``device`` (default: where they are). The
    host's copies are pinned: the card writes and reads pinned memory
    several times faster than pageable memory, and the host allocator
    keeps the pinned blocks for the next copy (the VLM's 17.1 GB of f32
    parameters and first moments go to the host and back twice)."""
    import torch

    from repro_torch.models import params as P

    def copy(x):
        if device == "cpu":
            return torch.empty(x.shape, dtype=x.dtype,
                               pin_memory=True).copy_(x.detach())
        return x.detach().to(device or x.device, copy=True)

    return {k: [copy(x) for x in P.leaves(tree)]
            for k, tree in (("params", t.params), ("mu", t.opt_state.mu))}


def mesh_state_gaps(t, want) -> dict:
    """A partitioned trainer's gathered leaves against ``want``
    (``state_copy``'s): the largest gap of a parameter leaf's elements
    relative to max(1, max|want|) (``params``); of a first-moment leaf,
    the gap's norm relative to the leaf's (``mu``), and for information
    its largest element relative to max|want| (``mu_max``)."""
    from repro_torch.models import params as P

    gaps = {"params": 0.0, "mu": 0.0, "mu_max": 0.0}
    for got, w in zip(P.leaves(t.params), want["params"], strict=True):
        d = got.gather() - w.to(got.shards[0].device)
        gaps["params"] = max(gaps["params"], (d.abs().max() / max(
            1.0, w.abs().max().item())).item())
    for got, w in zip(P.leaves(t.opt_state.mu), want["mu"], strict=True):
        w = w.to(got.shards[0].device)
        d = got.gather() - w
        gaps["mu"] = max(gaps["mu"], (d.norm() / w.norm().clamp(
            min=1e-30)).item())
        gaps["mu_max"] = max(gaps["mu_max"], (d.abs().max() / w.abs().max(
            ).clamp(min=1e-30)).item())
    return gaps


def state_held(gaps) -> bool:
    return gaps["params"] <= MESH_PARAM_TOL and gaps["mu"] <= MESH_MOMENT_TOL


def mesh_f32_hold(cfg, run, mesh, gb: int, seq: int, n_steps: int, *,
                  ruleset: str = "baseline", plain=contextlib.nullcontext,
                  host: bool = False) -> dict:
    """The partitioned trainer's parameters and first moments after
    ``n_steps`` against the unpartitioned one's (run inside the context
    ``plain()``, its state copied on the card, or to the host with
    ``host``), both in f32 compute from one seed on one batch, the VLM's
    gates drawn as train_vlm draws them (``mesh_state_gaps``), and the
    largest relative gap of a loss."""
    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train.trainer import Trainer

    run32 = run.replace(compute_dtype="float32")
    dev = mesh.devices.flat[0]

    def trained(m, **kw):
        t = Trainer(cfg, run32, global_batch=gb, seq_len=seq, seed=0, mesh=m,
                    data=OneBatch(SyntheticLM(cfg, gb, seq, seed=0)),
                    device=dev, **kw)
        draw_gates(t.params, seed=0)
        t.train(n_steps)
        return t

    with plain():
        t = trained(None)
    want = state_copy(t, "cpu" if host else None)
    want_losses = [x["loss"] for x in t.metrics_log]
    del t
    gc.collect()  # the unpartitioned trainer holds reference cycles
    torch.cuda.empty_cache()
    t = trained(mesh, ruleset=ruleset)
    gaps = mesh_state_gaps(t, want)
    losses = [x["loss"] for x in t.metrics_log]
    del t, want
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "seq": seq, "steps": n_steps,
            "param_max_rel_err": gaps["params"],
            "moment_rel_err": gaps["mu"],
            "moment_max_rel_err": gaps["mu_max"],
            "loss_max_rel_err": max(abs(a - b) / max(1.0, abs(b))
                                    for a, b in zip(losses, want_losses)),
            "losses": losses, "plain_losses": want_losses}


def mesh_kernel_launches(cfg, run, mesh, global_batch: int,
                         kernel: str = "flash_attention") -> int:
    """Flash (rwkv6: WKV6) launches of one partitioned step: every cell
    runs each attention's (time mix's) forward and its recompute in each
    of its microbatches (tests/test_torch_mesh_train.py and
    test_torch_tensor_parallel.py count the same on the CPU): one a
    layer, whisper's 12 encoder layers and its decoder's self and cross
    attention; zamba2's SSD one a layer, its flash one an application of
    the shared block."""
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.models import mamba2
    from repro_torch.train.step import num_accum_steps

    n_accum = num_accum_steps(run, ShardingCtx.for_mesh(mesh), global_batch)
    if cfg.family == "audio":
        calls = cfg.encoder_layers + 2 * cfg.num_layers
    elif cfg.family == "hybrid" and kernel == "flash_attention":
        calls = mamba2.n_shared_applications(cfg)
    else:
        calls = cfg.num_layers
    return mesh.devices.size * n_accum * 2 * calls


def phase_train_mesh():
    """The trainer partitioned over a virtual (2, 2) mesh of the card
    (TRAIN_MESH): smollm-135m at full width and 10 of its 30 layers, every
    parameter and optimizer leaf a MeshArray whose four cells hold their FSDP x
    model shards, each step one shard_map whose cells gather their bf16
    parameters (the MLP's and the vocabulary's over the data axis only:
    each cell computes with its own half of them, tensor-parallel over
    ``model``; the attention whole, its 9 heads not splitting), run the
    model on their data cell's 4 rows through the flash kernel and
    reduce-scatter their gradients. Held: each cell's bytes at rest
    equal to the dry-run's argument bytes for the mesh (exact); the flash
    launches of each step (the CPU's count) and their shape; the losses
    step by step and the gathered parameters and first moments after the
    last one against the same steps unpartitioned from the same seed at
    the same depth, run just before it, its state kept on the card
    (MESH_LOSS_TOL, MESH_PARAM_TOL, MESH_MOMENT_TOL; both in f32
    compute where the bf16 step's gap exceeds a bound). The last warm-up step is profiled
    (the idle share). Then the elastic round through a bento mount at depth 2: saved
    at (2, 2), rescaled to (4, 1) and to (1, 1), restored onto each, the
    gathered state bit for bit the saved one, the blockhash launches
    equal to the checksum calls and bind probes. Over real cards where
    there are two; otherwise a line says it was not run."""
    import dataclasses

    import torch

    from repro_torch.checkpoint import store
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.sharding import MeshArray, ShardingCtx
    from repro_torch.fs.mounts import make_mount
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (make_elastic_mesh, make_host_mesh,
                                         make_mesh)
    from repro_torch.launch.programs import build_program
    from repro_torch.models import params as P
    from repro_torch.train.trainer import Trainer

    kernels = _kernel_counts()
    FA = kernels["flash_attention"]
    bundle = registry.get(TRAIN["arch"])
    cfg = dataclasses.replace(bundle.model, num_layers=TRAIN_MESH["layers"])
    run = bundle.run
    gb, seq = TRAIN["global_batch"], TRAIN["seq"]
    dev = torch.device("cuda", torch.cuda.current_device())
    d, m = TRAIN_MESH["mesh"]
    mesh = make_elastic_mesh(d, m, devices=[dev] * (d * m))
    per_step = mesh_kernel_launches(cfg, run, mesh, gb)
    assert per_step == 4 * 1 * 2 * cfg.num_layers, per_step
    n_steps = TRAIN_MESH["warmup"] + TRAIN_MESH["steps"]

    def state(t):
        return store._flatten({"params": t.params, "opt": t.opt_state})[0]

    def data(c, s):
        return OneBatch(SyntheticLM(c, gb, s, seed=0))

    # the same steps unpartitioned at the same depth, its state kept on
    # the card (smollm at 10 layers: 0.6 GB of parameters and moments)
    u = Trainer(cfg, run, global_batch=gb, seq_len=seq, seed=0,
                data=data(cfg, seq), device=dev)
    u_step_s = []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u.train(i + 1)
        torch.cuda.synchronize()
        u_step_s.append(time.perf_counter() - t0)
    plain_losses = [x["loss"] for x in u.metrics_log]
    plain_state = state_copy(u)
    del u
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t = Trainer(cfg, run, global_batch=gb, seq_len=seq, seed=0, mesh=mesh,
                data=data(cfg, seq), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = state(t)
    assert all(isinstance(x, MeshArray) and len(x.shards) == d * m
               and all(sh.device == dev for sh in x.shards) for x in leaves)

    # each cell's parameter and optimizer bytes at rest, against the
    # dry-run's argument bytes for the same mesh and ruleset
    cell_bytes = [sum(x.shards[p].numel() * x.shards[p].element_size()
                      for x in leaves) for p in range(d * m)]
    meta = make_mesh((d, m), ("data", "model"), [torch.device("meta")] * (d * m))
    prog = build_program(cfg, run, ShapeSpec("train_mesh", "train", seq, gb),
                         ShardingCtx.for_mesh(meta, t.ruleset))
    dry_bytes = dryrun.argument_bytes(dataclasses.replace(
        prog, args=prog.args[:2], arg_shardings=prog.arg_shardings[:2]))
    assert cell_bytes == [dry_bytes] * (d * m), (cell_bytes, dry_bytes)
    whole_bytes = sum(x.nbytes for x in leaves)
    del leaves, prog

    # the main path: every count set to 0 just before, read just after
    for mod in kernels.values():
        mod.reset_launches()
    step_s, step_launches, prof = [], [], None
    with FlashShapes() as flash:
        for i in range(n_steps):
            l0 = FA.launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i + 1 == TRAIN_MESH["warmup"]:
                # the card's busy time against the step's wall
                prof = profile_device(lambda: t.train(i + 1))
            else:
                t.train(i + 1)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            step_launches.append(FA.launches() - l0)
    main_launches = {name: mod.launches() for name, mod in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    assert step_launches == [per_step] * n_steps, step_launches
    # every cell's attention on its data cell's rows with all 9 heads:
    # they do not split over the 2 model cells, so the attention repeats
    flash_shapes = sorted(set(flash.shapes))
    assert flash_shapes == [(gb // d, seq, cfg.num_heads, cfg.head_dim)], \
        flash_shapes
    plan = t._step_fn.plan
    assert (plan.attn, plan.mlp, plan.vocab) == (False, True, True), plan
    busy_s = sum(us for us, _ in prof["by_name"].values()) * 1e-6
    assert busy_s > 0, "the profiler saw no device time in the step"
    assert main_launches == {"blockhash": 0, "wkv6": 0, "ssd": 0,
                             "flash_attention": per_step * n_steps}
    losses = [x["loss"] for x in t.metrics_log]
    loss_err = max(abs(a - b) / max(1.0, abs(b))
                   for a, b in zip(losses, plain_losses))
    assert all(np.isfinite(losses)) and loss_err <= MESH_LOSS_TOL, (
        losses, plain_losses)
    gaps = mesh_state_gaps(t, plain_state)
    del plain_state
    print(f"train_mesh: the bf16 step's parameters after {n_steps} steps "
          f"within {gaps['params']:.3e} of the unpartitioned run's (bound "
          f"{MESH_PARAM_TOL}), its first moments within {gaps['mu']:.3e} "
          f"(bound {MESH_MOMENT_TOL}; largest element {gaps['mu_max']:.3e})",
          flush=True)
    timed_s = step_s[TRAIN_MESH["warmup"]:]
    step_med = statistics.median(timed_s)
    del t
    torch.cuda.empty_cache()
    f32 = None
    if not state_held(gaps):
        f32 = mesh_f32_hold(cfg, run, mesh, gb, seq, n_steps)
        assert f32["param_max_rel_err"] <= MESH_PARAM_TOL, f32
        assert f32["moment_rel_err"] <= MESH_MOMENT_TOL, f32
        assert f32["loss_max_rel_err"] <= MESH_LOSS_TOL, f32

    # the elastic round through a bento mount, at depth 2
    ecfg = dataclasses.replace(cfg, num_layers=TRAIN_MESH["elastic_layers"])
    eseq = TRAIN_MESH["elastic_seq"]

    def elastic():
        mf = make_mount("bento", n_blocks=TRAIN_CKPT["n_blocks"], device=dev)
        et = Trainer(ecfg, run, global_batch=gb, seq_len=eseq, seed=0,
                     mesh=mesh, ckpt_view=mf.view, data=data(ecfg, eseq),
                     device=dev)
        et.train(1)
        saved = [x.gather() for x in state(et)]
        t0 = time.perf_counter()
        et.save_checkpoint()
        save_s = time.perf_counter() - t0
        rounds = []
        for shape in TRAIN_MESH["elastic"]:
            n = shape[0] * shape[1]
            et.elastic_rescale(make_elastic_mesh(*shape, devices=[dev] * n))
            rescaled = all(torch.equal(x.gather(), w)
                           for x, w in zip(state(et), saved))
            t0 = time.perf_counter()
            assert et.restore_checkpoint() and et.step_idx == 1
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            got = state(et)
            assert all(len(x.shards) == n for x in got)
            restored = all(torch.equal(x.gather(), w)
                           for x, w in zip(got, saved))
            assert rescaled and restored, (shape, rescaled, restored)
            rounds.append({"mesh": list(shape), "restore_s": restore_s,
                           "rescaled_equal": rescaled,
                           "restored_equal": restored,
                           "overlap_ratio":
                               et.last_restore_stats["overlap_ratio"]})
        nbytes = sum(w.numel() * w.element_size() for w in saved)
        mf.close()
        return save_s, rounds, nbytes

    (save_s, rounds, ckpt_bytes), launches, tally = counted(elastic)
    assert launches == tally["calls"] + tally["probes"] and launches > 0, (
        launches, tally)
    for r in rounds:
        r["restore_mb_per_s"] = ckpt_bytes / r["restore_s"] / 1e6

    # the same path over real cards, where the machine has them
    real = None
    n_cards = torch.cuda.device_count()
    rd, rm = TRAIN_MESH["real_mesh"]
    if n_cards >= rd * rm:
        rt = Trainer(cfg, run, global_batch=gb, seq_len=seq, seed=0,
                     mesh=make_host_mesh(rd, rm), data=data(cfg, seq),
                     device=dev)
        assert {sh.device for x in state(rt) for sh in x.shards} == {
            torch.device("cuda", i) for i in range(rd * rm)}
        rt.train(2)
        real_losses = [x["loss"] for x in rt.metrics_log]
        assert all(abs(a - b) <= MESH_LOSS_TOL * max(1.0, abs(b))
                   for a, b in zip(real_losses, plain_losses)), real_losses
        real = {"mesh": [rd, rm], "losses": real_losses}
        del rt
    else:
        print(f"train_mesh: the path over real cards was not run: the "
              f"machine has {n_cards} CUDA device(s) and a ({rd}, {rm}) mesh "
              f"of real cards needs {rd * rm}", flush=True)
    torch.cuda.empty_cache()
    emit("train_mesh", arch=cfg.name, layers=cfg.num_layers,
         cut=f"depth {bundle.model.num_layers} -> {cfg.num_layers}",
         mesh=[d, m], device="virtual", ruleset="baseline",
         global_batch=gb, seq=seq, cell_rows=gb // d, init_s=init_s,
         warmup_steps=TRAIN_MESH["warmup"], timed_steps=len(timed_s),
         step_ms=step_med * 1e3, step_ms_all=[x * 1e3 for x in step_s],
         step_ms_unpartitioned=statistics.median(
             u_step_s[TRAIN_MESH["warmup"]:]) * 1e3,
         step_ms_all_unpartitioned=[x * 1e3 for x in u_step_s],
         tokens_per_s=gb * seq / step_med,
         device_idle_share=1 - busy_s / prof["wall_s"],
         profiled_step_wall_s=prof["wall_s"], device_busy_s=busy_s,
         profile_tables_s=prof["tables_s"],
         peak_memory_bytes=peak, base_memory_bytes=base,
         flash_launches_per_step=per_step, main_path_launches=main_launches,
         flash_shapes=flash_shapes,
         tensor_parallel={"model_local": ["mlp", "vocab"],
                          "repeated": plan.repeated(cfg)},
         losses=losses, plain_losses=plain_losses, loss_max_rel_err=loss_err,
         param_max_rel_err=gaps["params"], moment_rel_err=gaps["mu"],
         moment_max_rel_err=gaps["mu_max"],
         f32_hold=f32,
         tolerance={"loss": f"{MESH_LOSS_TOL} x max(1, |plain|)",
                    "params": f"{MESH_PARAM_TOL} x max(1, max|plain|) a "
                              f"leaf",
                    "first_moment": f"|gap| <= {MESH_MOMENT_TOL} x "
                                    f"|plain| a leaf (norms)",
                    "f32_hold": "both, in f32 compute, where the bf16 "
                                "step exceeds either"},
         cell_bytes=cell_bytes, dryrun_argument_bytes=dry_bytes,
         whole_state_bytes=whole_bytes,
         elastic={"layers": ecfg.num_layers, "seq": eseq,
                  "checkpoint_bytes": ckpt_bytes, "save_s": save_s,
                  "save_mb_per_s": ckpt_bytes / save_s / 1e6,
                  "rounds": rounds, "blockhash_launches": launches,
                  "checksum_calls": tally["calls"],
                  "probe_launches": tally["probes"]},
         real_cards=real, cuda_devices=n_cards)
    return main_launches["flash_attention"]


def mesh_held_run(phase: str, cfg, run, mesh, spec, *, shapes: dict,
                  local, ruleset: str = "baseline",
                  plain=contextlib.nullcontext,
                  plain_name: str = "the unpartitioned run",
                  profile: bool = False) -> dict:
    """One partitioned trainer on ``mesh`` held against its unpartitioned
    counterpart (train_mesh_olmoe's runs, train_mesh_rwkv6,
    train_mesh_zamba2): the counterpart first (inside the context
    ``plain()``, at the same depth, its state kept on the card), then the
    mesh run. Held: the plan (the leaf groups ``local`` model-local,
    nothing repeated); each cell's bytes at rest equal to the dry-run's
    argument bytes (exact); the launches of each step of each kernel of
    ``shapes`` (``mesh_kernel_launches``), each at the cell's shape
    ``shapes`` gives it (its first argument's), and no other kernel's; the
    losses step by step and
    the gathered parameters and first moments after the last one within
    MESH_LOSS_TOL, MESH_PARAM_TOL and MESH_MOMENT_TOL (where the bf16 run
    exceeds a bound, in f32 compute at the cut ``spec["f32_hold"]``
    gives). With ``profile`` the last warm-up step is profiled (the
    device's idle share). Returns the run's row: step ms against the
    counterpart's, tokens/s, the peak (its base counts the counterpart's
    state)."""
    import dataclasses

    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.sharding import MeshArray, ShardingCtx
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.programs import build_program
    from repro_torch.models import params as P
    from repro_torch.train.trainer import Trainer

    kernels = _kernel_counts()
    gb, seq = TRAIN_SHAPE["global_batch"], TRAIN_SHAPE["seq"]
    dev = mesh.devices.flat[0]
    d, m = mesh.devices.shape
    n_steps = spec["warmup"] + spec["steps"]
    per_step = {k: mesh_kernel_launches(cfg, run, mesh, gb, k)
                for k in shapes}

    def data():
        return OneBatch(SyntheticLM(cfg, gb, seq, seed=0))

    def freed():
        # what a trainer left in reference cycles, collected before the
        # next run's base is read (the unpartitioned trainer has some)
        gc.collect()
        torch.cuda.empty_cache()

    def steps(t, step=lambda t, i: t.train(i + 1)):
        step_s = []
        for i in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(t, i)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        return step_s

    freed()
    with plain():
        t = Trainer(cfg, run, global_batch=gb, seq_len=seq, seed=0,
                    data=data(), device=dev)
        plain_s = steps(t)
    plain_losses = [x["loss"] for x in t.metrics_log]
    plain_state = state_copy(t)
    plain_ms = statistics.median(plain_s[spec["warmup"]:]) * 1e3
    del t
    freed()

    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    t = Trainer(cfg, run, global_batch=gb, seq_len=seq, seed=0, mesh=mesh,
                ruleset=ruleset, data=data(), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    plan = t._step_fn.plan
    assert plan.segmented and all(getattr(plan, g) for g in local), plan
    assert plan.repeated(cfg) == [], plan
    leaves = [x for tree in (t.params, t.opt_state) for x in P.leaves(tree)]
    assert all(isinstance(x, MeshArray) and len(x.shards) == d * m
               for x in leaves)
    cell_bytes = [sum(x.shards[p].numel() * x.shards[p].element_size()
                      for x in leaves) for p in range(d * m)]
    meta = make_mesh((d, m), ("data", "model"),
                     [torch.device("meta")] * (d * m))
    prog = build_program(cfg, run, ShapeSpec(phase, "train", seq, gb),
                         ShardingCtx.for_mesh(meta, ruleset))
    dry_bytes = dryrun.argument_bytes(dataclasses.replace(
        prog, args=prog.args[:2], arg_shardings=prog.arg_shardings[:2]))
    assert cell_bytes == [dry_bytes] * (d * m), (cell_bytes, dry_bytes)
    whole_bytes = sum(x.nbytes for x in leaves)
    n_params = sum(math.prod(x.shape) for x in P.leaves(t.params))
    del leaves, prog

    # the main path: every count set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.reset_launches()
    step_launches, prof = [], {}

    def step(t, i):
        l0 = {k: kernels[k].launches() for k in shapes}
        if profile and i + 1 == spec["warmup"]:
            prof.update(profile_device(lambda: t.train(i + 1)))
        else:
            t.train(i + 1)
        step_launches.append({k: kernels[k].launches() - l0[k]
                              for k in shapes})

    with contextlib.ExitStack() as stack:
        seen = {k: stack.enter_context(LaunchShapes(kernels[k],
                                                    KERNEL_OPS[k]))
                for k in shapes}
        step_s = steps(t, step)
    main_launches = {k: mod.launches() for k, mod in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    assert step_launches == [per_step] * n_steps, step_launches
    assert main_launches == {k: per_step.get(k, 0) * n_steps
                             for k in kernels}, main_launches
    for k, shape in shapes.items():
        assert set(seen[k].shapes) == {shape}, (k, set(seen[k].shapes))
    losses = [x["loss"] for x in t.metrics_log]
    assert len(losses) == n_steps and all(np.isfinite(losses)), losses
    loss_err = max(abs(a - b) / max(1.0, abs(b))
                   for a, b in zip(losses, plain_losses))
    assert loss_err <= MESH_LOSS_TOL, (phase, ruleset, losses, plain_losses)
    gaps = mesh_state_gaps(t, plain_state)
    del plain_state
    print(f"{phase} ({ruleset}): the bf16 parameters after {n_steps} steps "
          f"within {gaps['params']:.3e} of {plain_name}'s (bound "
          f"{MESH_PARAM_TOL}), the first moments within {gaps['mu']:.3e} "
          f"(bound {MESH_MOMENT_TOL}; largest element "
          f"{gaps['mu_max']:.3e})", flush=True)
    step_med = statistics.median(step_s[spec["warmup"]:])
    del t
    freed()
    f32 = None
    if not state_held(gaps):
        cut = spec["f32_hold"]
        f32 = mesh_f32_hold(
            dataclasses.replace(cfg, num_layers=cut.get("layers",
                                                        cfg.num_layers)),
            run, mesh, gb, cut["seq"], cut["steps"], ruleset=ruleset,
            plain=plain)
        freed()
        assert f32["param_max_rel_err"] <= MESH_PARAM_TOL, f32
        assert f32["moment_rel_err"] <= MESH_MOMENT_TOL, f32
        assert f32["loss_max_rel_err"] <= MESH_LOSS_TOL, f32
    row = {"ruleset": ruleset, "params": n_params, "init_s": init_s,
           "step_ms": step_med * 1e3, "step_ms_all": [x * 1e3 for x in step_s],
           "plain_step_ms": plain_ms, "tokens_per_s": gb * seq / step_med,
           "peak_memory_bytes": peak, "base_memory_bytes": base,
           **{f"{k.split('_')[0]}_launches_per_step": n
              for k, n in per_step.items()},
           "main_path_launches": main_launches,
           **{f"{k.split('_')[0]}_shape": list(shape)
              for k, shape in shapes.items()},
           "repeated": plan.repeated(cfg), "cell_bytes": cell_bytes,
           "dryrun_argument_bytes": dry_bytes,
           "whole_state_bytes": whole_bytes,
           "losses": losses, "plain": plain_name,
           "plain_losses": plain_losses, "loss_max_rel_err": loss_err,
           "param_max_rel_err": gaps["params"],
           "moment_rel_err": gaps["mu"], "moment_max_rel_err": gaps["mu_max"],
           "f32_hold": f32}
    if profile:
        busy_s = sum(us for us, _ in prof["by_name"].values()) * 1e-6
        assert busy_s > 0, "the profiler saw no device time in the step"
        row.update(device_idle_share=1 - busy_s / prof["wall_s"],
                   profiled_step_wall_s=prof["wall_s"], device_busy_s=busy_s)
    return row


MESH_TOLERANCE = {"loss": f"{MESH_LOSS_TOL} x max(1, |plain|)",
                  "params": f"{MESH_PARAM_TOL} x max(1, max|plain|) a leaf",
                  "first_moment": f"|gap| <= {MESH_MOMENT_TOL} x |plain| a "
                                  f"leaf (norms)",
                  "f32_hold": "all three, in f32 compute, where a bf16 run "
                              "exceeds one"}


def phase_train_mesh_olmoe():
    """The partitioned step tensor-parallel over ``model`` on the MoE
    family (TRAIN_MESH_OLMOE): olmoe-1b-7b at full width, 2 layers, on a
    virtual (2, 2) mesh of the card, with the dense dispatch and with the
    expert-parallel a2a, each run on its own trainer (freed before the
    next: 1.88 G parameters at 16 bytes each), each held by
    ``mesh_held_run``. Each cell computes with its own attention heads,
    experts and vocabulary rows (the plan's), gathering over ``model``
    only the router; 4 cells x 1 microbatch x 2 layers x the forward and
    the recompute flash launches a step, each cell's 4 rows with its 8
    heads. The dense run's counterpart is train_olmoe's trainer at 2
    layers; the a2a's the same steps with the MoE layer through
    plain_a2a_moe over the mesh's d x m slices of the tokens (data cell
    i's rows, cut in m by model rank j, are slice m i + j). The last
    warm-up step of each run is profiled (the idle share)."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.models import moe

    spec = TRAIN_MESH_OLMOE
    bundle = registry.get(spec["arch"])
    cfg = dataclasses.replace(bundle.model, num_layers=spec["layers"])
    gb, seq = TRAIN_SHAPE["global_batch"], TRAIN_SHAPE["seq"]
    dev = torch.device("cuda", torch.cuda.current_device())
    d, m = spec["mesh"]
    mesh = make_elastic_mesh(d, m, devices=[dev] * (d * m))
    assert mesh_kernel_launches(cfg, bundle.run, mesh, gb) == \
        4 * 1 * 2 * cfg.num_layers == 16
    shape = (gb // d, seq, cfg.num_heads // m, cfg.head_dim)
    assert shape == (4, 2048, 8, 128), shape

    dropped = []
    plain = plain_a2a_moe(d * m, dropped)

    @contextlib.contextmanager
    def plain_a2a():
        orig = moe.moe_apply
        moe.moe_apply = lambda cfg_, ctx, w, x, impl="dense": plain(
            cfg_, ctx, w, x)
        try:
            yield
        finally:
            moe.moe_apply = orig

    plains = {"dense": (f"train_olmoe ({cfg.num_layers} layers)",
                        contextlib.nullcontext),
              "a2a": ("plain_a2a_moe over 4 token slices, unpartitioned",
                      plain_a2a)}
    runs, total_launches = {}, 0
    for name, impl, ruleset in spec["runs"]:
        plain_name, plain_ctx = plains[name]
        runs[name] = {"moe_impl": impl, **mesh_held_run(
            "train_mesh_olmoe", cfg, bundle.run.replace(moe_impl=impl), mesh,
            spec, shapes={"flash_attention": shape},
            local=("attn", "experts", "vocab"), ruleset=ruleset,
            plain=plain_ctx, plain_name=plain_name, profile=True)}
        total_launches += runs[name]["main_path_launches"]["flash_attention"]
    a2a = runs["a2a"]
    a2a["plain_dropped_assignments_per_layer_call"] = [
        min(dropped), max(dropped)]
    a2a["loss_max_rel_err_to_dense_plain"] = max(
        abs(a - b) / max(1.0, abs(b)) for a, b in
        zip(a2a["losses"], runs["dense"]["plain_losses"]))
    emit("train_mesh_olmoe", arch=cfg.name, layers=cfg.num_layers,
         cut=f"depth {bundle.model.num_layers} -> {cfg.num_layers} "
             f"(train_olmoe's 4 halved for the smoke's seconds)",
         mesh=[d, m], device="virtual",
         global_batch=gb, seq=seq, cell_rows=gb // d,
         warmup_steps=spec["warmup"], timed_steps=spec["steps"],
         step_ms_of_train_olmoe=EMITTED["train_olmoe"]["step_ms"],
         tensor_parallel={"model_local": ["attention", "experts", "vocab"],
                          "gathered_over_model": ["router", "norm scales"]},
         tolerance=MESH_TOLERANCE, runs=runs)
    return total_launches


def cross_flash_pairs(cfg, gb: int, seq: int, d: int, m: int) -> dict:
    """The (q, k) shapes of a cell's flash launches on the VLM's or
    whisper's mesh path, by kind, and each kind's launches a step: every
    cell's rows and its own heads, forward and recompute."""
    from repro_torch.models import transformer as T

    rows, hq, hkv, D = gb // d, cfg.num_heads // m, cfg.num_kv_heads // m, \
        cfg.head_dim
    q = (rows, seq, hq, D)
    if cfg.family == "vlm":
        g, s = T._vlm_groups(cfg)
        return {"self": ((q, (rows, seq, hkv, D)), d * m * 2 * g * s),
                "cross": ((q, (rows, cfg.num_image_tokens, hkv, D)),
                          d * m * 2 * g)}
    enc = (rows, cfg.encoder_seq, hq, D)
    return {"encoder": ((enc, (rows, cfg.encoder_seq, hkv, D)),
                        d * m * 2 * cfg.encoder_layers),
            "decoder": ((q, (rows, seq, hkv, D)), d * m * 2 * cfg.num_layers),
            "cross": ((q, (rows, cfg.encoder_seq, hkv, D)),
                      d * m * 2 * cfg.num_layers)}


def phase_train_mesh_cross(name):
    """The partitioned step tensor-parallel over ``model`` on the
    cross-attention families, held against the training phase it follows
    (TRAIN_MESH_CROSS): llama-3.2-vision-11b (``train_mesh_vlm``) at
    full width and one super-block (4 self layers, 1 gated cross layer),
    or whisper-small whole (``train_mesh_whisper``: 12 encoder layers, 12
    decoder layers with their cross attention), on a virtual (2, 2) mesh
    of the card. Each cell computes with its own heads in every attention
    (the VLM's 16 q and 4 kv heads, whisper's 6 of 12), its half of the
    MLP columns, and its half of the vocabulary (the VLM's; whisper's
    51865 rows do not split, so its embedding and logits repeat); the
    norms and the gates are replicated work (the gates after the exits).
    Held: the plan (``Plan.repeated``); each cell's bytes at rest equal
    to the dry-run's argument bytes (exact); the flash launches of each
    step (``mesh_kernel_launches``) and their (q, k) shapes, each cell's 4
    rows with its own heads (``cross_flash_pairs``); the losses step by
    step, and the gathered parameters and first moments after the last
    step, against the training phase's first steps (TRAIN_STATE_AT),
    within MESH_LOSS_TOL, MESH_PARAM_TOL and MESH_MOMENT_TOL (all three,
    where the bf16 run exceeds a bound, in f32 compute at the cut the
    spec gives). Step ms against the training phase's and the peak are
    kept."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.sharding import MeshArray, ShardingCtx
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_elastic_mesh, make_mesh
    from repro_torch.launch.programs import build_program
    from repro_torch.models import params as P
    from repro_torch.train.trainer import Trainer

    spec = TRAIN_MESH_CROSS[name]
    of = name.replace("train_mesh", "train")
    kernels = _kernel_counts()
    FA = kernels["flash_attention"]
    bundle = registry.get(spec["arch"])
    train = TRAIN_MODELS[of]
    cfg = dataclasses.replace(bundle.model, num_layers=train["layers"])
    run = bundle.run
    gb, seq = TRAIN_SHAPE["global_batch"], train.get("seq",
                                                    TRAIN_SHAPE["seq"])
    dev = torch.device("cuda", torch.cuda.current_device())
    d, m = spec["mesh"]
    mesh = make_elastic_mesh(d, m, devices=[dev] * (d * m))
    n_steps = spec["steps"]
    per_step = mesh_kernel_launches(cfg, run, mesh, gb)
    shapes = cross_flash_pairs(cfg, gb, seq, d, m)
    assert per_step == sum(n for _, n in shapes.values()), (per_step, shapes)
    if cfg.family == "vlm":
        assert per_step == 40 and shapes["self"][0][0] == (4, 2048, 16, 128) \
            and shapes["cross"][0][1] == (4, 6404, 4, 128), shapes
    else:
        assert per_step == 4 * 36 * 2 == 288, per_step
        assert shapes["encoder"][0] == ((4, 1500, 6, 64),) * 2 and \
            shapes["cross"][0] == ((4, 448, 6, 64), (4, 1500, 6, 64)), shapes

    def state(t):
        return [x for tree in (t.params, t.opt_state) for x in P.leaves(tree)]

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    t = Trainer(cfg, run, global_batch=gb, seq_len=seq, seed=0, mesh=mesh,
                data=OneBatch(SyntheticLM(cfg, gb, seq, seed=0)), device=dev)
    gates = draw_gates(t.params, seed=0)  # as the training phase draws them
    assert gates == EMITTED[of]["gates"], (gates, EMITTED[of]["gates"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    plan = t._step_fn.plan
    assert plan.attn and plan.xattn and plan.mlp, plan
    repeated = [] if cfg.family == "vlm" else ["embedding and logits"]
    assert plan.vocab == (not repeated) and plan.repeated(cfg) == repeated, \
        plan
    leaves = state(t)
    assert all(isinstance(x, MeshArray) and len(x.shards) == d * m
               for x in leaves)
    cell_bytes = [sum(x.shards[p].numel() * x.shards[p].element_size()
                      for x in leaves) for p in range(d * m)]
    meta = make_mesh((d, m), ("data", "model"),
                     [torch.device("meta")] * (d * m))
    prog = build_program(cfg, run, ShapeSpec(name, "train", seq, gb),
                         ShardingCtx.for_mesh(meta, t.ruleset))
    dry_bytes = dryrun.argument_bytes(dataclasses.replace(
        prog, args=prog.args[:2], arg_shardings=prog.arg_shardings[:2]))
    assert cell_bytes == [dry_bytes] * (d * m), (cell_bytes, dry_bytes)
    whole_bytes = sum(x.nbytes for x in leaves)
    del leaves, prog

    # the main path: every count set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.reset_launches()
    step_s, step_launches = [], []
    with FlashShapes() as flash:
        for i in range(n_steps):
            l0 = FA.launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.train(i + 1)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            step_launches.append(FA.launches() - l0)
    main_launches = {k: mod.launches() for k, mod in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    assert step_launches == [per_step] * n_steps, step_launches
    assert main_launches == {"blockhash": 0, "wkv6": 0, "ssd": 0,
                             "flash_attention": per_step * n_steps}
    assert sorted(flash.pairs) == sorted(
        pair for pair, n in shapes.values() for _ in range(n * n_steps)
    ), sorted(set(flash.pairs))
    losses = [x["loss"] for x in t.metrics_log]
    assert len(losses) == n_steps and all(np.isfinite(losses)), losses
    plain_losses = EMITTED[of]["losses"][:n_steps]
    loss_err = max(abs(a - b) / max(1.0, abs(b))
                   for a, b in zip(losses, plain_losses))
    assert loss_err <= MESH_LOSS_TOL, (losses, plain_losses)
    gaps = mesh_state_gaps(t, TRAIN_STATE_AT.pop(of))
    print(f"{name}: the bf16 step's parameters after {n_steps} steps "
          f"within {gaps['params']:.3e} of {of}'s (bound {MESH_PARAM_TOL}), "
          f"its first moments within {gaps['mu']:.3e} (bound "
          f"{MESH_MOMENT_TOL}; largest element {gaps['mu_max']:.3e})",
          flush=True)
    del t
    gc.collect()
    torch.cuda.empty_cache()
    f32 = None
    if not state_held(gaps):
        cut = spec["f32_hold"]
        f32 = mesh_f32_hold(cfg, run, mesh, gb, cut["seq"], cut["steps"],
                            host=True)
        gc.collect()
        torch.cuda.empty_cache()
        assert f32["param_max_rel_err"] <= MESH_PARAM_TOL, f32
        assert f32["moment_rel_err"] <= MESH_MOMENT_TOL, f32
        assert f32["loss_max_rel_err"] <= MESH_LOSS_TOL, f32
    step_ms = [x * 1e3 for x in step_s]
    local = (["attention", "cross attention", "mlp"]
             + ([] if repeated else ["vocab"]))
    replicated = ["norm scales"] + (["gates"] if gates else [])
    emit(name, arch=cfg.name, layers=cfg.num_layers,
         encoder_layers=cfg.encoder_layers or None,
         cut=None if cfg.num_layers == bundle.model.num_layers else
         f"depth {bundle.model.num_layers} -> {cfg.num_layers} ({of}'s)",
         mesh=[d, m], device="virtual", ruleset="baseline", global_batch=gb,
         seq=seq, cell_rows=gb // d,
         kv_tokens=(cfg.num_image_tokens if cfg.family == "vlm"
                    else cfg.encoder_seq), steps=n_steps,
         init_s=init_s, step_ms=step_ms[-1], step_ms_all=step_ms,
         step_ms_of_plain=EMITTED[of]["step_ms"], plain=of,
         tokens_per_s=gb * seq / step_s[-1],
         peak_memory_bytes=peak, base_memory_bytes=base,
         peak_memory_of_plain=EMITTED[of]["peak_memory_bytes"],
         flash_launches_per_step=per_step, main_path_launches=main_launches,
         flash_shapes={k: {"q": list(q_), "k": list(k_), "per_step": n}
                       for k, ((q_, k_), n) in shapes.items()},
         tensor_parallel={"model_local": local, "repeated": repeated,
                          "replicated": replicated},
         losses=losses, plain_losses=plain_losses, loss_max_rel_err=loss_err,
         param_max_rel_err=gaps["params"], moment_rel_err=gaps["mu"],
         moment_max_rel_err=gaps["mu_max"], f32_hold=f32,
         tolerance={"loss": f"{MESH_LOSS_TOL} x max(1, |plain|)",
                    "params": f"{MESH_PARAM_TOL} x max(1, max|plain|) a "
                              f"leaf",
                    "first_moment": f"|gap| <= {MESH_MOMENT_TOL} x "
                                    f"|plain| a leaf (norms)",
                    "f32_hold": "all three, in f32 compute, where the bf16 "
                                "run exceeds one"},
         cell_bytes=cell_bytes, dryrun_argument_bytes=dry_bytes,
         whole_state_bytes=whole_bytes)
    # the pinned blocks of the host copies, kept by the host allocator
    getattr(torch._C, "_host_emptyCache", lambda: None)()
    return main_launches["flash_attention"]


def phase_train_mesh_rwkv6():
    """The partitioned step tensor-parallel over ``model`` on rwkv6
    (TRAIN_MESH_RWKV6), held by ``mesh_held_run``: rwkv6-7b at full width
    and 2 layers on a virtual (2, 2) mesh of the card. Each cell runs the
    time mix on its own 32 of the 64 WKV heads (its columns of ``wr``,
    ``wk``, ``wv``, ``wg``, its rows of ``wo``; ``ln_x`` over all of d
    from the cells' summed squares), the channel mix on its 7168 of the
    14336 columns, and its half of the vocabulary; the token shift, the
    mixes, their LoRAs, the decay, the receptance gate and the norms are
    replicated work. 4 cells x 1 microbatch x 2 layers x the forward and
    the recompute WKV6 launches a step, each cell's 4 rows with its 32
    heads. Its counterpart is train_rwkv6's trainer at 2 layers. No step
    is profiled (reading the trace of rwkv6's step costs its phase tens
    of seconds: train_rwkv6's)."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_elastic_mesh

    spec = TRAIN_MESH_RWKV6
    bundle = registry.get(spec["arch"])
    cfg = dataclasses.replace(bundle.model, num_layers=spec["layers"])
    gb, seq = TRAIN_SHAPE["global_batch"], TRAIN_SHAPE["seq"]
    dev = torch.device("cuda", torch.cuda.current_device())
    d, m = spec["mesh"]
    mesh = make_elastic_mesh(d, m, devices=[dev] * (d * m))
    assert mesh_kernel_launches(cfg, bundle.run, mesh, gb, "wkv6") == \
        4 * 1 * 2 * cfg.num_layers == 16
    K = cfg.wkv_head_dim
    shape = (gb // d, seq, cfg.d_model // K // m, K)
    assert shape == (4, 2048, 32, 64), shape
    row = mesh_held_run("train_mesh_rwkv6", cfg, bundle.run, mesh, spec,
                        shapes={"wkv6": shape},
                        local=("attn", "mlp", "vocab"),
                        plain_name=f"train_rwkv6 ({cfg.num_layers} layers)")
    emit("train_mesh_rwkv6", arch=cfg.name, layers=cfg.num_layers,
         cut=f"depth {bundle.model.num_layers} -> {cfg.num_layers}: the "
             f"smoke's seconds; f32 state at 12 bytes a parameter",
         mesh=[d, m], device="virtual", global_batch=gb, seq=seq,
         cell_rows=gb // d, warmup_steps=spec["warmup"],
         timed_steps=spec["steps"], wkv6_chunk=cfg.scan_chunk,
         step_ms_of_train_rwkv6=EMITTED["train_rwkv6"]["step_ms"],
         tensor_parallel={"model_local": ["time mix", "channel mix",
                                          "vocab"],
                          "replicated": ["token shift, mixes, LoRAs, decay",
                                         "receptance gate", "norm scales"]},
         tolerance=MESH_TOLERANCE, **row)
    return row["main_path_launches"]["wkv6"]


def phase_train_mesh_zamba2():
    """The partitioned step tensor-parallel over ``model`` on zamba2
    (TRAIN_MESH_ZAMBA2), held by ``mesh_held_run``: zamba2-7b at full
    width and 6 layers on a virtual (2, 2) mesh of the card. Each cell
    keeps its even block of each layer's ``w_in`` columns at rest (7288 of
    14576: gate, x, B, C and dt side by side, so the cut falls on no
    head's border) and gathers the leaf over ``model`` inside its tape,
    whose transpose reduce-scatters the gradient; it runs the Mamba2 block
    on its own 56 of the 112 SSD heads (B and C projected and convolved in
    every cell), the gated norm over all of d_inner from the cells' summed
    squares, its 3584 rows of ``w_out``; the shared block (after layer 5)
    on 16 of the 32 heads and 7168 of the 14336 MLP columns; half the
    vocabulary. The conv, ``A_log``, ``D``, ``dt_bias`` and the norms'
    scales are replicated. 4 cells x 1 microbatch x the forward and the
    recompute: 48 SSD launches a step at a cell's (4, 2048, 56, 64) and 8
    flash launches at (4, 2048, 16, 112), causal. Its counterpart is
    train_zamba2's trainer at 6 layers. No step is profiled."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.models import mamba2

    spec = TRAIN_MESH_ZAMBA2
    bundle = registry.get(spec["arch"])
    cfg = dataclasses.replace(bundle.model, num_layers=spec["layers"])
    gb, seq = TRAIN_SHAPE["global_batch"], TRAIN_SHAPE["seq"]
    dev = torch.device("cuda", torch.cuda.current_device())
    d, m = spec["mesh"]
    mesh = make_elastic_mesh(d, m, devices=[dev] * (d * m))
    assert mamba2.n_shared_applications(cfg) == 1
    assert (mesh_kernel_launches(cfg, bundle.run, mesh, gb, "ssd"),
            mesh_kernel_launches(cfg, bundle.run, mesh, gb,
                                 "flash_attention")) == (
        4 * 1 * 2 * cfg.num_layers, 4 * 1 * 2 * 1) == (48, 8)
    _, H, Pd, N = mamba2.dims(cfg)
    shapes = {"ssd": (gb // d, seq, H // m, Pd),
              "flash_attention": (gb // d, seq, cfg.num_heads // m,
                                  cfg.head_dim)}
    assert shapes == {"ssd": (4, 2048, 56, 64),
                      "flash_attention": (4, 2048, 16, 112)}, shapes
    assert (*shapes["ssd"], N, cfg.scan_chunk) in SSD_SHAPES
    assert (4, 2048, 2048, 16, 16, 112, True, 0, 0.0) in FLASH_CASES
    row = mesh_held_run("train_mesh_zamba2", cfg, bundle.run, mesh, spec,
                        shapes=shapes, local=("ssd", "attn", "mlp", "vocab"),
                        plain_name=f"train_zamba2 ({cfg.num_layers} layers)")
    emit("train_mesh_zamba2", arch=cfg.name, layers=cfg.num_layers,
         cut=f"depth {bundle.model.num_layers} -> {cfg.num_layers} (one "
             f"shared-block application): the smoke's seconds; f32 state at "
             f"12 bytes a parameter",
         mesh=[d, m], device="virtual", global_batch=gb, seq=seq,
         cell_rows=gb // d, warmup_steps=spec["warmup"],
         timed_steps=spec["steps"], ssd_chunk=cfg.scan_chunk,
         step_ms_of_train_zamba2=EMITTED["train_zamba2"]["step_ms"],
         tensor_parallel={"model_local": ["mamba2 (w_in, w_out)",
                                          "shared attention",
                                          "shared mlp", "vocab"],
                          "gathered_in_the_tape": ["w_in, a layer at a time"],
                          "replicated": ["B and C projections and conv",
                                         "conv, A_log, D, dt_bias",
                                         "norm scales"]},
         tolerance=MESH_TOLERANCE, **row)
    return row["main_path_launches"]


# --- the twelfth slice: the dry-run held against the card, the examples ------------

# The dry-run's programs (launch.programs over meta tensors, traced by
# launch.op_analysis), one for each serve and training phase that
# launches a model kernel, each at the shapes of the phase it is held
# against: that phase's prefill, its cache padded for its tokens and two
# decode steps (launch.dryrun.generate_program), or one training step at
# its depth. The traced kernel calls must equal the phase's launches and
# the traced peak must lie within DRYRUN_PEAK_TOL of the phase's measured
# peak less what the card held when the phase began.
DRYRUN = {"serve_smollm": ("smollm-135m", "generate", None),
          "train_smollm": ("smollm-135m", "train", None),
          "serve_zamba2": ("zamba2-7b", "generate", None),
          "serve_rwkv6": ("rwkv6-7b", "generate", None),
          "serve_olmoe": ("olmoe-1b-7b", "generate", None),
          "serve_vlm": ("llama-3.2-vision-11b", "generate", None),
          "serve_whisper": ("whisper-small", "generate", None),
          **{name: (spec["arch"], "train", spec["layers"])
             for name, spec in TRAIN_MODELS.items()},
          # the whole virtual mesh's step, every cell's tensors on the one
          # card, as train_mesh_olmoe runs it
          **{f"train_mesh_olmoe_{run}": (TRAIN_MESH_OLMOE["arch"],
                                         "train_mesh",
                                         TRAIN_MESH_OLMOE["layers"])
             for run, _, _ in TRAIN_MESH_OLMOE["runs"]}}
DRYRUN_PEAK_TOL = 0.10
# the kernels' operator names, by their modules' names
KERNEL_OPS = {"flash_attention": "flash_attention_fwd", "wkv6": "wkv6_chunked",
              "ssd": "ssd_chunked", "blockhash": None}
# the serve phases' launch counts: flash the one kernel but in these two
SERVE_LAUNCHES = {
    "serve_zamba2": {"ssd_chunked": "ssd_launches_per_prefill",
                     "flash_attention_fwd": "flash_launches_per_prefill"},
    "serve_rwkv6": {"wkv6_chunked": "wkv6_launches_per_prefill"}}
# the examples on the card: quickstart (checkpoints through a bento mount,
# the fs upgraded under the trainer, a greedy serve), and train_small_lm
# with a failure at step 7 over 17 steps (step 16 sees the first shard
# again: its loss must be below step 0's)
EXAMPLES = {"quickstart_torch": [],
            "train_small_lm_torch": ["--steps", "17", "--fail-at", "7"]}


def dryrun_trace(name: str) -> dict:
    """One DRYRUN program traced on meta tensors (no device is touched):
    its kernel calls, peak bytes, FLOPs and roofline terms. Runs in a
    worker process while the card runs the other phases."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import ShardingCtx
    from repro_torch.launch import dryrun, op_analysis
    from repro_torch.launch.programs import build_program

    t0 = time.perf_counter()
    arch, kind, layers = DRYRUN[name]
    bundle = registry.get(arch)
    cfg = bundle.model if layers is None else dataclasses.replace(
        bundle.model, num_layers=layers)
    if kind == "generate":
        shape = {"serve_smollm": SMOLLM, "serve_zamba2": ZAMBA,
                 "serve_rwkv6": SERVE, "serve_olmoe": SERVE_OLMOE,
                 **SERVE_CROSS}[name]
        prog = dryrun.generate_program(cfg, bundle.run, shape["batch"],
                                       shape["prompt"], shape["gen"])
    elif kind == "train_mesh":
        import torch

        from repro_torch.launch.mesh import make_mesh

        run_name = name.rsplit("_", 1)[1]
        _, impl, ruleset = next(r for r in TRAIN_MESH_OLMOE["runs"]
                                if r[0] == run_name)
        d, m = TRAIN_MESH_OLMOE["mesh"]
        mesh = make_mesh((d, m), ("data", "model"),
                         [torch.device("meta")] * (d * m))
        prog = build_program(cfg, bundle.run.replace(moe_impl=impl),
                             ShapeSpec(name, "train", TRAIN_SHAPE["seq"],
                                       TRAIN_SHAPE["global_batch"]),
                             ShardingCtx.for_mesh(mesh, ruleset))
    else:
        gb, seq = ((TRAIN["global_batch"], TRAIN["seq"])
                   if name == "train_smollm" else
                   (TRAIN_SHAPE["global_batch"],
                    TRAIN_MODELS[name].get("seq", TRAIN_SHAPE["seq"])))
        prog = build_program(cfg, bundle.run, ShapeSpec(name, "train", seq,
                                                        gb),
                             ShardingCtx.null())
        # the trainer puts SyntheticLM's batch on the card as it comes:
        # the VLM's and whisper's embeddings in float32, where the
        # program's spec says bfloat16
        params, opt, batch = prog.args
        batch = {k: v.float() if v.is_floating_point() else v
                 for k, v in batch.items()}
        prog = dataclasses.replace(prog, args=(params, opt, batch))
    summary = op_analysis.analyze(prog.fn, *prog.args)
    return {"program": prog.name, "meta": prog.meta,
            "kernel_calls": summary.kernel_calls,
            "peak_bytes": summary.peak_bytes,
            "dot_flops": summary.dot_flops, "dot_bytes": summary.dot_bytes,
            "roofline_terms_s": dryrun.roofline(summary),
            "trace_s": time.perf_counter() - t0}


def start_dryrun_traces():
    """The DRYRUN traces in two worker processes (the CPU's work of a few
    minutes, which would otherwise hold up the card): the training steps
    first, the longest of them first."""
    import multiprocessing as mp

    pool = mp.get_context("spawn").Pool(2)
    order = sorted(DRYRUN, key=lambda n: (n != "train_rwkv6",
                                          not n.startswith("train")))
    return pool, {n: pool.apply_async(dryrun_trace, (n,)) for n in order}


def phase_dryrun(traces):
    """Each DRYRUN program's trace against the phase it models: the traced
    kernel calls equal the phase's launches exactly, and the traced peak
    lies within DRYRUN_PEAK_TOL of the phase's max_memory_allocated less
    the bytes the card held when the phase began. Also the traced
    compute term beside the phase's measured time (information)."""
    t0 = time.perf_counter()
    rows = {}
    for name, res in traces.items():
        got = res.get(timeout=900)
        if name.startswith("train_mesh_olmoe_"):
            measured = EMITTED["train_mesh_olmoe"]["runs"][
                name.rsplit("_", 1)[1]]
        else:
            measured = EMITTED[name]
        if name in TRAIN_MODELS:
            want = {KERNEL_OPS[k]: n
                    for k, n in measured["launches_per_step"].items() if n}
        elif name == "train_smollm" or name.startswith("train_mesh"):
            want = {"flash_attention_fwd": measured["flash_launches_per_step"]}
        else:
            want = {op: measured[field] for op, field in SERVE_LAUNCHES.get(
                name, {"flash_attention_fwd":
                       "flash_launches_per_prefill"}).items()}
        assert got["kernel_calls"] == want, (name, got["kernel_calls"], want)
        peak = measured["peak_memory_bytes"] - measured["base_memory_bytes"]
        ratio = got["peak_bytes"] / peak
        ms = measured.get("prefill_ms", measured.get("step_ms"))
        rows[name] = {
            "program": got["program"], "shape": got["meta"]["shape"],
            "kernel_calls": got["kernel_calls"], "launches": want,
            "predicted_peak_bytes": got["peak_bytes"],
            "measured_peak_bytes": measured["peak_memory_bytes"],
            "base_memory_bytes": measured["base_memory_bytes"],
            "peak_ratio": ratio,
            "compute_ms": got["roofline_terms_s"]["compute_s"] * 1e3,
            "memory_ms": got["roofline_terms_s"]["memory_s"] * 1e3,
            "measured_ms": ms, "measured_ms_of": (
                "prefill_ms" if "prefill_ms" in measured else "step_ms"),
            "dot_flops": got["dot_flops"], "trace_s": got["trace_s"]}
        print(f"dryrun {name}: predicted peak {got['peak_bytes']} B, "
              f"measured {peak} B (ratio {ratio:.4f}); kernel calls "
              f"{got['kernel_calls']} = launches {want}; compute "
              f"{rows[name]['compute_ms']:.2f} ms beside {ms:.2f} ms",
              flush=True)
    bad = {n: r["peak_ratio"] for n, r in rows.items()
           if abs(r["peak_ratio"] - 1) > DRYRUN_PEAK_TOL}
    emit("dryrun", programs=rows, peak_tolerance=DRYRUN_PEAK_TOL,
         wait_s=time.perf_counter() - t0,
         trace_cpu_s=sum(r["trace_s"] for r in rows.values()))
    assert not bad, f"predicted peaks off by more than {DRYRUN_PEAK_TOL}: {bad}"


def phase_examples():
    """examples/quickstart_torch.py and train_small_lm_torch.py on the
    card, each with every kernel count set to 0 just before and read just
    after: quickstart's checkpoint commits launch the blockhash kernel and
    its training and prefill the flash kernel, its fs upgrade moves the
    mount's generation; train_small_lm recovers from its failure and its
    loss falls."""
    import importlib.util

    kernels = _kernel_counts()
    out = {}
    for name, argv in EXAMPLES.items():
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for k in kernels.values():
            k.reset_launches()
        t0 = time.perf_counter()
        res = mod.main(["--device", "cuda", *argv])
        launches = {k: m.launches() for k, m in kernels.items()}
        out[name] = {"seconds": time.perf_counter() - t0,
                     "launches": launches, "argv": argv,
                     "losses": [res["losses"][0], res["losses"][-1]]}
        if name == "quickstart_torch":
            gen0, gen1 = res["generations"]
            assert launches["blockhash"] > 0 and \
                launches["flash_attention"] > 0, launches
            assert gen1 == gen0 + 1, res["generations"]
            assert res["checkpoints"] == ["step_00000005", "step_00000010",
                                          "step_00000015"]
            out[name].update(generations=[gen0, gen1],
                             generated=res["generated"])
        else:
            assert res["losses"][-1] < res["losses"][0], res["losses"]
            assert res["recoveries"] == 1 and launches["blockhash"] > 0
            out[name].update(recoveries=res["recoveries"])
    emit("examples", examples=out)


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py runs from the root of a checkout: "
              f"{SRC / 'repro_torch'} is missing", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # the training phases run the trainer as launch/train does: with the
    # allocator's segments growing in place (before CUDA starts, so every
    # phase runs under it)
    from repro_torch.device import configure_allocator

    configure_allocator()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py measures the port on a GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = phase_device()
    timed("build", phase_build)
    pool, traces = start_dryrun_traces()
    try:
        return run_phases(t_start, card, traces)
    finally:
        pool.terminate()  # the trace workers: idle or, on a failure, cut
        pool.join()


def run_phases(t_start, card, traces) -> int:
    """Every phase after the build, and the kernels' line and the device
    record last."""
    import torch

    rows = timed("kernel", phase_kernel)
    main_launches, _rates = timed("bento", phase_bento)
    timed("trace", phase_trace)
    timed("other_kinds", phase_other_kinds)
    timed("dedup", phase_dedup)
    timed("parallel_drain", phase_parallel_drain)
    timed("recovery", phase_recovery)
    timed("upgrade", phase_upgrade)
    fs_launches = {"overlay": timed("overlay", phase_overlay),
                   "prov_upgrade": timed("prov_upgrade", phase_prov_upgrade),
                   "fuse_vs_bento": timed("fuse", phase_fuse)}
    fs_launches["crash"], fs_launches["crash_ckpt_shards"] = timed(
        "crash", phase_crash)
    fs_launches["ckpt_reshard"] = timed("ckpt_reshard", phase_ckpt_reshard)
    timed("torch_device", phase_torch_device)
    timed("spmd", phase_spmd)
    wkv_rows = timed("wkv6_kernel", phase_wkv6_kernel)
    wkv_launches, prm, tokens, logits = timed("serve_rwkv6",
                                              phase_serve_rwkv6)
    fs_launches["ckpt_model"] = timed("ckpt_model", phase_ckpt_model, prm,
                                      tokens, logits)
    timed("serve_trace", phase_serve_trace, prm, tokens)
    rwkv_mesh = timed("serve_mesh_rwkv6", phase_serve_mesh,
                      "serve_mesh_rwkv6", prm, tokens)
    del prm, tokens  # the rwkv6 weights (the f32 copy went in its phase)
    torch.cuda.empty_cache()
    ssd_rows = timed("ssd_kernel", phase_ssd_kernel)
    flash_rows = timed("flash_attention_kernel", phase_flash_attention_kernel)
    zamba_launches, prm, tokens = timed("serve_zamba2", phase_serve_zamba2)
    zamba_mesh = timed("serve_mesh_zamba2", phase_serve_mesh,
                       "serve_mesh_zamba2", prm, tokens)
    del prm, tokens  # the zamba2 weights
    torch.cuda.empty_cache()
    flash_by_path = {"serve_zamba2": zamba_launches["flash_attention"],
                     "serve_mesh_zamba2": zamba_mesh["flash_attention"]}
    flash_by_path["serve_smollm"], prm, tokens = timed("serve_smollm",
                                                       phase_serve_smollm)
    for served in ("serve_mesh_smollm", "serve_mesh_flash_smollm"):
        flash_by_path[served] = timed(served, phase_serve_mesh, served, prm,
                                      tokens)["flash_attention"]
    del prm, tokens
    torch.cuda.empty_cache()
    flash_by_path["train_smollm"], smollm_bwd_ms, trainer = timed(
        "train_smollm", phase_train_smollm)
    flash_by_path["pipeline"] = timed("pipeline", phase_pipeline, trainer)
    timed("compression", phase_compression, trainer)
    del trainer
    torch.cuda.empty_cache()
    flash_by_path["train_mesh"] = timed("train_mesh", phase_train_mesh)
    fs_launches["train_ckpt"], flash_by_path["train_ckpt"] = timed(
        "train_ckpt", phase_train_ckpt)
    grad_rows = {name: timed(f"{name}_grad", phase_scan_grad, name)
                 for name in ("wkv6", "ssd")}
    trained = {"train_rwkv6": timed("train_rwkv6", phase_train_model,
                                    "train_rwkv6")}
    wkv_mesh_launches = timed("train_mesh_rwkv6", phase_train_mesh_rwkv6)
    trained["train_zamba2"] = timed("train_zamba2", phase_train_model,
                                    "train_zamba2")
    zamba_mesh_launches = timed("train_mesh_zamba2", phase_train_mesh_zamba2)
    flash_by_path["train_mesh_zamba2"] = zamba_mesh_launches[
        "flash_attention"]
    flash_by_path["serve_olmoe"], prm, tokens = timed("serve_olmoe",
                                                      phase_serve_olmoe)
    flash_by_path["serve_olmoe_a2a"] = timed(
        "serve_olmoe_a2a", phase_serve_olmoe_a2a, prm, tokens)
    for served in ("serve_mesh_olmoe", "serve_mesh_flash_olmoe"):
        flash_by_path[served] = timed(served, phase_serve_mesh, served, prm,
                                      tokens)["flash_attention"]
    del prm, tokens  # the olmoe weights
    torch.cuda.empty_cache()
    trained["train_olmoe"] = timed("train_olmoe", phase_train_model,
                                   "train_olmoe")
    flash_by_path["train_mesh_olmoe"] = timed("train_mesh_olmoe",
                                              phase_train_mesh_olmoe)
    # the VLM, then whisper: each served, served partitioned on the same
    # weights (freed before the training phase, whose peak leaves no room
    # for them), trained, and trained on a mesh against the training
    # phase's state on the host
    for name in SERVE_CROSS:
        flash_by_path[name], prm, batch = timed(name, phase_serve_cross, name)
        served = name.replace("serve", "serve_mesh")
        tokens = batch.pop("tokens")
        flash_by_path[served] = timed(served, phase_serve_mesh, served, prm,
                                      tokens, batch)["flash_attention"]
        del prm, tokens, batch
        torch.cuda.empty_cache()
        train = name.replace("serve", "train")
        trained[train] = timed(train, phase_train_model, train)
        mesh = mesh_of(train)
        flash_by_path[mesh] = timed(mesh, phase_train_mesh_cross, mesh)
    timed("dryrun", phase_dryrun, traces)
    timed("examples", phase_examples)
    (rwkv_train, rwkv_bwd), (zamba_train, zamba_bwd) = (
        trained["train_rwkv6"], trained["train_zamba2"])
    for name in ("train_zamba2", "train_olmoe", "train_vlm", "train_whisper"):
        flash_by_path[name] = trained[name][0]["flash_attention"]
    # decode_flash ran inside the serves that held each model's weights
    PHASE_SECONDS["decode_flash"] = sum(
        r["seconds"] for r in DECODE_FLASH_RESULTS.values())
    assert set(DECODE_FLASH_RESULTS) == set(DECODE_FLASH) - {"mesh", "steps"}
    emit("decode_flash", models=DECODE_FLASH_RESULTS)
    emit("phase_seconds", of="decode_flash",
         seconds=PHASE_SECONDS["decode_flash"],
         within=["serve_zamba2", "serve_smollm", "serve_vlm",
                 "serve_whisper"])
    emit("phase_seconds", seconds=PHASE_SECONDS,
         total=time.perf_counter() - t_start)

    def recompute(name):  # the recompute backward at the training shape
        return {"shape": list(SCAN_GRAD[name]),
                "ms": {r["dtype"]: r["recompute_bwd_ms"]
                       for r in grad_rows[name]},
                "peak_bytes": {r["dtype"]: r["recompute_bwd_peak_bytes"]
                               for r in grad_rows[name]}}

    head = next(r for r in rows if tuple(r["shape"]) == HEADLINE_SHAPE)
    wkv_head = next(r for r in wkv_rows
                    if (tuple(r["shape"]), r["dtype"]) == WKV6_HEADLINE
                    and r["regime"] == "smoke")
    ssd_head = next(r for r in ssd_rows
                    if (tuple(r["shape"]), r["dtype"]) == SSD_HEADLINE)
    flash_head, cross_head = (
        next(r for r in flash_rows if (tuple(r["case"]), r["dtype"]) == h)
        for h in (FLASH_HEADLINE, FLASH_CROSS_HEADLINE))
    print(json.dumps({"kernels": [{
        "name": "blockhash", "route": "cuda",
        "source": "src/repro_torch/csrc/blockhash.cu",
        "replaces": "src/repro/kernels/blockhash/kernel.py:26",
        "launches": main_launches,
        "launches_by_path": {"bento": main_launches, **fs_launches},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "exact": all(r["exact"] for r in rows),
        "shape": list(HEADLINE_SHAPE),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "host_link_bound_ms": head["host_link_bound_ms"],
        "device_resident_ms": head["device_resident_ms"],
        "library_ms": None, "call_ms": head["call_ms"],
        "shapes": rows}, {
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6/kernel.py:72",
        "launches": wkv_launches,
        "launches_by_path": {"serve_rwkv6": wkv_launches,
                             "serve_mesh_rwkv6": rwkv_mesh["wkv6"],
                             "train_rwkv6": rwkv_train["wkv6"],
                             "train_mesh_rwkv6": wkv_mesh_launches},
        "recompute_bwd": recompute("wkv6"),
        "recompute_bwd_ms_in_train_rwkv6": rwkv_bwd["wkv6"],
        "max_abs_err": max(r["max_abs_err"] for r in wkv_rows),
        "tolerance": f"{WKV6_TOL} x max(1, max|ref|)",
        "shape": wkv_head["shape"], "dtype": wkv_head["dtype"],
        "ms": wkv_head["ms"], "plain_ms": wkv_head["plain_ms"],
        "bound_ms": wkv_head["bound_ms"], "bound_by": wkv_head["bound_by"],
        "earlier_bound_ms": wkv_head["earlier_bound_ms"],
        "library_ms": None,
        "shapes": wkv_rows}, {
        "name": "ssd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:69",
        "launches": zamba_launches["ssd"],
        "launches_by_path": {"serve_zamba2": zamba_launches["ssd"],
                             "serve_mesh_zamba2": zamba_mesh["ssd"],
                             "train_zamba2": zamba_train["ssd"],
                             "train_mesh_zamba2": zamba_mesh_launches["ssd"]},
        "recompute_bwd": recompute("ssd"),
        "recompute_bwd_ms_in_train_zamba2": zamba_bwd["ssd"],
        "max_abs_err": max(r["max_abs_err"] for r in ssd_rows),
        "tolerance": f"{SSD_TOL} x max(1, max|ref|)",
        "shape": ssd_head["shape"], "dtype": ssd_head["dtype"],
        "ms": ssd_head["ms"], "plain_ms": ssd_head["plain_ms"],
        "bound_ms": ssd_head["bound_ms"], "bound_by": ssd_head["bound_by"],
        "library_ms": None,
        "shapes": ssd_rows}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:85",
        "launches": zamba_launches["flash_attention"],
        "launches_by_path": flash_by_path,
        "recompute_bwd_ms": {"train_smollm": smollm_bwd_ms, **{
            name: trained[name][1]["flash"] for name in (
                "train_zamba2", "train_olmoe", "train_vlm",
                "train_whisper")}},
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
        "tolerance": {d: f"{t} min(1, max|ref|) + {t} |ref|"
                      for d, t in FLASH_TOL.items()},
        "shape": flash_head["case"], "dtype": flash_head["dtype"],
        "ms": flash_head["ms"], "plain_ms": flash_head["plain_ms"],
        "bound_ms": flash_head["bound_ms"],
        "bound_by": flash_head["bound_by"],
        "library_ms": flash_head["library_ms"],
        "cross_headline": {k: cross_head[k] for k in (
            "case", "dtype", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err", "atol", "dropped_key_tile")},
        "shapes": flash_rows}], "card": card,
        "seconds": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
