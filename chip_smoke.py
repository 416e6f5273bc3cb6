#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (lightgbm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase (1M x 28, 10 rounds)
    python3 chip_smoke.py --rows 200000 --rounds 3   # a short first check
    python3 chip_smoke.py --phases device,k1,k3      # only those phases
    python3 chip_smoke.py --phases k1,k2,k3,k4,profile --parent-src OLD
        # beside each histogram and partition case, OLD's kernel (another
        # checkout of the repo, e.g. an earlier commit from `git archive`)
        # on the same inputs in the same run, and one profiled iteration
        # with OLD's partition kernel (train_quant: with OLD's quantized
        # histograms, the operand built in torch and then OLD's K3)

Phases, one JSON line each:
  device       card name and power limit, and the kernels' build (one nvcc
               per source, started together; ptxas registers and shared
               memory per kernel); per built library and kernel, the count
               of each atomic opcode in its SASS (cuobjdump -sass; "not
               measured" without cuobjdump); the integer kernels'
               registers, spills and shared-memory adds (ATOMS.ADD);
  k1           the float histogram kernel vs its plain PyTorch version at
               the compact path's shapes (the root window of the packed
               working rows, a child window, a ragged tail at 256 bins),
               and a dynamic-range case held without the absolute term,
               4,500 features of 256 bins, and a grid of one block over
               2^20 + 4,099 rows (17 flushes of its words); every case,
               and the device-window entry's, launched 20
               times on one input: the same bits each time (fails
               otherwise), and the count of slots unequal to the plain
               version's (an f64 sum rounded once);
  k2           the same kernel over column-major (F, N) codes, the masked
               strategy's layout, at 60,000 and at the full row count (20
               launches each, the same bits); then
               the split key's column entry (the masked core's decode and
               row update) vs its plain version, bit-exact in leaf ids and
               the left operand: 60,000 rows, the full row count and a
               ragged count, uint8 and 16-bit codes, f32, int8 and int32
               operands, and a GO = 0 descriptor that changes nothing;
               and categorical descriptors (a row left iff its bin's bit
               is set) at 60,000 rows, uint8 and 16-bit codes, W = 2 and
               8 bitset words, every bit set, none and random bits;
  k3           the exact integer histogram kernel vs its plain version,
               bit-exact: packed quantized rows (int8 operand), a child
               window, a ragged tail at 256 bins with an int32 operand,
               K3t over (F, N) codes at 60,000 rows, and a flush probe
               (one row per thread of the grid); then the packed-row entry
               (the operand built in the kernel, as the compact core
               calls it) at the root and the child windows of 250k, 62k,
               16k, 4k and 1k rows, beside the two-step it replaces
               (gh_operand_scaled, then K3) on this tree and the parent's;
  k4           the stable partition kernel vs its plain version, bit-exact:
               the root split window (D = 11), a ragged 3-key window, the
               quantized rows (D = 9), the compact core's child windows
               (250k, 62k, 16k, 4k and 1k rows at D = 11 and D = 9), wide
               rows (D = 260) and one tile more than the grid holds; then
               the device-window entries of the compact core's device loop
               (the window read from the split descriptor), bit-exact or,
               for K1, within K1's bar: the split-key kernel, K4's, K3's
               and K1's window entries at the root and the child windows;
               the split-key kernel on categorical descriptors over the
               main path's 8-bit rows and random 16-bit rows, W = 2 and 8
               bitset words, every bit set, none and random bits;
               then the split key's router entry (the out-of-bag rows'
               leaves from a tree's records), bit-exact: the records of a
               255-leaf tree over the main path's 8-bit codes, random
               records over 4-bit and 16-bit codes, M = 200,000 and a
               ragged M, k = L - 1 and k = 0, and with half the features
               categorical (bitset words beside the records, W = 2 and 8);
  train        lightgbm_tpu_torch.train on a Higgs-shaped 1,000,000 x 28
               binary task (num_leaves=255, max_bin=63, learning_rate=0.1,
               min_data_in_leaf=20) for 10 rounds on the compact strategy,
               the main path: the fused iteration, whose tree grows in the
               device loop (one captured split step replayed 254 times):
               launches of every kernel during that run, per tree and per
               captured step, the partition kernel's rows and its byte
               bound per tree, host syncs per tree, time, peak memory,
               held-out AUC, a model-text round trip, and the training
               scores against predict on the training rows (apart from
               those an f32 threshold of predict moves); beside it
               HOST_ROUNDS (3) rounds on the host loop (the generic
               iteration and grow_tree_compact_core, one host sync per
               split): its time, launches and AUC, which the main path's
               model of as many rounds must be within 0.001 of;
  profile      one more float boosting iteration under torch.profiler on
               each loop, the partition kernel's and the split-key kernel's
               launches and device time summed over their kernels (named
               from the libraries' SASS); with --parent-src first one
               host-loop iteration on OLD's partition kernel;
  booster_api  the train phase's Booster and the 100,000 held-out rows
               through the Booster and Dataset surface: pred_leaf on the
               held-out and the training rows (ms, peak device memory;
               equal to the CPU's walk of the same model text, leaf values
               summing to the raw score within 1e-5); pred_early_stop at
               freq 2, margin 2.0 (ms, the share of rows stopped; within
               1e-5 of the CPU's, the same rows stopped but those whose
               margin lies within 1e-5 of the bound); pred_contrib on 20
               rows off the f32 thresholds and the first 3 trees (s per
               row per tree; each row sums to its raw score within 1e-5);
               refit on the held-out rows at decay 0.9 (the stats
               dispatch's device ms, the host finish's ms, AUC before and
               after; one dispatch, leaves within rtol 1e-5 of the host
               loop's); the held-out rows as CSV through Dataset(path) and
               predict(path) (which parser ran, s; codes equal to those
               of the file's rows as numpy reads them, labels and
               predictions equal to the array's); pickle and
               model_from_string round trips (equal predictions), the
               device bytes before and after free_dataset (must fall);
               then LGBMClassifier (--rounds estimators, the higgs-1m
               params) fit on the card, the main path (the device loop's
               kernels launched), its predict_proba within 1e-6 of the
               train phase's Booster (K1 / K2 repeat bit for bit);
  serve        online serving on the card: a SERVE_ROUNDS (100) round
               model of the train phase's data and params (100 trees pad
               to 128) in a ModelRegistry warmed at 1, 16, 256 and 4096
               rows (each entry's build ms); PredictorCache.predict within
               1e-6 of Booster.predict on the 100,000 held-out rows in
               slices of 4096, and on the first 2,048 / 512 in slices of
               16, 100, 256 / 1, 7; no entry built by requests of 1..256
               rows, nor by the swap to the model's refit (decay 0.9 on
               the held-out rows, the same family key), which answers
               with its own predictions; p50 / p99 ms over 100 calls, rows
               per s and device kernels and copies per flush
               (torch.profiler over 20 calls) at 1, 16, 256 and 4096 rows;
               the HTTP server (max_batch 256, max_delay_ms 2) under 8
               keep-alive clients for 5 s at 1 and at 64 rows per request
               (requests per s,
               p50 / p99 from the client and from /stats, rows per flush,
               no entry built, /healthz 200, /metrics, /drain); the canary
               router at weight 0.2 over 500 un-versioned requests (the
               canary answers exactly 100, every answer its version's
               prediction), a forced promotion and demotion in
               /router/audit, shadow mode (the stable answers, the canary
               gets every mirrored copy); `python -m lightgbm_tpu_torch
               task=serve` as a subprocess: one /predict equal to the
               in-process answer, /drain, exit 0 on SIGINT; no hand kernel
               launched on the serving path;
  train_quant  the same data and parameters with quantized_grad (grad_bits
               8): K3 / K1 / K4 launches, time, peak memory, and held-out
               AUC > 0.7 and within 0.005 of the float run's; beside it the
               host loop and the generic iteration on the device loop
               (HOST_ROUNDS rounds each), whose trees and AUC must equal
               (the same trees from the same gradients); one more
               device-loop iteration profiled, K3's kernels summed (with
               --parent-src also one host-loop iteration, and one on the
               parent's two-step);
  loop         20,000-row trees (31 leaves) of each strategy grown by its
               captured device loop on the card, by the same step run
               eagerly on the CPU (the plain versions) and by its host
               loop on the card, float and quantized, from the same
               gradients: against the CPU equal leaf, feature and count
               columns and leaf ids, f32 columns within 1e-4; quantized,
               records equal to the host loop's bit for bit; the capture's
               time and launches per step, and a tree grown under the sync
               debug mode "error"; then the compact core's bag carry (a
               14,000-row bag of the 20,000 rows), float and quantized,
               against the same step on the CPU from the same bag, every
               row's leaf equal (the router's for the out-of-bag rows),
               and one bagged tree under the sync debug mode "error";
  train_masked 60,000 x 28 (the masked strategy, which auto picks below
               65,536 rows), float and quantized, 10 rounds on the fused
               iteration, whose tree grows in the masked core's device loop
               (the column split key and K2 / K3t replayed 254 times per
               tree): launches per tree and per captured step, host syncs
               per tree (1), capture time, time, steady s per iteration,
               peak memory and held-out AUC; beside it HOST_ROUNDS rounds
               on the masked host loop (grow_tree, one host sync per
               split), whose float AUC the device loop's model of as many
               rounds must be within 0.001 of; quantized, also the
               generic iteration on the device loop (HOST_ROUNDS rounds),
               whose trees must equal the host loop's; one more
               device-loop iteration profiled;
  train_bag    lightgbm_tpu_torch.train with row sampling: the 1M-row task
               with bagging_fraction 0.8 (bagging_freq 1), float and
               quantized, and with GOSS (top_rate 0.2, other_rate 0.1; 10
               rounds of warm-up and --rounds / 2 sampled), all on the fused
               iteration (the compact core's bag carry and the router);
               the 60,000-row masked task with the same bagging, float and
               quantized (fused), and with pos/neg bagging 0.5 / 0.5 (the
               generic iteration, a host bag). Per case: time, steady s per
               iteration, host syncs and launches per tree (the router's
               among them), K4's window rows per tree (bag rows), each
               carry's capture time, peak memory, held-out AUC. Fails
               unless 1 host sync per tree, the training scores equal
               predict(raw_score=True) on the training rows within 1e-5,
               the AUC is > 0.7 and at most 0.005 below the unbagged float
               run's on the same data (the train / train_masked phase's,
               else one made here), one router launch per sampled compact
               tree, and GOSS ran both its fused steps;
  train_valid  lightgbm_tpu_torch.train on the train phase's 1M-row task
               with its 100,000 held-out rows as a validation set (binned
               by reference), metric auc and binary_logloss, early stopping
               (5 rounds) and evals_result, on the fused iteration: host
               syncs per tree (1), the validation set's scores (the binned
               walk of each tree) against predict(raw_score=True) within
               1e-5 apart from the rows an f32 threshold moves (counted),
               the recorded last validation AUC against the AUC of those
               scores; steady s per iteration (update and evaluation),
               eval ms per iteration (and one iteration's taken apart:
               each dataset's fetch, each metric) and device fetches per
               iteration,
               beside the train phase's steady s per iteration; the
               validation update's device ms and launches per tree
               (profiled);
  train_objectives
               lightgbm_tpu_torch.train with each objective but binary and
               the multiclass ones (regression, regression_l1, huber,
               fair, quantile, mape, poisson, tweedie, gamma,
               cross_entropy, cross_entropy_lambda) on the train phase's
               rows, 3 rounds each, targets drawn from the generator's
               margin (OBJECTIVE_TARGETS); per objective the iteration
               (fused, or generic with leaf renewal on the host), steady s
               per iteration, host syncs and score fetches per tree, the
               renewal's host ms per tree, launches per tree; fails unless
               the held-out default metric beats the constant model's, the
               scores are finite, and 1 host sync per tree (2 with
               renewal: the leaf map);
  train_multiclass
               bench.py's 5-class variant of the same rows, multiclass and
               multiclassova for 5 rounds with the held-out rows as a
               validation set (multi_logloss, multi_error): steady s per
               iteration (5 trees), captures (1 per learner), host syncs
               per tree (1), K1 / K4 window launches per iteration; fails
               unless held-out multi_logloss is below the class prior's and
               the class-0 one-vs-rest AUC > 0.7 (bench.py's gate);
  train_boost  the train phase's rows and params with boosting=dart at
               LightGBM's defaults (drop_rate 0.1, skip_drop 0.5, max_drop
               50) and with boosting=rf (bagging_fraction 0.8,
               bagging_freq 1), --rounds rounds each on the generic
               iteration over the compact device loop: steady s per
               iteration, host syncs and launches per tree (RF: the
               router's, one per tree, for the out-of-bag rows), DART's
               drop sets; fails unless held-out AUC > 0.7, the training
               scores equal predict(raw_score=True) within 1e-5 off the
               f32-threshold rows (DART's rescaled trees, RF's running
               average), the model-text round trip is within 1e-6, 1 host
               sync per tree, and DART dropped a tree;
  train_learners
               feature_fraction_bynode 0.5 on the higgs-1m rows (float
               and quantized, the compact device loop) and on the
               60,000-row masked task, and histogram_pool_size 2 MB (97 LRU
               slots for 255 leaves) on higgs-1m, float and quantized,
               --rounds rounds each on the fused iteration beside the
               dense pool's run of the same settings (the train /
               train_quant phases' when they ran, else made here): steady
               s per iteration, host syncs per tree (1), launches per
               captured step, the by-node runs' device launches per
               iteration against the plain run's, LRU misses per tree and
               the miss pass's launches and device ms per iteration
               (profiled against the dense run), AUC > 0.7 and, LRU,
               within 0.001 of the dense pool's; then the host-loop serial
               learner (HOST_ROUNDS rounds) with a forced-splits JSON in a
               temporary file (feature 0 at its median at the root,
               features 1 and 2 at theirs below), float (K1's host-int
               entry) and quantized (K3's operand entry), and with
               cegb_penalty_split at rising percentiles (50, 75, 90) of
               the float run's last tree's gain per row until it prunes:
               s per iteration, host
               syncs and launches per tree; fails unless the forced splits
               top every tree, AUC > 0.7 (not for CEGB, recorded), and
               CEGB grows fewer leaves;
  train_stream out of core on the higgs-1m rows and params
               (strategy=chunk, CH = 65,536 rows; its device loop is the
               compact core's split step, and the chunk core,
               grow_tree_chunk_core, its host-loop oracle): one tree from
               exact gradients (multiples of 0.25, unit hessians) whose
               device-loop records must equal the chunk host loop's and
               the compact strategy's; strategy=chunk for STREAM_ROUNDS
               (5) rounds on the fused iteration (steady s per iteration,
               launches and device ms of a profiled iteration, the
               launches per split it adds over compact's step; AUC > 0.7
               and within 0.001 of the compact model of as many rounds);
               stream_mode=chunked for the same rounds, whose model text
               must equal the resident chunk strategy's on the same
               (generic) iteration, with H2D
               bytes per iteration N x CW x 4, the overlap fraction and
               stream wait, device_data_bytes and peak device memory
               beside the resident run's (the streamed peak lower by at
               least the resident codes' bytes); quantized (grad_bits 8),
               QUANT_STREAM_ROUNDS (2) rounds streamed against resident,
               equal model text; stream_mode=goss (boosting=goss,
               learning_rate 0.5: 3 of the 5 rounds sampled) twice, equal
               model text, AUC > 0.7, H2D bytes against chunked and the
               working set's hits (> 0, the router launched); then
               TWO_ROUND_ROWS (200,000) rows as CSV loaded with
               two_round=true and in memory (numpy's parse): equal bins
               and 2 rounds of equal model text, each load's s;
  resilience   checkpoints, resume, the sentries and telemetry on the
               higgs-1m rows and params, RES_ROUNDS (10) rounds: the same
               run with bagging 0.8 twice, equal model text (determinism);
               a child process (the Dataset from save_binary) checkpoints
               every 5 rounds and dies by kill_rank@iter=7 (exit 137),
               the resume here to 10 rounds writes the uninterrupted
               model text; a preempt@iter=4 child exits 76 and
               num_boost_round=None finishes its emergency checkpoint,
               equal too; quantized (grad_bits 8) in one process, equal;
               the checkpoint's bytes, save and restore ms;
               nan_grad@iter=3,frac=0.01 under raise (names iteration 3),
               skip_iter (9 trees) and rollback (AUC > 0.7 and within
               0.005 of the clean run); a NaN put into the training
               scores trips the fused iteration's guard (nothing
               committed, 1 host sync); telemetry off, summary and trace:
               steady s per iteration (recorded), 1 host sync per tree and
               equal model text in every mode, the phase shares, the
               trace's spans, and a torch.profiler trace under
               LGBM_TPU_XLA_TRACE naming K1's and K4's kernels. Its
               launches count apart from the main path's
               (resilience_launches in the kernels line);
  train_cat    bench.py's categorical variant (the last 8 of the 28
               columns hold 64 categories each, per-category effects on
               the margin) with those columns as categorical_feature:
               higgs-1m-cat on the fused iteration of the compact device
               loop (1 host sync per tree, 1 capture, held-out AUC > 0.7,
               model-text round trip within 1e-6, training scores equal to
               predict), the same rows with those columns numerical (the
               categorical AUC must be higher), the compact host loop for
               HOST_ROUNDS rounds (AUC within 0.001 of the device loop's
               model of as many rounds), bagging 0.8 (the router on
               categorical records, one launch per tree) and the first
               60,000 rows on the masked device loop, float and quantized
               (the column entry); profiled, with the categorical scan's
               sort and gather kernels per split step named;
  train_rank   bench.py's lambdarank scenario: make_ranking_like(50,000
               queries of 20 documents, 28 features), lambdarank, 255
               leaves, learning_rate 0.1, max_bin 63, min_data_in_leaf 20,
               5,000 held-out queries (seed 4242) as a validation set
               (metric ndcg, eval_at 10), --rounds rounds on the compact
               strategy's fused iteration, float and quantized (grad_bits
               8), and the first 3,000 queries (60,000 rows) float on the
               masked one: steady s per iteration, host syncs and launches
               per tree, peak device memory, the lambdarank gradient's
               device ms, launches and working set at the run's scores,
               the host ndcg's ms per iteration (training and validation),
               one float iteration profiled, the largest leaf value and
               training score (quantized: the gap to float's ndcg@10,
               recorded); fails unless 1 host sync per tree, held-out
               ndcg@10 above the all-zero scores' on the same queries, the
               training scores equal predict within 1e-5 (relative to a
               row's sum of |leaf values| above 1) off the f32-threshold
               rows and the model-text round trip within 1e-6;
  reference    small tasks (20,000 rows, REF_ROUNDS = 3 rounds) trained
               on the card and on the CPU (the plain versions): compact
               float and compact quantized on the device
               loop (the fused iteration) and on the host loop, masked
               float and masked quantized on the device loop. Every run
               gives raw scores within 1e-4 and the same trees; quantized
               runs also equal root histograms and the same trees from
               identical gradients.
               Compact quantized may grow other trees only where its
               witness shows stored integers that differ between the
               devices from the same scores. Then bagged (0.7) and GOSS
               (learning_rate 0.5: from the third tree sampled) runs of
               each strategy,
               float and quantized, held to the same trees and raw scores
               within 1e-4, or, where a tied threshold sends out-of-bag
               rows each device's way, within 1e-4 on the other rows (at
               most 2 % so separated). Then every objective of
               train_objectives on compact float, and 3-class multiclass
               (OBJ_REF_ROUNDS = 2 rounds each)
               on compact and masked float and compact quantized: the same
               trees, raw scores within 1e-5 (fair and gamma, whose leaves
               divide cancelling gradient sums by small hessian sums and
               so carry the split scan's f32 order, within 4e-4, each
               device's first tree within 64 f32 roundings of the root's
               sums of the exact f64 leaf values; quantized 1e-4, with
               the binary rows' witness
               exemption); and the two
               card-vs-plain
               float cases that flaked before K1 / K2 summed in a fixed
               order, 3 runs each, all of which must agree; then
               categorical runs (compact float and quantized, masked
               float, compact bagged) held to the same trees as functions
               of the training rows (a tied categorical cut may name
               either side left on each device) and raw scores within
               1e-4. Then lambdarank on 1,000 queries of 20 documents
               (compact float, masked float, compact quantized;
               OBJ_REF_ROUNDS rounds) and DART and RF on the binary task
               (compact float, REF_ROUNDS rounds): the same trees as
               functions of the training rows, raw scores within 1e-5
               (quantized 1e-4, or other scores and trees only where the
               witness counts stored integers that differ and both devices
               grow the same trees from the CPU's gradients), DART's drop
               sets equal. Then this slice's learners at 60,000 rows, 15
               leaves, REF_ROUNDS rounds: by-node sampling on the compact
               and the masked device loops, the LRU pool (8 slots) on
               compact quantized, the serial learner float and quantized:
               the same trees and raw scores within 1e-4 (quantized: or
               the witness).
  fleet        the fleet and the continual loop on the card (the last
               phase on the 1M-row Dataset: it appends rows to it), after
               resilience in a full call: the serve phase's
               model (or FLEET_ROUNDS = 20 rounds when serve is not in the
               call) with its .drift.json and .transform.json sidecars;
               two `task=serve` replicas following a fleet manifest
               (weights 1 and 3, serve_export_cache=auto, replica A
               publishing its router's transitions), a `task=gateway` on
               the manifest and `task=continual` as subprocesses, started
               first; in process, a ServingApp on the card driven by
               ContinualLoop.step() with a fake clock (policy auto):
               drifted traffic fires drift_psi, episode 1 refits, labelled
               POST /feedback promotes it, a second fire escalates to
               appending 100,000 drifted rows and a 10-round continuation
               from the stable model, whose K1 / K4 / split-key launches
               are counted and whose model text must equal
               engine.train(init_model=stable) run directly; the events
               in the JAX package's order; then 2,048 held-out rows
               through the gateway as JSON (within 1e-6 of
               Booster.predict) and as CSV (equal to the JSON answers),
               400 one-row requests split exactly 100 / 300, a canary
               rollout through the manifest (each rev applied once, the
               promotion on A reaching B within two polls, both audit
               logs), a rolling restart of B under traffic (out of the
               rotation by its manifest weight, drained, stopped,
               restarted on the same entry cache: 0 client errors, the
               retries counted, hits = models x warm buckets, 0 entries
               built; time to ready beside a restart on a fresh cache),
               and `task=continual` answering /healthz and exiting 0;
  capi         the C ABI on the card: lib_lightgbm_tpu_torch.so (g++,
               built at first use) driven by ctypes in this process on the
               higgs-1m rows and params, --rounds rounds
               (DatasetCreateFromMat, SetField, BoosterCreate,
               UpdateOneIter, GetEval, PredictForMat on the 100,000
               held-out rows, SaveModelToString): model text byte-equal
               to engine.train's with the same params in the same call,
               predictions within 1e-6 of Booster.predict, K1's and K4's
               window entries and the split key launched (their counts go
               into the kernels line as capi_launches);
  dp           tree_learner=data: (a) world size 1 under NCCL in this
               process (a TCP store on localhost), --rounds rounds on the
               same rows: model text byte-equal to the serial compact run
               (the capi phase's engine.train) but for its tree_learner
               line, one host sync per tree, the split step captured as a
               CUDA graph with its all-reduce inside, collectives and
               their bytes per tree, one all-reduce's time (CUDA events)
               and s per iteration beside the serial run's, K1 / K4 /
               split-key launches into the kernels line as dp_launches;
               (b) two ranks on the one card as subprocesses under gloo on
               CUDA tensors (psum mode, uncaptured), DP_GLOO_ROUNDS rounds,
               each rank 500,000 rows: byte-equal model text, trees equal
               to the serial run's structurally as
               tests/test_parallel.py's assert_trees_structurally_equal
               holds them (split feature and counts; f32 gains within 1e-4
               relative, 2e-5 where a threshold differs), each model's
               partitions summed again in f64 giving gains within 2e-5
               relative of each other (the witness that the f32 gains
               part by rounding: each model's f32 gap to its own f64
               gains is reported), held-out AUC > 0.7 and within 0.001
               of the serial run's of as many rounds, s per iteration and
               the all-reduce's time per tree;
Kernel times: `ms` is the mean over repeated launches between CUDA
events, the host enqueuing as it goes (on a small launch this reads the
wrapper's launch rate); `device_ms` puts a sleep kernel in front, which
holds the stream until every launch is enqueued, so it reads the device
alone.
A run of every phase (the default) then prints the card's name and power
limit and the kernels line; every run ends with {"ok": true, "device":
{...}}. A phase that needs another's result (profile and train_quant need
the float train run) runs it without printing it. Any failed check exits
non-zero.

The script needs the lightgbm_tpu_torch package beside it and a CUDA
card; it imports nothing of JAX.
"""
import argparse
import contextlib
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
# the integer adds of K3 run on the same CUDA cores; the published f32
# rate is their bound here (int32 units are not faster)

# ~50 ms of GPU clock cycles: longer than the host takes to enqueue one
# timed run of launches
SLEEP_CYCLES = 100_000_000

PHASES = ("device", "k1", "k2", "k3", "k4", "train", "profile",
          "booster_api", "serve", "train_quant", "train_masked",
          "train_bag", "train_valid",
          "train_objectives", "train_multiclass", "train_boost",
          "train_learners", "train_stream", "resilience", "fleet",
          "capi", "dp", "train_cat", "train_rank", "loop", "reference")

# bench.py's categorical variant (BENCH_CAT_FEATURES=8, BENCH_CAT_CARD=64)
CAT_FEATURES = 8
CAT_CARD = 64
# rounds of the host loops beside the device loops (train, train_quant,
# train_masked, train_cat): the AUC gates compare the device loop's
# model of as many rounds
HOST_ROUNDS = 3
# rounds of the reference phase's card-vs-CPU runs, and of its runs of
# every objective
REF_ROUNDS = 3
OBJ_REF_ROUNDS = 2


T0 = time.time()


def emit(obj):
    """One JSON line on stdout; a phase's line also notes the seconds
    since start on stderr."""
    print(json.dumps(obj), flush=True)
    if "phase" in obj:
        print("chip_smoke: %s done at %.1f s" % (obj["phase"],
                                                  time.time() - T0),
              file=sys.stderr, flush=True)


def fail(msg):
    print("chip_smoke: FAILED: %s" % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def higgs_margin(x, w):
    """The generator's noiseless margin of rows x under ground truth w."""
    return x @ w * 0.3 + 0.2 * x[:, 0] * x[:, 1] - 0.1 * x[:, 2] ** 2


def make_higgs_like(n, f, seed=17, w=None, n_classes=1, n_cat=0,
                    card=CAT_CARD):
    """Seeded Higgs-shaped binary task: informative and noise features,
    moderately separable classes (the repo benchmark's generator,
    bench.py's make_higgs_like, draw for draw). Pass `w` to draw another
    sample from the same ground truth. n_classes > 1: bench.py's
    multiclass variant, the noisy margin's quantiles cut into balanced
    classes (class 0 = lowest margin), from the same draws. n_cat > 0:
    bench.py's categorical variant, the last n_cat columns replaced by
    categories 0..card-1 with per-category effects randn(card) * 0.5 on
    the margin; `w` is then the pair (numerical weights, effect tables)
    it returns."""
    r = np.random.RandomState(seed)
    x = r.randn(n, f).astype(np.float32)
    if w is None:
        w = r.randn(f) * (r.rand(f) > 0.4)
        if n_cat:
            w = (w, [r.randn(card) * 0.5 for _ in range(n_cat)])
    w_num, tables = w if n_cat else (w, [])
    if tables:
        # the categorical columns' Gaussian draws do not reach the label
        w_num = w_num.copy()
        w_num[f - len(tables):] = 0.0
    margin = higgs_margin(x, w_num)
    for j, table in enumerate(tables):
        cats = r.randint(0, card, n)
        x[:, f - len(tables) + j] = cats
        margin += table[cats]
    noisy = margin + r.randn(n) * 1.5
    if n_classes > 1:
        edges = np.quantile(noisy, np.linspace(0, 1, n_classes + 1)[1:-1])
        return x, np.searchsorted(edges, noisy).astype(np.float64), w
    return x, (noisy > 0).astype(np.float64), w


def auc(y, s):
    """Tie-aware rank AUC."""
    order = np.argsort(s, kind="mergesort")
    _, inv, counts = np.unique(s[order], return_inverse=True,
                               return_counts=True)
    avg = np.cumsum(counts) - (counts - 1) / 2.0
    ranks = np.empty(len(s))
    ranks[order] = avg[inv]
    npos = float(y.sum())
    nneg = len(y) - npos
    return float((ranks[y > 0].sum() - npos * (npos + 1) / 2)
                 / (npos * nneg))


def time_ms(torch, fn, reps, warmup=2, hold=False):
    """Mean ms per call of fn over reps calls, between CUDA events around
    the calls as the host enqueues them: on a small launch this reads the
    host's launch rate (a wrapper's Python costs tens of microseconds).
    hold puts a sleep kernel in front, which holds the stream while the
    host enqueues the calls, so that the events time the device alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def errors(got, want):
    d = (got - want).abs()
    rel = d / want.abs().clamp(min=1e-3)
    return float(d.max()), float(rel.max())


_SASS_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)")


def _cuobjdump(nvcc_path):
    tool = os.path.join(os.path.dirname(nvcc_path), "cuobjdump") \
        if nvcc_path else ""
    if not os.path.isfile(tool):
        tool = shutil.which("cuobjdump") or ""
    return tool


def _kernel_name(demangled):
    """A demangled kernel signature without its return type, namespace and
    parameter list (the first "(" outside the template arguments, which
    cu++filt writes with casts such as "(bool)1")."""
    name = re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::", "",
                  demangled)
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            return name[:i]
    return name


def sass_functions(nvcc_path, path):
    """{kernel: {opcode: count}} of the atomic instructions (shared-memory
    ATOMS.*, global ATOM.* / RED.*) of each kernel in one built library's
    SASS, read with cuobjdump -sass from nvcc's toolkit; kernels by their
    demangled names without namespace or arguments; {} where cuobjdump is
    absent."""
    tool = _cuobjdump(nvcc_path)
    if not tool:
        return {}
    filt = os.path.join(os.path.dirname(tool), "cu++filt")
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=120).stdout
    funcs, cur = {}, None
    for ln in text.splitlines():
        m = _SASS_FUNC.search(ln)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        m = _SASS_OP.search(ln)
        if cur is not None and m and m.group(1).startswith(
                ("ATOMS", "ATOM.", "ATOMG", "RED.")):
            cur[m.group(1)] = cur.get(m.group(1), 0) + 1
    names = list(funcs)
    if os.path.isfile(filt) and names:
        dem = subprocess.run([filt], input="\n".join(names),
                             capture_output=True, text=True,
                             timeout=60).stdout.splitlines()
        if len(dem) == len(names):
            funcs = {_kernel_name(d): funcs[n] for n, d in zip(names, dem)}
    return funcs


def sass_atomics(nvcc_path, libs):
    """{library: sass_functions} for each built library; "not measured"
    where cuobjdump is absent."""
    if not _cuobjdump(nvcc_path):
        return "not measured: no cuobjdump"
    return {name: sass_functions(nvcc_path, path)
            for name, path in libs.items()}


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_kernels(text, nvcc_path, pattern):
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from nvcc's
    -Xptxas -v output for the entries whose mangled name contains
    `pattern`, demangled with cu++filt where the toolkit has it."""
    out, cur = {}, None
    for ln in text.splitlines():
        m = _PTXAS_ENTRY.search(ln)
        if m:
            cur = out.setdefault(m.group(1), {}) if pattern in m.group(1) \
                else None
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = _PTXAS_REGS.search(ln)
        if m:
            cur["registers"] = int(m.group(1))
    filt = os.path.join(os.path.dirname(_cuobjdump(nvcc_path)), "cu++filt")
    names = list(out)
    if os.path.isfile(filt) and names:
        dem = subprocess.run([filt], input="\n".join(names),
                             capture_output=True, text=True,
                             timeout=60).stdout.splitlines()
        if len(dem) == len(names):
            out = {_kernel_name(d): out[n] for n, d in zip(names, dem)}
    return out


@contextlib.contextmanager
def parent_k4(torch, k4, lib):
    """Inside, the partition wrapper, and the growth core that imports it
    by name, launch `lib`, another checkout's partition library: through
    the same wrapper where `lib` has this tree's C interface, else through
    a launcher of the three-launch interface (count, scan, scatter) that
    the kernel had before its cooperative form."""
    from lightgbm_tpu_torch.models import device_learner
    from lightgbm_tpu_torch.ops.kernels import build
    if hasattr(lib, "lgbt_partition_max_grid"):
        own = build.load("partition")
        build._libs["partition"] = lib
        try:
            yield
        finally:
            build._libs["partition"] = own
        return
    lib.lgbt_partition_tile_rows.restype = ctypes.c_int
    tile = int(lib.lgbt_partition_tile_rows())
    fn = lib.lgbt_partition_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]

    def launch(win, key3, out=None):
        if out is None:
            out = torch.empty_like(win)
        w, d = win.shape
        if w:
            scratch = torch.empty(6 * -(-w // tile), dtype=torch.int32,
                                  device=win.device)
            build.check(fn(win.data_ptr(), key3.data_ptr(), w, d,
                           scratch.data_ptr(), out.data_ptr(),
                           torch.cuda.current_stream(win.device)
                           .cuda_stream), "parent partition kernel launch")
        return out

    saved = (k4.stable_partition3, device_learner.stable_partition3)
    k4.stable_partition3 = device_learner.stable_partition3 = launch
    try:
        yield
    finally:
        k4.stable_partition3, device_learner.stable_partition3 = saved


def parent_histogram(src, lib):
    """The histogram wrapper module of another checkout (its
    lightgbm_tpu_torch imported as a package of its own,
    parent_lightgbm_tpu_torch) launching `lib`, that checkout's built
    histogram library: the parent's kernels as its own wrapper launched
    them (its grid, its output)."""
    import importlib.util
    pkg = os.path.join(src, "lightgbm_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_lightgbm_tpu_torch", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    importlib.import_module(spec.name + ".ops.kernels.build")._libs[
        "histogram"] = lib
    return importlib.import_module(spec.name + ".ops.kernels.histogram")


@contextlib.contextmanager
def parent_two_step(k1, pk1):
    """Inside, the compact core builds its quantized histograms as the
    parent did: the (W, 3) operand by gh_operand_scaled, then K3 through
    `pk1`, the parent's histogram wrapper."""
    from lightgbm_tpu_torch.models import device_learner
    from lightgbm_tpu_torch.ops import quantize as quant_ops
    own = device_learner.build_histogram_quantized_rows

    def two_step(rows, cw, c_cols, item_bits, r_g, r_h, qcap_op, grad_bits,
                 num_bins):
        ghq = quant_ops.gh_operand_scaled(rows[:, cw], None, grad_bits,
                                          qcap_op, r_g, r_h)
        return pk1.build_histogram_quantized(
            k1.packed_codes(rows, cw, c_cols, item_bits), ghq, num_bins)

    device_learner.build_histogram_quantized_rows = two_step
    try:
        yield
    finally:
        device_learner.build_histogram_quantized_rows = own


@contextlib.contextmanager
def host_loop(torch, generic_only=False):
    """Inside, training takes the generic iteration and, unless
    generic_only, grows each tree with the strategy's host loop
    (grow_tree_compact_core or grow_tree: one host sync per split, the
    compact core on the kernels' host-int entries) instead of its device
    loop: the path of the port before the device loops, held beside
    them."""
    from lightgbm_tpu_torch.models import device_learner as dl
    from lightgbm_tpu_torch.models.gbdt import GBDT
    from lightgbm_tpu_torch.utils.random import prng_key
    own = (GBDT._fused_eligible, dl.DeviceTreeLearner.grow)

    def grow(self, grad, hess, iter_seed=0, bag_indices=None):
        if bag_indices is not None:
            raise RuntimeError("the host loops grow on every row")
        grad, hess = grad.float(), hess.float()
        mask = self._base_mask(iter_seed)
        mask = self._ones_mask if mask is None else mask
        if self.strategy == "masked":
            gh, scale3 = self.masked_operand(grad, hess, iter_seed)
            out = dl.grow_tree(self.codes_t, gh, mask, self.meta,
                               scale3=scale3, stats=self.stats,
                               rng_key=prng_key(iter_seed),
                               **self._statics())
        else:
            quant = None
            if self.quant_bits:
                data, quant = self.quant_working_buffer(
                    grad, hess, prng_key(iter_seed))
            else:
                data = self.working_buffer(grad, hess)
            out = dl.grow_tree_compact_core(
                data, torch.empty_like(data), mask, self.meta,
                c_cols=self.c_cols, item_bits=self.item_bits, quant=quant,
                stats=self.stats, rng_key=prng_key(iter_seed),
                **self._statics())
        # with categorical features, the records' bitsets follow
        self.last_rec_cat = out[3] if len(out) > 3 else None
        return out[:3]

    GBDT._fused_eligible = lambda self: False
    if not generic_only:
        dl.DeviceTreeLearner.grow = grow
    try:
        yield
    finally:
        GBDT._fused_eligible, dl.DeviceTreeLearner.grow = own


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of phases to run (default: all): "
                    + ",".join(PHASES))
    ap.add_argument("--parent-src", default=None, metavar="DIR",
                    help="another checkout of the repo: its "
                    "csrc/histogram.cu and csrc/partition.cu are built and "
                    "timed beside every case of the k1, k2, k3 and k4 "
                    "phases, and profiled with the partition kernel")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown or not phases:
        ap.error("unknown phases %s; choose from %s"
                 % (unknown, ",".join(PHASES)))
    run = set(phases)
    every = run == set(PHASES)

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import lightgbm_tpu_torch as lgb
        from lightgbm_tpu_torch import convert
        from lightgbm_tpu_torch.ops.kernels import build
        from lightgbm_tpu_torch.ops.kernels import histogram as k1
        from lightgbm_tpu_torch.ops.kernels import partition as k4
        from lightgbm_tpu_torch.ops.kernels import split_key as kkey
    except ImportError as e:
        fail("lightgbm_tpu_torch not importable beside chip_smoke.py: %s"
             % e)
    dev = torch.device("cuda")

    # ---- device + build -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "not measured"
    t0 = time.time()
    parent_builds = {}
    if args.parent_src:
        os.makedirs(build.build_dir(), exist_ok=True)
        for name in ("histogram", "partition"):
            lib = os.path.join(build.build_dir(), "libparent_%s_%d.so"
                               % (name, os.getpid()))
            parent_builds[name] = (lib, subprocess.Popen(
                [build.nvcc()] + build.FLAGS + ["-o", lib, os.path.join(
                    args.parent_src, "lightgbm_tpu_torch", "csrc",
                    name + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    log = build.build_all(verbose=True)
    parents = {}
    for name, (lib, proc) in parent_builds.items():
        text, _ = proc.communicate()
        if proc.returncode:
            fail("nvcc failed for --parent-src's %s.cu:\n%s" % (name, text))
        parents[name] = ctypes.CDLL(lib)
    if parents:
        parents["histogram_wrapper"] = parent_histogram(
            args.parent_src, parents["histogram"])
    build_s = time.time() - t0
    if "device" in run:
        ptxas = {name: [ln.strip() for ln in text.splitlines()
                        if "registers" in ln or "Compiling entry" in ln
                        or "spill" in ln]
                 for name, text in log.items()}
        atomics = sass_atomics(build.nvcc(), {n: build.library_path(n)
                                              for n in build.SOURCES})
        # the integer kernels: registers, spills and shared-memory adds
        int_kernels = {}
        for kind in ("hist_int_kernel", "hist_rows_kernel"):
            for name, info in ptxas_kernels(log.get("histogram", ""),
                                            build.nvcc(), kind).items():
                sass = atomics.get("histogram", {}).get(name, {}) \
                    if isinstance(atomics, dict) else {}
                int_kernels[name] = dict(
                    info, atoms_add=sass.get("ATOMS.ADD", "not measured"))
        # the router's records staged per block and pass (csrc/
        # split_key.cu: kRecChunk, kRouteSmem, a 28-byte Split and a leaf
        # id per record, 4 bytes per bitset word), beside the card's
        # shared memory per block
        props = torch.cuda.get_device_properties(0)
        staging = {}
        for n_words in (0, 2, 8, 32):
            per_rec = 28 + 4 + 4 * n_words
            chunk = min(256, (48 * 1024) // per_rec)
            staging["W=%d" % n_words] = {"records_per_pass": chunk,
                                         "bytes": chunk * per_rec}
        staging["card_shared_bytes_per_block"] = getattr(
            props, "shared_memory_per_block", "not measured")
        emit({"phase": "device", "nvidia_smi": smi_line,
              "router_staging": staging,
              "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": round(build_s, 2),
              "ptxas": ptxas, "sass_atomics": atomics,
              "int_kernels": int_kernels or "not measured: no ptxas "
                                            "output (library cached)"})
    # the partition kernel's kernels and K3's (the integer histogram
    # kernels) by name, for the profiles
    k4_names = sorted(sass_functions(build.nvcc(),
                                     build.library_path("partition")))
    parent_k4_names = sorted(sass_functions(
        build.nvcc(), parent_builds["partition"][0])) if parents else []

    def int_hist_names(path):
        # the integer kernels: every instantiation but the float one
        return sorted(n for n in sass_functions(build.nvcc(), path)
                      if n.startswith("hist_") and "fixed" not in n)
    k3_names = int_hist_names(build.library_path("histogram"))
    key_names = sorted(sass_functions(build.nvcc(),
                                      build.library_path("split_key")))
    # K1 / K2: the float kernels of the histogram library
    float_hist_names = sorted(
        n for n in sass_functions(build.nvcc(),
                                  build.library_path("histogram"))
        if n.startswith("hist_fixed"))
    parent_k3_names = int_hist_names(parent_builds["histogram"][0]) \
        if parents else []

    # ---- data (built once, for the phases that need it) -----------------
    # auto picks the growth strategy by row count (compact at 1M rows,
    # masked at 60,000); the reference phase forces each in turn
    os.environ.pop("LGBM_TPU_STRATEGY", None)
    f = 28
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "verbosity": -1}
    need_float = bool(run & {"train", "profile", "booster_api",
                             "train_quant"})
    need_data = need_float or bool(run & {
        "k1", "k2", "k3", "k4", "serve", "train_bag", "train_valid",
        "train_objectives", "train_multiclass", "train_boost",
        "train_learners", "train_stream", "resilience", "fleet"})
    t0 = time.time()
    x, y, w_true = make_higgs_like(args.rows, f)
    xv, yv, _ = make_higgs_like(100_000, f, seed=4242, w=w_true)
    if need_data:
        ds = lgb.Dataset(x, y, params=params)
        ds.construct()
    data_s = time.time() - t0
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.models.device_learner import (
        R_DLEFT, R_FEAT, R_LCNT, R_LEAF, R_RCNT, R_THR, DeviceTreeLearner,
        _quant_prepare)
    from lightgbm_tpu_torch.ops import quantize as quant_ops
    from lightgbm_tpu_torch.utils.random import prng_key

    kernel_rows = {}
    if run & {"k1", "k2", "k3", "k4"}:
        kernel_rows = kernel_phases(
            torch, dev, args, run, k1, k4, build, ds, params, Config,
            DeviceTreeLearner, quant_ops, prng_key, parents)

    # every kernel entry's launch count: (module, attribute); the device
    # loop's window entries and the split key count apart from the
    # host-int entries
    counters = {"k1": (k1, "launches"), "k2": (k1, "launches_t"),
                "k3": (k1, "launches_q"), "k3t": (k1, "launches_qt"),
                "k4": (k4, "launches"), "k1_win": (k1, "launches_win"),
                "k3_win": (k1, "launches_qwin"),
                "k4_win": (k4, "launches_win"),
                "split_key": (kkey, "launches"),
                "split_key_col": (kkey, "launches_col"),
                "route": (kkey, "launches_route"),
                "k4_rows": (k4, "rows"), "k4_rows_win": (k4, "rows_win")}

    def reset_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts():
        return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}

    def k4_path(b, counts):
        """The partition kernel over a run (either entry): rows and
        launches per tree, and the byte bound of its windows per tree, sum
        W * (8D + 4) bytes."""
        lr = b._gbdt.learner
        d = lr.codes_pack.shape[1] + (2 if lr.quant_bits else 4)
        trees = max(b.num_trees(), 1)
        rows = counts["k4_rows"] + counts["k4_rows_win"]
        return {"D": d, "launches_per_tree":
                (counts["k4"] + counts["k4_win"]) / trees,
                "rows_per_tree": rows / trees,
                "bound_ms_per_tree": bound(rows * (8 * d + 4) / trees,
                                           0)[0]}

    def timed_train(p, dset, loop="device", rounds=None):
        """Train from zeroed launch counts on the device loop (the fused
        iteration), the host loop, or the generic iteration over the
        device loop, for `rounds` (default --rounds) rounds; (booster,
        counts, seconds, peak device bytes)."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.time()
        with on_loop(loop):
            b = lgb.train(p, dset, num_boost_round=rounds or args.rounds)
        torch.cuda.synchronize()
        secs = time.time() - t1
        return b, read_counts(), secs, int(torch.cuda.max_memory_allocated())

    def on_loop(loop):
        return {"device": contextlib.nullcontext, "host": lambda: host_loop(
            torch), "generic": lambda: host_loop(torch, generic_only=True)
        }[loop]()

    def growth(b, counts, secs):
        """How a run's trees grew: host syncs, splits and kernel launches
        per tree, and the captured split step of the device loop."""
        lr = b._gbdt.learner
        trees = max(lr.stats.trees, 1)
        out = {"host_syncs_per_tree": lr.stats.host_syncs / trees,
               "splits_per_tree": lr.stats.splits / trees,
               "launches_per_tree": {k: v / trees for k, v in counts.items()
                                     if v and not k.endswith("rows")
                                     and not k.endswith("rows_win")},
               "s_per_iter_in_train": secs / max(b.current_iteration(), 1)}
        loop = getattr(lr, "_loop", None)        # none: the serial learner
        if loop is not None and loop.graph is not None:
            out["captured_step_launches"] = {
                k.rsplit(".", 2)[-2] + "." + k.rsplit(".", 1)[-1]: v
                for k, v in loop.launches_per_step.items()}
            out["replays_per_tree"] = loop.num_steps
            out["capture_s"] = loop.capture_s
        return out

    def steady_s(b):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.time()
            b.update()
            torch.cuda.synchronize()
            times.append(time.time() - t1)
        return float(np.median(times))

    # ---- profile one more iteration ---------------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profile_one(b, k4_kernels=None, k3_kernels=None, named=None):
        """One more boosting iteration of booster `b` under torch.profiler:
        wall, device time and busy share, launches, the top kernels, and
        the partition kernel's and K3's (those named k4_kernels and
        k3_kernels, default this tree's) device time and launches
        summed; with `named` (a regular expression), every kernel whose
        name it finds, with its device ms and launches."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.time()
            b.update()
            torch.cuda.synchronize()
            wall = time.time() - t1
        # device-side events only (kernels, copies): an operator's own
        # entry repeats the time of the kernels it launched
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        total_us = sum(e.self_device_time_total for e in kern)
        top = sorted(kern, key=lambda e: e.self_device_time_total,
                     reverse=True)[:10]

        def summed(names):
            # by base name: the profiler writes template arguments as
            # written in the source, cu++filt with casts
            if not names:
                return "not measured: no kernel names (no cuobjdump)"
            pat = re.compile(r"(?:^|\s|::)(%s)[<(]" % "|".join(
                sorted({re.escape(n.split("<")[0]) for n in names})))
            part = [e for e in kern if pat.search(e.key)]
            return {"kernels": [e.key[:90] for e in part],
                    "device_ms": sum(e.self_device_time_total
                                     for e in part) / 1e3,
                    "launches": sum(e.count for e in part)}
        return {
            "k4": summed(k4_kernels or k4_names),
            "k3": summed(k3_kernels or k3_names),
            "k1": summed(float_hist_names),
            "split_key": summed([n for n in key_names
                                 if not n.startswith("route_rows")]),
            "router": summed([n for n in key_names
                              if n.startswith("route_rows")]),
            "wall_ms": wall * 1e3, "device_ms": total_us / 1e3,
            "device_busy_share": total_us / 1e3 / (wall * 1e3),
            "device_launches": sum(e.count for e in kern),
            "top": [{"name": e.key[:90],
                     "device_ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in top],
            "named": None if named is None else [
                {"name": e.key[:90],
                 "device_ms": e.self_device_time_total / 1e3,
                 "calls": e.count} for e in kern
                if re.search(named, e.key, re.I)]}

    def host_side(p, dset, xh=None, yh=None):
        """The same training on the host loop for HOST_ROUNDS rounds,
        beside the main path (held-out rows xh, yh: default xv, yv)."""
        xh, yh = (xv, yv) if xh is None else (xh, yh)
        hb, hl, hs, hp = timed_train(p, dset, loop="host",
                                     rounds=HOST_ROUNDS)
        # of the timed rounds, before the steady ones
        out = dict(growth(hb, hl, hs), train_s=hs, peak_device_bytes=hp,
                   launches=hl, rounds=HOST_ROUNDS,
                   valid_auc=auc(yh, hb.predict(xh)))
        if hb._gbdt.learner.strategy == "compact":
            out["k4_path"] = k4_path(hb, hl)
        with host_loop(torch):
            out["s_per_iter_steady"] = steady_s(hb)
        return hb, hl, out

    # ---- train: the main path (compact, float) ----------------------------
    launches = qlaunches = host_launches = qhost_launches = None
    valid_auc = train = prof = train_quant = compact_auc5 = None
    if need_float:
        bst, launches, train_s, peak = timed_train(params, ds)
        pv = bst.predict(xv)
        valid_auc = auc(yv, pv)
        text = bst.model_to_string()
        back = convert.booster_from_model_string(text)
        rt_err = float(np.max(np.abs(back.predict(xv, raw_score=True)
                                     - bst.predict(xv, raw_score=True))))
        tdiff = np.abs(bst._gbdt.score_updater.score[0].cpu().numpy()
                       - bst.predict(x, raw_score=True))
        tmoved = f32_threshold_rows(ds._inner, x)
        hbst, host_launches, host = host_side(params, ds)
        # the main path's model of the host loop's rounds, and of the
        # train_stream phase's
        valid_auc_h = auc(yv, bst.predict(xv, num_iteration=HOST_ROUNDS))
        compact_auc5 = auc(yv, bst.predict(xv, num_iteration=STREAM_ROUNDS))
        train = dict({"phase": "train", "rows": args.rows, "features": f,
                      "rounds": args.rounds, "params": params,
                      "strategy": bst._gbdt.learner.strategy,
                      "growth": "device loop, fused iteration",
                      "trees": bst.num_trees(), "launches": launches,
                      "k4_path": k4_path(bst, launches)},
                     **growth(bst, launches, train_s))
        train.update({
            "dataset_s": data_s, "train_s": train_s,
            "s_per_iter_steady": steady_s(bst), "peak_device_bytes": peak,
            "valid_rows": len(yv), "valid_auc": valid_auc,
            "model_text_roundtrip_max_abs": rt_err,
            # the training scores against predict on the training rows:
            # the rows f32 thresholds move, and the others
            "train_score_vs_predict": {
                "f32_threshold_rows": int(tmoved.sum()),
                "their_max_abs": float(np.max(tdiff[tmoved], initial=0.0)),
                "other_rows_max_abs": float(np.max(tdiff[~tmoved]))},
            "host_loop": host,
            "auc_minus_host_loop": valid_auc_h - host["valid_auc"]})
        if "train" in run:
            emit(train)
        if train["strategy"] != "compact":
            fail("the 1M-row run did not take the compact strategy")
        if min(launches[k] for k in ("k1_win", "k4_win", "split_key")) <= 0 \
                or launches["k1"] or launches["k4"]:
            fail("the main path did not go through the device loop's "
                 "kernels (K1's and K4's window entries, the split key): "
                 "%s" % launches)
        if host_launches["k1"] <= 0 or host_launches["k4"] <= 0:
            fail("the host loop did not launch K1 and K4: %s"
                 % host_launches)
        if train["host_syncs_per_tree"] != 1:
            fail("the device loop made %s host syncs per tree"
                 % train["host_syncs_per_tree"])
        if not np.all(np.isfinite(pv)) or pv.shape != (len(yv),):
            fail("predictions are not finite or of the wrong shape")
        if valid_auc <= 0.7 or abs(train["auc_minus_host_loop"]) > 0.001:
            fail("held-out AUC %.5f (want > 0.7), %.5f at %d rounds (want "
                 "within 0.001 of the host loop's %.5f)"
                 % (valid_auc, valid_auc_h, HOST_ROUNDS, host["valid_auc"]))
        if rt_err > 1e-6:
            fail("model-text round trip differs by %g" % rt_err)
        if "profile" in run:
            prof = {"phase": "profile"}
            with host_loop(torch):
                if parents:
                    with parent_k4(torch, k4, parents["partition"]):
                        prof["parent_k4_iteration"] = profile_one(
                            hbst, parent_k4_names)["k4"]
                prof["host_loop"] = profile_one(hbst)
            prof.update(profile_one(bst))
            emit(prof)
        if "booster_api" in run:
            row, problems = booster_api_phase(
                torch, lgb, params, ds, bst, x, y, xv, yv, args.rounds,
                reset_counts, read_counts)
            emit(row)
            if problems:
                fail("booster_api: %s" % "; ".join(problems))
        del bst, back, hbst

    # ---- serve: online serving of a higgs-1m model --------------------------
    fleet_src = None
    if "serve" in run:
        row, problems, sbst = serve_phase(torch, lgb, params, ds, xv, yv,
                                          reset_counts, read_counts)
        emit(row)
        if problems:
            fail("serve: %s" % "; ".join(problems))
        if "fleet" in run:
            # the fleet phase serves this model (and its training
            # baseline, which needs the Booster's training scores)
            fleet_src = (sbst.model_to_string(),
                         sbst._gbdt.drift_baseline())
        del sbst

    # ---- train_quant: the same data with quantized gradients --------------
    if "train_quant" in run:
        qparams = dict(params, quantized_grad=True, grad_bits=8)
        qbst, qlaunches, qtrain_s, qpeak = timed_train(qparams, ds)
        qpv = qbst.predict(xv)
        qauc = auc(yv, qpv)
        qhbst, qhost_launches, qhost = host_side(qparams, ds)
        # the generic iteration over the device loop: the host loop's
        # scores, so its trees must be the host loop's
        qgbst, qglaunches, qg_s, _ = timed_train(qparams, ds, loop="generic",
                                                 rounds=HOST_ROUNDS)
        # (the host loop's booster has grown its steady rounds since)
        same_trees = [t.to_string() for t in qgbst._gbdt.models] \
            == [t.to_string() for t in qhbst._gbdt.models[:HOST_ROUNDS]]
        qgauc = auc(yv, qgbst.predict(xv))
        train_quant = dict({
            "phase": "train_quant", "rows": args.rows,
            "rounds": args.rounds, "grad_bits": 8, "quant_renew": True,
            "strategy": qbst._gbdt.learner.strategy,
            "growth": "device loop, fused iteration", "launches": qlaunches,
            "k4_path": k4_path(qbst, qlaunches)},
            **growth(qbst, qlaunches, qtrain_s))
        train_quant.update({
            "train_s": qtrain_s, "s_per_iter_steady": steady_s(qbst),
            "peak_device_bytes": qpeak, "valid_auc": qauc,
            "float_valid_auc": valid_auc, "auc_diff": qauc - valid_auc,
            "profile": profile_one(qbst), "host_loop": qhost,
            "auc_minus_host_loop": auc(yv, qbst.predict(
                xv, num_iteration=HOST_ROUNDS)) - qhost["valid_auc"],
            "generic_on_device_loop": {
                "train_s": qg_s, "valid_auc": qgauc,
                "same_trees_as_host_loop": same_trees,
                "launches": qglaunches}})
        with host_loop(torch):
            if parents:
                # the host loop beside the parent's (cut 7: only then)
                qhost["profile"] = profile_one(qhbst)
                # the parent's path in the host loop: the operand built by
                # gh_operand_scaled, then K3 on the parent's library
                with parent_two_step(k1, parents["histogram_wrapper"]):
                    par = profile_one(qhbst, k3_kernels=parent_k3_names)
                qhost["parent_iteration"] = {
                    key: par[key] for key in ("k3", "device_ms",
                                              "device_launches", "wall_ms")}
        emit(train_quant)
        if train_quant["strategy"] != "compact":
            fail("the quantized 1M-row run did not take the compact "
                 "strategy")
        if qlaunches["k3_win"] <= 0 or qlaunches["k4_win"] <= 0 \
                or qlaunches["split_key"] <= 0 or qlaunches["k1_win"] \
                or qlaunches["k3"] or qlaunches["k4"]:
            fail("quantized run: K3's and K4's window entries and the split "
                 "key must launch, and nothing else: %s" % qlaunches)
        if qhost_launches["k3"] <= 0 or qhost_launches["k4"] <= 0:
            fail("the quantized host loop did not launch K3 and K4: %s"
                 % qhost_launches)
        if train_quant["host_syncs_per_tree"] != 1:
            fail("the quantized device loop made %s host syncs per tree"
                 % train_quant["host_syncs_per_tree"])
        if not same_trees or round(qgauc, 7) != round(qhost["valid_auc"], 7):
            fail("the device loop grew other quantized trees than the host "
                 "loop from the same scores (AUC %.7f vs %.7f)"
                 % (qgauc, qhost["valid_auc"]))
        if not np.all(np.isfinite(qpv)) or qauc <= 0.7 \
                or abs(qauc - valid_auc) > 0.005:
            fail("quantized AUC %.5f vs float %.5f (want > 0.7, within "
                 "0.005)" % (qauc, valid_auc))
        del qbst, qhbst, qgbst
    # ---- train_masked: 60,000 rows, float and quantized -------------------
    masked_rows = []
    xm = ym = dsm = None
    if run & {"train_masked", "train_bag", "train_learners"}:
        xm, ym, _ = make_higgs_like(60_000, f, seed=23, w=w_true)
        dsm = lgb.Dataset(xm, ym, params=params)
        dsm.construct()
    if "train_masked" in run:
        for quant in (False, True):
            mp = dict(params, quantized_grad=quant, grad_bits=8)
            mb, mlaunches, ms_s, mpeak = timed_train(mp, dsm)
            mpv = mb.predict(xv)
            mauc = auc(yv, mpv)
            row = dict({"quantized_grad": quant,
                        "strategy": mb._gbdt.learner.strategy,
                        "growth": "device loop, fused iteration",
                        "fused": mb._gbdt._fused_step is not None,
                        "launches": mlaunches},
                       **growth(mb, mlaunches, ms_s))
            row.update({"train_s": ms_s, "s_per_iter_steady": steady_s(mb),
                        "peak_device_bytes": mpeak, "valid_auc": mauc,
                        "profile": profile_one(mb)})
            mhb, mhl, mhost = host_side(mp, dsm)
            row["host_loop"] = mhost
            row["auc_minus_host_loop"] = auc(yv, mb.predict(
                xv, num_iteration=HOST_ROUNDS)) - mhost["valid_auc"]
            if quant:
                # the generic iteration over the device loop: the host
                # loop's scores, so its trees must be the host loop's
                gb, gl, g_s, _ = timed_train(mp, dsm, loop="generic",
                                             rounds=HOST_ROUNDS)
                gauc = auc(yv, gb.predict(xv))
                row["generic_on_device_loop"] = {
                    "train_s": g_s, "valid_auc": gauc, "launches": gl,
                    "same_trees_as_host_loop":
                        [t.to_string() for t in gb._gbdt.models]
                        == [t.to_string()
                            for t in mhb._gbdt.models[:HOST_ROUNDS]]}
                del gb
            masked_rows.append(row)
            want = "k3t" if quant else "k2"
            step = row.get("captured_step_launches", {})
            hist_key = "histogram." + ("launches_qt" if quant
                                       else "launches_t")
            problems = []
            if row["strategy"] != "masked" or not row["fused"]:
                problems.append("not the masked strategy's fused iteration")
            if mlaunches[want] <= 0 or mlaunches["split_key_col"] <= 0 \
                    or step.get(hist_key) != 1 \
                    or step.get("split_key.launches_col") != 1:
                problems.append("%s and the column split key not launched "
                                "from the replayed step" % want)
            if any(mlaunches[k] for k in ("k1", "k3", "k4", "k1_win",
                                          "k3_win", "k4_win", "split_key")):
                problems.append("a compact core's kernel launched")
            if row["host_syncs_per_tree"] != 1:
                problems.append("%s host syncs per tree"
                                % row["host_syncs_per_tree"])
            if not np.all(np.isfinite(mpv)) or mauc <= 0.7:
                problems.append("AUC %.5f" % mauc)
            if not quant and abs(row["auc_minus_host_loop"]) > 0.001:
                problems.append("AUC at %d rounds not within 0.001 of the "
                                "host loop's %.5f (%+.5f)" % (
                                    HOST_ROUNDS, mhost["valid_auc"],
                                    row["auc_minus_host_loop"]))
            if quant:
                gen = row["generic_on_device_loop"]
                if not gen["same_trees_as_host_loop"] \
                        or round(gen["valid_auc"], 7) \
                        != round(mhost["valid_auc"], 7):
                    problems.append("the device loop grew other quantized "
                                    "trees than the host loop from the "
                                    "same scores")
            if problems:
                emit({"phase": "train_masked", "runs": masked_rows})
                fail("masked run (quantized=%s): %s"
                     % (quant, "; ".join(problems)))
            del mb, mhb
        emit({"phase": "train_masked", "rows": 60_000,
              "rounds": args.rounds, "runs": masked_rows})

    # ---- train_bag: bagging, GOSS and pos/neg bagging ----------------------
    bag_rows = []
    if "train_bag" in run:
        # every sampling key set in every case: a Booster updates its
        # Dataset's config with its parameters, and the next Booster on
        # the same Dataset would inherit what it does not set
        plain = {"boosting": "gbdt", "quantized_grad": False, "grad_bits": 8,
                 "bagging_fraction": 1.0, "bagging_freq": 0,
                 "pos_bagging_fraction": 1.0, "neg_bagging_fraction": 1.0}

        def unbagged_auc(dset, known):
            # the unbagged float run of the same data: the train /
            # train_masked phase's, else one made here
            if known is not None:
                return known
            ub, _, _, _ = timed_train(dict(params, **plain), dset)
            out = auc(yv, ub.predict(xv))
            del ub
            return out

        base_1m = unbagged_auc(ds, valid_auc)
        base_60k = unbagged_auc(dsm, masked_rows[0]["valid_auc"]
                                if masked_rows else None)
        bag = {"bagging_fraction": 0.8, "bagging_freq": 1}
        # GOSS samples after 1 / learning_rate = 10 warm-up iterations
        goss = {"boosting": "goss", "top_rate": 0.2, "other_rate": 0.1}
        pos_neg = {"pos_bagging_fraction": 0.5, "neg_bagging_fraction": 0.5,
                   "bagging_freq": 1}
        for name, extra, rounds, dset, xt, base in (
                ("higgs-1m bagging 0.8", bag, args.rounds, ds, x, base_1m),
                ("higgs-1m-quant bagging 0.8",
                 dict(bag, quantized_grad=True, grad_bits=8), args.rounds,
                 ds, x, base_1m),
                ("higgs-1m goss", goss,
                 int(1.0 / params["learning_rate"]) + max(1, args.rounds // 2),
                 ds, x, base_1m),
                ("higgs-60k-masked bagging 0.8", bag, args.rounds, dsm, xm,
                 base_60k),
                ("higgs-60k-masked-quant bagging 0.8",
                 dict(bag, quantized_grad=True, grad_bits=8), args.rounds,
                 dsm, xm, base_60k),
                ("higgs-60k-masked pos/neg bagging 0.5", pos_neg,
                 args.rounds, dsm, xm, base_60k)):
            row, problems = bag_case(
                torch, name, dict(params, **dict(plain, **extra)), extra,
                rounds, dset, xt, base, timed_train, growth, k4_path, steady_s,
                lambda b: auc(yv, b.predict(xv)), profile_one)
            bag_rows.append(row)
            if problems:
                emit({"phase": "train_bag", "runs": bag_rows})
                fail("train_bag %s: %s" % (name, "; ".join(problems)))
        emit({"phase": "train_bag", "runs": bag_rows})

    # ---- train_valid: a validation set, evaluation, early stopping --------
    if "train_valid" in run:
        row, problems = train_valid_phase(
            torch, lgb, params, ds, xv, yv, args.rounds, train, growth,
            profile, reset_counts, read_counts)
        emit(row)
        if problems:
            fail("train_valid: %s" % "; ".join(problems))

    # ---- train_objectives / train_multiclass: the other objectives --------
    if "train_objectives" in run:
        row, problems = objectives_phase(
            torch, lgb, params, ds, x, xv, w_true, 3, timed_train, growth,
            steady_s)
        emit(row)
        if problems:
            fail("train_objectives: %s" % "; ".join(problems))
    if "train_multiclass" in run:
        row, problems = multiclass_phase(
            torch, lgb, params, ds, args.rows, f, xv, 5, reset_counts,
            read_counts, growth, steady_s)
        emit(row)
        if problems:
            fail("train_multiclass: %s" % "; ".join(problems))
    if "train_boost" in run:
        row, problems = boost_phase(
            torch, lgb, convert, params, ds, x, xv, yv, args.rounds,
            reset_counts, read_counts, growth, steady_s)
        emit(row)
        if problems:
            fail("train_boost: %s" % "; ".join(problems))
    learners = None
    if "train_learners" in run:
        dense = {}
        if train is not None and prof is not None:
            dense["float"] = dict(
                valid_auc=valid_auc, profile=prof,
                captured_step_launches=train.get("captured_step_launches"))
        if train_quant is not None:
            dense["quant"] = {k: train_quant.get(k) for k in (
                "valid_auc", "captured_step_launches", "profile")}
        learners, problems = learners_phase(
            torch, lgb, params, ds, dsm, x, xv, yv, args.rounds,
            timed_train, growth, steady_s, profile_one, dense)
        emit(learners)
        if problems:
            fail("train_learners: %s" % "; ".join(problems))
    stream_counts = {}
    if "train_stream" in run:
        row, problems, stream_counts = stream_phase(
            torch, dev, lgb, params, ds, x, y, xv, yv, compact_auc5,
            timed_train,
            growth, steady_s, profile_one)
        emit(row)
        if problems:
            fail("train_stream: %s" % "; ".join(problems))
    res_counts = {}
    if "resilience" in run:
        row, problems, res_counts = resilience_phase(
            torch, lgb, params, ds, yv, xv,
            None if valid_auc is None else (valid_auc, args.rounds),
            reset_counts, read_counts, {"K1": r"hist_fixed",
                                    "K4": r"partition"})
        emit(row)
        if problems:
            fail("resilience: %s" % "; ".join(problems))
    # ---- fleet: the last phase on ds, as its continual episode appends
    # rows to it ------------------------------------------------------------
    fleet_counts = {}
    if "fleet" in run:
        row, problems, fleet_counts = fleet_phase(
            torch, lgb, params, ds, xv, yv, w_true, fleet_src, reset_counts,
            read_counts)
        emit(row)
        if problems:
            fail("fleet: %s" % "; ".join(problems))
    if need_data:
        del ds
    # ---- the C ABI and data-parallel training, on the raw higgs-1m rows
    capi_counts, dp_counts, serial_ref = {}, {}, None
    if "capi" in run:
        row, problems, capi_counts, serial_ref = capi_phase(
            torch, lgb, params, x, y, xv, yv, args.rounds, reset_counts,
            read_counts)
        emit(row)
        if problems:
            fail("capi: %s" % "; ".join(problems))
    if "dp" in run:
        if serial_ref is None:
            sds = lgb.Dataset(x, y, params=dict(params))
            sds.construct()
            torch.cuda.synchronize()
            t1 = time.time()
            sb = lgb.train(dict(params), sds, args.rounds)
            torch.cuda.synchronize()
            serial_ref = (sb, sds, (time.time() - t1) / args.rounds)
        row, problems, dp_counts = dp_phase(
            torch, lgb, params, args.rows, xv, yv, args.rounds, serial_ref,
            reset_counts, read_counts)
        emit(row)
        if problems:
            fail("dp: %s" % "; ".join(problems))
    serial_ref = None

    if "train_cat" in run:
        row, problems = categorical_phase(
            torch, lgb, convert, params, args.rows, f, args.rounds,
            timed_train, growth, steady_s, profile_one, host_side, train)
        emit(row)
        if problems:
            fail("train_cat: %s" % "; ".join(problems))

    if "train_rank" in run:
        row, problems = rank_phase(torch, lgb, convert, args.rounds,
                                   reset_counts, read_counts, growth,
                                   steady_s, profile_one)
        emit(row)
        if problems:
            fail("train_rank: %s" % "; ".join(problems))

    if "loop" in run:
        loop_phase(torch, dev, lgb, params, f, Config, DeviceTreeLearner,
                   (R_LCNT, R_RCNT))

    if "reference" in run:
        reference_phase(torch, dev, lgb, k1, params, f, Config,
                        DeviceTreeLearner, _quant_prepare, quant_ops,
                        prng_key, (R_DLEFT, R_FEAT, R_LCNT, R_LEAF, R_RCNT,
                                   R_THR))

    # ---- kernels line (a run of every phase) -----------------------------
    if every:
        def kernel_entry(name, source, replaces, n, rows, err_key,
                         stream_key=None):
            r0 = rows[0]
            entry = {"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": n,
                     "max_abs_err": max(rw[err_key] for rw in rows),
                     "ms": r0["ms"], "device_ms": r0["device_ms"],
                     "plain_ms": r0["plain_ms"],
                     "bound_ms": r0["bound_ms"], "bound_by": r0["bound_by"],
                     "library_ms": r0["library_ms"]}
            if stream_key is not None and stream_key in stream_counts:
                entry["train_stream_launches"] = stream_counts[stream_key]
            if stream_key is not None and stream_key in res_counts:
                entry["resilience_launches"] = res_counts[stream_key]
            if stream_key is not None and stream_key in fleet_counts:
                entry["fleet_launches"] = fleet_counts[stream_key]
            if stream_key is not None and stream_key in capi_counts:
                entry["capi_launches"] = capi_counts[stream_key]
            if stream_key is not None and stream_key in dp_counts:
                entry["dp_launches"] = dp_counts[stream_key]
            return entry

        hk = "lightgbm_tpu/ops/pallas/histogram_kernel.py"
        pk = "lightgbm_tpu/ops/pallas/partition_kernel.py:48"
        serial_k3 = next(rw["launches"]["k3"] for rw in learners["runs"]
                         if rw["case"] == "higgs-1m-quant serial forced")
        hcu = "lightgbm_tpu_torch/csrc/histogram.cu"
        pcu = "lightgbm_tpu_torch/csrc/partition.cu"
        kr = kernel_rows
        # launches: each entry's path, run from zeroed counts -- the main
        # path (the device loop) for the window entries and the split key,
        # the host loop beside it for the host-int entries of K1, K3, K4,
        # the masked strategy's device loop (float, quantized for K3t) for
        # K2 / K3t and the column split key. The train_stream phase's
        # device-loop runs (strategy=chunk, streamed, streamed GOSS) count
        # apart, in train_stream_launches, and the resilience phase's runs
        # (checkpointed, resumed, guarded, traced) in resilience_launches
        kernels = [
            kernel_entry("K1 histogram, device-window entry", hcu,
                         hk + ":41", launches["k1_win"], kr["k1_win"],
                         "max_abs_err", "k1_win"),
            kernel_entry("K1 histogram, host-int entry", hcu, hk + ":41",
                         host_launches["k1"], kr["k1"], "max_abs_err"),
            kernel_entry("K2 histogram, (F, N) codes", hcu, hk + ":73",
                         masked_rows[0]["launches"]["k2"], kr["k2"],
                         "max_abs_err"),
            kernel_entry("K3 integer histogram, device-window entry", hcu,
                         hk + ":114", qlaunches["k3_win"], kr["k3_win"],
                         "max_abs_err", "k3_win"),
            kernel_entry("K3 integer histogram, packed-row entry", hcu,
                         hk + ":114", qhost_launches["k3"],
                         kr["k3_rows"], "max_abs_err"),
            # the operand form: the serial learner's quantized histograms
            # (launches from train_learners' quantized serial run)
            kernel_entry("K3 integer histogram, operand entry", hcu,
                         hk + ":114", serial_k3, kr["k3"], "max_abs_err"),
            kernel_entry("K3t integer histogram, (F, N) codes", hcu,
                         hk + ":152", masked_rows[1]["launches"]["k3t"],
                         kr["k3t"], "max_abs_err"),
            kernel_entry("K4 stable partition, device-window entry", pcu, pk,
                         launches["k4_win"], kr["k4_win"], "max_abs_err",
                         "k4_win"),
            kernel_entry("K4 stable partition, host-int entry", pcu, pk,
                         host_launches["k4"], kr["k4"], "max_abs_err"),
            # no Pallas kernel: XLA fuses the JAX core's window decode
            kernel_entry("split key", "lightgbm_tpu_torch/csrc/split_key.cu",
                         "lightgbm_tpu/models/device_learner.py:2083",
                         launches["split_key"], kr["split_key"],
                         "max_abs_err", "split_key"),
            # the masked core's decode and row update (device_learner.py
            # :402-419), in XLA too
            kernel_entry("split key, column entry",
                         "lightgbm_tpu_torch/csrc/split_key.cu",
                         "lightgbm_tpu/models/device_learner.py:402",
                         masked_rows[0]["launches"]["split_key_col"],
                         kr["split_key_col"], "max_abs_err"),
            # the out-of-bag rows' leaves of a bagged compact tree
            # (route_rows_by_rec, a fori_loop in XLA); launches from the
            # 1M-row bagged run of train_bag; its first case is that
            # run's shape (200,000 out-of-bag rows, a 255-leaf tree)
            kernel_entry("split key, router entry",
                         "lightgbm_tpu_torch/csrc/split_key.cu",
                         "lightgbm_tpu/models/device_learner.py:2174",
                         bag_rows[0]["launches"]["route"], kr["route"],
                         "max_abs_err", "route")]
        print(smi_line, flush=True)
        emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


# rounds of the train_stream phase's chunk-core runs (quantized streamed:
# QUANT_STREAM_ROUNDS), and the rows of its two-round file
STREAM_ROUNDS = 5
QUANT_STREAM_ROUNDS = 2
TWO_ROUND_ROWS = 200_000


# rounds of the resilience phase's runs; the kill and the preemption land
# at these iterations, the periodic checkpoints every RES_CKPT_FREQ
RES_ROUNDS = 10
RES_CKPT_FREQ = 5
RES_KILL_AT = 7
RES_PREEMPT_AT = 4
RES_NAN_AT = 3
# the telemetry modes' runs: rounds before the steady iterations, the
# steady iterations per mode (interleaved), and the generic iterations
# under torch's sync debug mode per mode
RES_MODE_ROUNDS = 5
RES_STEADY_ITERS = 24
RES_SYNC_ITERS = 4

_RES_CHILD = """
import sys
sys.path.insert(0, {root!r})
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.callback import checkpoint
from lightgbm_tpu_torch.io.dataset import Dataset as Inner
params = {params!r}
ds = lgb.Dataset({binary!r}, params=params)
ds._inner = Inner.load_binary({binary!r}, params)
lgb.train(params, ds, num_boost_round={rounds},
          callbacks=[checkpoint({directory!r}, checkpoint_freq={freq})])
"""


def resilience_phase(torch, lgb, params, ds, yv, xv, fused,
                     reset_counts, read_counts, kernel_names):
    """resilience: checkpoints, resume, the sentries and telemetry on the
    higgs-1m rows and params, RES_ROUNDS rounds. (row, problems, counts):
    counts sums the launches of the phase's runs, which the kernels line
    reports apart from the main path's.

    1. the same float run with bagging 0.8 twice: equal model text (the
       determinism that kill-and-resume stands on; on a difference one
       more run under torch.use_deterministic_algorithms(True) names the
       op, and the phase fails);
    2. kill and resume: a child process (the Dataset from save_binary)
       checkpoints every RES_CKPT_FREQ rounds and dies at RES_KILL_AT
       (kill_rank, exit 137); this process resumes it to RES_ROUNDS:
       model text equal to step 1's; a second child under preempt@iter=
       RES_PREEMPT_AT exits 76 with an emergency checkpoint that records
       target_rounds, and num_boost_round=None finishes it, equal too;
       the same in one process for quantized gradients (grad_bits 8);
    3. the checkpoint's bytes, save ms and restore ms at 1M rows;
    4. nan_grad@iter=RES_NAN_AT,frac=0.01: raise names the iteration,
       skip_iter leaves RES_ROUNDS - 1 trees; rollback leaves RES_ROUNDS
       - 1 trees (it redoes the iteration before the fault), its AUC
       > 0.7 and within 0.005 of a clean run of as many rounds on the
       same generic iteration, its trees before the fault with the clean
       run's leaves for every held-out row (the share of equal leaves per
       tree recorded), and its gap to the train phase's fused run
       (`fused`: (AUC, rounds), or None) recorded beside; a NaN put into
       the training scores trips the fused iteration's guard (skip_iter:
       nothing committed, the tree's one fetch the only sync);
    5. telemetry off, summary and trace, one Booster each of
       RES_MODE_ROUNDS rounds, then RES_STEADY_ITERS steady iterations
       each with the modes interleaved: s per iteration (median, p10,
       p90, min, max; recorded), host syncs per tree (1) and model text
       (equal across the modes), the phase shares, the trace's span
       count; the generic iteration RES_SYNC_ITERS times per mode after
       a warm-up, the modes interleaved, under torch's sync debug mode:
       as many synchronizing calls in each mode (at least 1 per
       iteration), 1 learner sync per tree, the gradient norms in every
       summary / trace record; then one iteration under
       LGBM_TPU_XLA_TRACE, whose torch.profiler trace must name K1's and
       K4's kernels."""
    import shutil
    import tempfile

    from lightgbm_tpu_torch import telemetry
    from lightgbm_tpu_torch.callback import checkpoint
    from lightgbm_tpu_torch.resilience import faults
    from lightgbm_tpu_torch.resilience.checkpoint import find_checkpoint
    from lightgbm_tpu_torch.resilience.sentries import NonFiniteError

    # every key the earlier phases set on the shared Dataset (a Booster
    # writes its parameters into its Dataset's config)
    plain = {"objective": "binary", "num_class": 1, "boosting": "gbdt",
             "metric": ["binary_logloss"], "quantized_grad": False,
             "grad_bits": 8, "bagging_fraction": 1.0, "bagging_freq": 0,
             "pos_bagging_fraction": 1.0, "neg_bagging_fraction": 1.0,
             "feature_fraction": 1.0, "feature_fraction_bynode": 1.0,
             "histogram_pool_size": -1.0, "forcedsplits_filename": "",
             "cegb_tradeoff": 1.0, "cegb_penalty_split": 0.0,
             "stream_mode": "off", "stream_chunk_rows": 0,
             "two_round": False, "on_nonfinite": "off",
             "learning_rate": params["learning_rate"]}
    p0 = dict(params, **plain)
    pbag = dict(p0, bagging_fraction=0.8, bagging_freq=1)
    pq = dict(pbag, quantized_grad=True)
    rounds = RES_ROUNDS
    problems, counts = [], {}
    row = {"phase": "resilience", "rows": ds.num_data(), "rounds": rounds}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_res_")
    os.environ.pop("LGBM_TPU_STRATEGY", None)
    telemetry.set_mode("off")
    faults.clear()

    def train(p, n, **kw):
        reset_counts()
        b = lgb.train(p, ds, num_boost_round=n, **kw)
        for k, v in read_counts().items():
            counts[k] = counts.get(k, 0) + v
        return b

    children = {}
    t_phase = time.time()
    try:
        # ---- 2a. the children start first: they share the card -------
        t1 = time.time()
        binary = os.path.join(tmp, "higgs.bin.npz")
        ds.save_binary(binary)
        row["save_binary_s"] = time.time() - t1
        here = os.path.dirname(os.path.abspath(__file__))
        for name, spec in (("kill", "kill_rank@iter=%d" % RES_KILL_AT),
                           ("preempt", "preempt@iter=%d" % RES_PREEMPT_AT)):
            d = os.path.join(tmp, name)
            code = _RES_CHILD.format(
                root=here, params=pbag, binary=binary, rounds=rounds,
                directory=d, freq=(RES_CKPT_FREQ if name == "kill"
                                   else 1000))
            env = dict(os.environ, LGBM_TPU_FAULT_SPEC=spec,
                       LGBM_TPU_NO_SIGNAL_HANDLERS="1")
            children[name] = (d, time.time(), subprocess.Popen(
                [sys.executable, "-c", code], env=env, cwd=here,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))

        # ---- 1. determinism ------------------------------------------
        a = train(pbag, rounds)
        text_a = a.model_to_string()
        b = train(pbag, rounds)
        same = b.model_to_string() == text_a
        row["determinism"] = {"bagging_fraction": 0.8, "equal": same}
        del b
        if not same:
            problems.append("two equal runs wrote other model text")
            torch.use_deterministic_algorithms(True)
            try:
                train(pbag, 1)
                row["determinism"]["diagnostic"] = "no nondeterministic op"
            except RuntimeError as e:
                row["determinism"]["diagnostic"] = str(e)[:500]
            finally:
                torch.use_deterministic_algorithms(False)

        # ---- 2b. kill and preempt: the children's ends ----------------
        ends = {}
        for name, (d, t0, proc) in children.items():
            try:
                out, err = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            ends[name] = {"exit_code": proc.returncode,
                          "s": time.time() - t0,
                          "stderr_tail": err[-600:]}
        children.clear()
        kill = ends["kill"]
        try:
            kdata = find_checkpoint(os.path.join(tmp, "kill"))
            kill["checkpoint_iteration"] = kdata.iteration
            t1 = time.time()
            kb = train(pbag, rounds, resume_from=os.path.join(tmp, "kill"))
            kill["resume_s"] = time.time() - t1
            kill["equal_to_uninterrupted"] = kb.model_to_string() == text_a
            kill["iterations"] = kb.current_iteration()
            del kb
        except Exception as e:          # noqa: BLE001 - reported below
            kill["error"] = repr(e)[:300]
        if kill["exit_code"] != 137 or not kill.get(
                "equal_to_uninterrupted") \
                or kill.get("checkpoint_iteration") != RES_CKPT_FREQ:
            problems.append("kill and resume: %s" % {
                k: v for k, v in kill.items() if k != "stderr_tail"})
        pre = ends["preempt"]
        try:
            pdata = find_checkpoint(os.path.join(tmp, "preempt"))
            pre.update(checkpoint_iteration=pdata.iteration,
                       target_rounds=pdata.meta.get("target_rounds"),
                       preempted=pdata.meta.get("preempted"))
            pb = train(pbag, None, resume_from=os.path.join(tmp, "preempt"))
            pre["iterations"] = pb.current_iteration()
            pre["equal_to_uninterrupted"] = pb.model_to_string() == text_a
            del pb
        except Exception as e:          # noqa: BLE001 - reported below
            pre["error"] = repr(e)[:300]
        if pre["exit_code"] != 76 or pre.get("target_rounds") != rounds \
                or pre.get("checkpoint_iteration") != RES_PREEMPT_AT \
                or pre.get("iterations") != rounds \
                or not pre.get("equal_to_uninterrupted"):
            problems.append("preempt and resume: %s" % {
                k: v for k, v in pre.items() if k != "stderr_tail"})
        row["kill_resume"] = kill
        row["preempt_resume"] = pre

        # quantized, in one process
        qd = os.path.join(tmp, "quant")
        qfull = train(pq, rounds).model_to_string()
        train(pq, RES_CKPT_FREQ,
              callbacks=[checkpoint(qd, checkpoint_freq=RES_CKPT_FREQ)])
        qb = train(pq, rounds, resume_from=qd)
        row["quant_resume"] = {"grad_bits": 8, "equal_to_uninterrupted":
                               qb.model_to_string() == qfull}
        del qb
        if not row["quant_resume"]["equal_to_uninterrupted"]:
            problems.append("quantized resume wrote other model text")

        # ---- 3. the checkpoint's cost at 1M rows ----------------------
        torch.cuda.synchronize()
        t1 = time.time()
        path = a.save_checkpoint(os.path.join(tmp, "cost"))
        save_ms = (time.time() - t1) * 1e3
        fresh = lgb.Booster(params=pbag, train_set=ds)
        torch.cuda.synchronize()
        t1 = time.time()
        fresh.restore_checkpoint(path)
        torch.cuda.synchronize()
        row["checkpoint"] = {"bytes": os.path.getsize(path),
                             "save_ms": save_ms,
                             "restore_ms": (time.time() - t1) * 1e3,
                             "restored_equal": fresh.model_to_string()
                             == text_a}
        if not row["checkpoint"]["restored_equal"]:
            problems.append("a restored checkpoint writes other model text")
        del fresh, a

        # ---- 4. the sentries ------------------------------------------
        spec = "nan_grad@iter=%d,frac=0.01" % RES_NAN_AT
        sent = {"spec": spec}
        faults.install(spec)
        try:
            train(dict(p0, on_nonfinite="raise"), rounds)
            sent["raise"] = "did not raise"
        except NonFiniteError as e:
            sent["raise"] = str(e)
        if "iteration %d" % RES_NAN_AT not in sent["raise"]:
            problems.append("raise: %s" % sent["raise"])
        plan = faults.install(spec)
        sb = train(dict(p0, on_nonfinite="skip_iter"), rounds)
        sent["skip_iter_trees"] = sb.num_trees()
        sent["skip_iter_events"] = list(plan.events)
        del sb
        if sent["skip_iter_trees"] != rounds - 1:
            problems.append("skip_iter left %d trees"
                            % sent["skip_iter_trees"])
        # rollback redoes iteration RES_NAN_AT - 1 at the call of
        # RES_NAN_AT, so `rounds` calls grow rounds - 1 trees, as in the
        # JAX package; it runs the generic iteration (a gradient fault
        # turns the fused one off), and so does its clean run here: a plan
        # whose fault lands past the run, the same policy
        faults.install(spec)
        rb = train(dict(p0, on_nonfinite="rollback"), rounds)
        faults.install("nan_grad@iter=%d" % (10 * rounds))
        cb = train(dict(p0, on_nonfinite="rollback"), rounds - 1)
        faults.clear()
        rpred, cpred = rb.predict(xv), cb.predict(xv)
        rleaf = rb.predict(xv, pred_leaf=True)
        cleaf = cb.predict(xv, pred_leaf=True)
        same_leaf = ([float(np.mean(rleaf[:, t] == cleaf[:, t]))
                      for t in range(rleaf.shape[1])]
                     if rleaf.shape == cleaf.shape else [])
        sent.update(rollback_auc=auc(yv, rpred), clean_auc=auc(yv, cpred),
                    clean_rounds=rounds - 1, rollback_trees=rb.num_trees(),
                    same_leaf_share_by_tree=same_leaf)
        if fused is not None:
            sent.update(fused_clean_auc=fused[0], fused_clean_rounds=fused[1],
                        rollback_minus_fused_clean=sent["rollback_auc"]
                        - fused[0])
        del rb, cb
        if sent["rollback_trees"] != rounds - 1:
            problems.append("rollback left %d trees" % sent["rollback_trees"])
        if not np.all(np.isfinite(rpred)) or sent["rollback_auc"] <= 0.7 \
                or abs(sent["rollback_auc"] - sent["clean_auc"]) > 0.005:
            problems.append("rollback AUC %.5f against clean %.5f"
                            % (sent["rollback_auc"], sent["clean_auc"]))
        # the trees before the fault grow from the same scores: the same
        # leaves for every row
        if same_leaf[:RES_NAN_AT - 1] != [1.0] * (RES_NAN_AT - 1):
            problems.append("rollback's trees before the fault differ from "
                            "the clean run's: %s" % same_leaf)
        # the fused iteration's guard, tripped by a NaN in the scores
        gb = train(dict(p0, on_nonfinite="skip_iter"), 3)
        g = gb._gbdt
        fused = g._fused_step is not None
        g.score_updater.score[0, 5] = float("nan")
        text0, it0, syncs0 = gb.model_to_string(), g.iter, \
            g.learner.stats.host_syncs
        s0 = g.score_updater.score.clone()
        gb.update()
        guard = {"fused": fused, "committed_nothing": bool(
            gb.model_to_string() == text0 and g.iter == it0 + 1
            and torch.equal(torch.isnan(s0), torch.isnan(
                g.score_updater.score))
            and torch.equal(torch.nan_to_num(s0),
                            torch.nan_to_num(g.score_updater.score))),
            "host_syncs": g.learner.stats.host_syncs - syncs0}
        sent["fused_guard"] = guard
        del gb, g, s0
        if not (guard["fused"] and guard["committed_nothing"]
                and guard["host_syncs"] == 1):
            problems.append("the fused guard: %s" % guard)
        row["sentries"] = sent

        # ---- 5. telemetry ---------------------------------------------
        # one Booster per mode, RES_MODE_ROUNDS rounds; then
        # RES_STEADY_ITERS steady iterations each, the modes interleaved
        names = ("off", "summary", "trace")
        modes, boosters, texts = {}, {}, {}
        for mode in names:
            telemetry.set_mode(mode)
            telemetry.reset()
            boosters[mode] = train(p0, RES_MODE_ROUNDS)
            modes[mode] = {}
            if mode != "off":
                # the run's iterations (the first one's capture included)
                # and the eval outside them, against the iterations' wall
                bd = telemetry.phase_breakdown()
                modes[mode]["run_phase_share_of_wall"] = {
                    k: v["secs"] / bd["wall_s"]
                    for k, v in bd["phases"].items()}
        telemetry.set_mode("off")
        telemetry.reset()
        times = {mode: [] for mode in names}
        for _ in range(RES_STEADY_ITERS):
            for mode in names:
                telemetry.set_mode(mode)
                torch.cuda.synchronize()
                t1 = time.time()
                boosters[mode].update()
                torch.cuda.synchronize()
                times[mode].append(time.time() - t1)
        telemetry.set_mode("off")
        # the steady summary and trace iterations together
        bd = telemetry.phase_breakdown()
        row["telemetry_steady_phase_share_of_wall"] = {
            k: v["secs"] / bd["wall_s"] for k, v in bd["phases"].items()} \
            if bd["wall_s"] else {}
        row["telemetry_steady_coverage"] = bd["coverage"]
        row["telemetry_counters"] = telemetry.counters.snapshot()
        tp = telemetry.dump_trace(os.path.join(tmp, "trace.json"))
        with open(tp) as fh:
            modes["trace"]["trace_spans"] = sum(
                1 for e in json.load(fh)["traceEvents"] if e.get("ph") == "X")
        for mode in names:
            lr = boosters[mode]._gbdt.learner
            ts = np.asarray(times[mode])
            modes[mode].update(
                steady_iters=len(ts), s_per_iter_steady=float(np.median(ts)),
                s_per_iter_p10=float(np.percentile(ts, 10)),
                s_per_iter_p90=float(np.percentile(ts, 90)),
                s_per_iter_min=float(ts.min()), s_per_iter_max=float(ts.max()),
                host_syncs_per_tree=lr.stats.host_syncs
                / max(lr.stats.trees, 1))
            texts[mode] = boosters[mode].model_to_string()
        boosters.clear()
        for mode in ("summary", "trace"):
            modes[mode]["overhead_vs_off"] = (
                modes[mode]["s_per_iter_steady"]
                / modes["off"]["s_per_iter_steady"] - 1.0)
        # the generic iteration by mode (a plan whose gradient fault lands
        # past the run keeps the fused one off), one Booster each, the
        # modes interleaved: synchronizing CUDA calls per iteration, as
        # torch's sync debug mode reports them, must not rise with
        # telemetry on (summary and trace reduce the gradient norms for the
        # flight recorder); the first round warms up, uncounted
        faults.install("nan_grad@iter=%d" % (10 * rounds))
        for mode in names:
            telemetry.set_mode(mode)
            boosters[mode] = train(p0, 2)
        telemetry.set_mode("off")
        telemetry.reset()
        calls = {mode: [] for mode in names}
        sites = {mode: {} for mode in names}
        syncs0 = {}
        for i in range(RES_SYNC_ITERS + 1):
            if i == 1:
                telemetry.reset()
                syncs0 = {mode: (boosters[mode]._gbdt.learner.stats.host_syncs,
                                 boosters[mode]._gbdt.learner.stats.trees)
                          for mode in names}
            for mode in names:
                telemetry.set_mode(mode)
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        boosters[mode].update()
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                telemetry.set_mode("off")
                hits = [w for w in caught
                        if "synchronizing" in str(w.message)]
                if i:
                    calls[mode].append(len(hits))
                    for w in hits:
                        site = "%s:%d" % (os.path.basename(w.filename),
                                          w.lineno)
                        sites[mode][site] = sites[mode].get(site, 0) + 1
        with_norms = sum("grad_norms" in r
                         for r in telemetry.events.events("iteration"))
        for mode in names:
            lr = boosters[mode]._gbdt.learner
            s0, t0 = syncs0[mode]
            modes[mode]["generic"] = {
                "sync_calls_by_iter": calls[mode], "sync_sites": sites[mode],
                "learner_syncs_per_tree": (lr.stats.host_syncs - s0)
                / max(lr.stats.trees - t0, 1)}
        boosters.clear()
        faults.clear()
        telemetry.reset()
        row["telemetry"] = modes
        if any(m["host_syncs_per_tree"] != 1 for m in modes.values()):
            problems.append("host syncs per tree by mode: %s" % {
                k: v["host_syncs_per_tree"] for k, v in modes.items()})
        gen = {k: v["generic"] for k, v in modes.items()}
        row["telemetry_generic_records_with_grad_norms"] = with_norms
        if min(calls["off"]) < 1 \
                or len({sum(c) for c in calls.values()}) != 1 \
                or any(g["learner_syncs_per_tree"] != 1
                       for g in gen.values()) \
                or with_norms != 2 * RES_SYNC_ITERS:
            problems.append("the generic iteration's syncs by mode: %s, "
                            "%d records with gradient norms"
                            % (gen, with_norms))
        if len(set(texts.values())) != 1:
            problems.append("the telemetry modes wrote other model text")
        if not modes["trace"].get("trace_spans"):
            problems.append("the trace holds no span")
        # one iteration under LGBM_TPU_XLA_TRACE: torch.profiler's trace
        os.environ["LGBM_TPU_XLA_TRACE"] = os.path.join(tmp, "prof")
        try:
            telemetry.set_mode("trace")
            train(p0, 1)
            telemetry.dump_trace(os.path.join(tmp, "trace1.json"))
            prof = telemetry.device_trace_path()
            telemetry.set_mode("off")
            size = os.path.getsize(prof) if prof else 0
            with open(prof) as fh:
                names = {e.get("name", "") for e in json.load(fh)[
                    "traceEvents"] if e.get("cat") == "kernel"}
            found = {kn: sorted(n[:60] for n in names
                                if re.search(pat, n))[:3]
                     for kn, pat in kernel_names.items()}
            row["device_trace"] = {"bytes": size,
                                   "kernel_names": len(names),
                                   "found": found}
            if not all(found.values()):
                problems.append("the torch.profiler trace lacks %s"
                                % [k for k, v in found.items() if not v])
        finally:
            os.environ.pop("LGBM_TPU_XLA_TRACE", None)
            telemetry.set_mode("off")
    finally:
        for _, _, proc in children.values():
            proc.kill()
            proc.communicate()
        faults.clear()
        telemetry.set_mode("off")
        shutil.rmtree(tmp, ignore_errors=True)
    row["phase_s"] = time.time() - t_phase
    return row, problems, counts


def trees_text(b):
    """A booster's model text without its parameters block (a streamed
    and a resident run differ there alone)."""
    s = b._gbdt.save_model_to_string(0, -1)
    head, _, rest = s.partition("\nparameters:")
    return head + rest.partition("end of parameters")[2]


def idle_bytes(torch):
    """Device bytes allocated once the boosters dropped before are
    collected (their graphs may sit in reference cycles)."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return int(torch.cuda.memory_allocated())


@contextlib.contextmanager
def strategy_env(name):
    """Inside, LGBM_TPU_STRATEGY is `name` (None: unset)."""
    old = os.environ.pop("LGBM_TPU_STRATEGY", None)
    if name is not None:
        os.environ["LGBM_TPU_STRATEGY"] = name
    try:
        yield
    finally:
        os.environ.pop("LGBM_TPU_STRATEGY", None)
        if old is not None:
            os.environ["LGBM_TPU_STRATEGY"] = old


def stream_phase(torch, dev, lgb, params, ds, x, y, xv, yv, compact_auc,
                 timed_train, growth, steady_s, profile_one):
    """train_stream: out-of-core training on the higgs-1m rows
    (strategy=chunk, CH = LGBM_TPU_CHUNK, default 65,536: its device loop
    is the compact core's, the chunk core its host-loop oracle). (row,
    problems, counts): counts sums the launches of the phase's device-loop
    runs (K4, K1 / K3 and the split key, the streamed GOSS router), which
    the kernels line reports apart from the main path's.

    1. one tree from exact gradients (multiples of 0.25, unit hessians):
       strategy=chunk's device-loop records against the chunk core's host
       loop's and the compact strategy's (all equal);
    2. strategy=chunk, STREAM_ROUNDS rounds on the fused iteration: steady
       s per iteration, launches and device ms of one profiled iteration,
       the launches per split it adds over compact's step; AUC > 0.7 and
       within 0.001 of the compact model of as many rounds (`compact_auc`,
       the train phase's; None: trained here);
    3. stream_mode=chunked, the same rounds, against the resident chunk
       strategy on the same (generic) iteration: equal model text; H2D bytes
       per iteration (N x CW x 4), overlap and wait, device_data_bytes and
       the peak device memory of both over what each run found allocated
       (the streamed peak lower by at least the resident codes' bytes);
    4. quantized (grad_bits 8), QUANT_STREAM_ROUNDS rounds, streamed
       against resident: equal model text;
    5. stream_mode=goss (boosting=goss, learning_rate 0.5: 2 warm-up
       rounds, then 3 sampled), twice: equal model text, AUC > 0.7, H2D
       bytes per iteration against chunked, working-set hits;
    6. TWO_ROUND_ROWS rows written as CSV, loaded with two_round=true and
       in memory (numpy's parse): equal bins, and 2 rounds of equal model
       text; each load's s."""
    import tempfile

    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.models.device_learner import DeviceTreeLearner
    n = len(y)
    rounds = STREAM_ROUNDS
    # every key the earlier phases set on the shared Dataset: a Booster
    # writes its parameters into its Dataset's config, which the next one
    # inherits
    plain = {"objective": "binary", "num_class": 1, "boosting": "gbdt",
             "metric": ["binary_logloss"], "quantized_grad": False,
             "grad_bits": 8, "bagging_fraction": 1.0, "bagging_freq": 0,
             "pos_bagging_fraction": 1.0, "neg_bagging_fraction": 1.0,
             "feature_fraction": 1.0, "feature_fraction_bynode": 1.0,
             "histogram_pool_size": -1.0, "forcedsplits_filename": "",
             "cegb_tradeoff": 1.0, "cegb_penalty_split": 0.0,
             "stream_mode": "off", "stream_chunk_rows": 0,
             "two_round": False, "learning_rate": params["learning_rate"]}
    p0 = dict(params, **plain)
    problems = []
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    def auc_of(b):
        return auc(yv, b.predict(xv))

    row = {"phase": "train_stream", "rows": n, "rounds": rounds}

    # ---- 1. exact gradients: device loop, host loop, compact ----------
    r = np.random.RandomState(7)
    g = torch.from_numpy((r.randint(-8, 9, n) * 0.25).astype(np.float32)
                         ).to(dev)
    h = torch.ones(n, device=dev)
    cfg = Config(p0)
    lc = DeviceTreeLearner(cfg, ds._inner, strategy="chunk", device=dev)
    lp = DeviceTreeLearner(cfg, ds._inner, strategy="compact", device=dev)
    rec, leaf, k = lc.grow(g, h)
    torch.cuda.synchronize()
    t1 = time.time()
    hrec, hleaf, hk = lc.chunk_host_loop(g, h)[:3]
    torch.cuda.synchronize()
    host_s = time.time() - t1
    prec, pleaf, pk = lp.grow(g, h)
    step_c = {kk.rsplit(".", 2)[-2] + "." + kk.rsplit(".", 1)[-1]: v
              for kk, v in lc._loop.launches_per_step.items()}
    step_p = {kk.rsplit(".", 2)[-2] + "." + kk.rsplit(".", 1)[-1]: v
              for kk, v in lp._loop.launches_per_step.items()}
    exact = {"splits": k, "chunk_rows": lc.chunk_rows,
             "chunks_max": -(-n // lc.chunk_rows),
             "host_loop_s": host_s,
             "device_vs_host_loop_equal": bool(
                 k == hk and np.array_equal(rec, hrec)
                 and torch.equal(leaf, hleaf)),
             "chunk_vs_compact_equal": bool(
                 k == pk and np.array_equal(rec, prec)
                 and torch.equal(leaf, pleaf)),
             "captured_step_launches": step_c,
             "compact_step_launches": step_p,
             "kernel_launches_added_per_split":
                 sum(step_c.values()) - sum(step_p.values())}
    row["exact_gradients"] = exact
    if not exact["device_vs_host_loop_equal"]:
        problems.append("exact gradients: the chunk strategy's device-loop "
                        "records differ from the chunk core's host loop's")
    if not exact["chunk_vs_compact_equal"]:
        problems.append("exact gradients: the chunk strategy's records "
                        "differ from the compact strategy's")
    del lc, lp, g, h

    with strategy_env("chunk"):
        # ---- 2. strategy=chunk on the fused iteration -----------------
        cb, c_counts, c_s, c_peak = timed_train(p0, ds, rounds=rounds)
        add(c_counts)
        c_auc = auc_of(cb)
        if compact_auc is None:
            with strategy_env(None):
                pb, _, _, _ = timed_train(p0, ds, rounds=rounds)
                compact_auc = auc_of(pb)
                del pb
        chunk = dict({"strategy": cb._gbdt.learner.strategy,
                      "iteration": "fused" if cb._gbdt._fused_step
                      else "generic", "launches": c_counts},
                     **growth(cb, c_counts, c_s))
        chunk.update(train_s=c_s, peak_device_bytes=c_peak, valid_auc=c_auc,
                     compact_valid_auc=compact_auc,
                     auc_minus_compact=c_auc - compact_auc,
                     s_per_iter_steady=steady_s(cb),
                     profile=profile_one(cb))
        row["chunk"] = chunk
        if chunk["strategy"] != "chunk" or chunk["iteration"] != "fused":
            problems.append("strategy=chunk took %s on the %s iteration"
                            % (chunk["strategy"], chunk["iteration"]))
        if not c_auc > 0.7 or abs(c_auc - compact_auc) > 0.001:
            problems.append("chunk AUC %.5f (want > 0.7, within 0.001 of "
                            "compact's %.5f)" % (c_auc, compact_auc))
        if chunk["host_syncs_per_tree"] != 1:
            problems.append("chunk: %s host syncs per tree"
                            % chunk["host_syncs_per_tree"])
        if min(c_counts[kk] for kk in ("k4_win", "k1_win", "split_key")) \
                <= 0:
            problems.append("chunk: its kernels did not launch: %s"
                            % c_counts)
        del cb

        # ---- 3. stream_mode=chunked against the resident chunk run ----
        # each peak over what was allocated before its run, the other
        # run's booster freed
        base_r = idle_bytes(torch)
        rb, r_counts, r_s, r_peak = timed_train(p0, ds, loop="generic",
                                                rounds=rounds)
        res_bytes = rb._gbdt.learner.device_data_bytes()
        codes_bytes = int(rb._gbdt.learner.codes_pack.numel() * 4)
        r_text, r_peak = trees_text(rb), r_peak - base_r
        del rb
        base_s = idle_bytes(torch)
        sb, s_counts, s_s, s_peak = timed_train(
            dict(p0, stream_mode="chunked"), ds, rounds=rounds)
        s_peak -= base_s
        add(s_counts)
        sl = sb._gbdt.learner
        shard = sl._shard
        h2d = shard.h2d_bytes / max(sb.current_iteration(), 1)
        want_h2d = n * sl.code_words * 4
        streamed = dict({"iteration": "fused" if sb._gbdt._fused_step
                         else "generic", "launches": s_counts},
                        **growth(sb, s_counts, s_s))
        streamed.update(
            train_s=s_s, s_per_iter=s_s / rounds,
            resident_s_per_iter=r_s / rounds,
            h2d_bytes_per_iter=h2d, want_h2d_bytes_per_iter=want_h2d,
            overlap_fraction=shard.overlap_fraction(),
            stream_wait_s=shard.wait_seconds,
            stream_pass_s=shard.stream_seconds,
            device_data_bytes=sl.device_data_bytes(),
            resident_device_data_bytes=res_bytes,
            peak_device_bytes_over_base=s_peak,
            resident_peak_device_bytes_over_base=r_peak,
            base_device_bytes=base_s, resident_base_device_bytes=base_r,
            resident_codes_bytes=codes_bytes,
            peak_saved_bytes=r_peak - s_peak,
            valid_auc=auc_of(sb),
            model_text_equal=trees_text(sb) == r_text)
        row["stream_chunked"] = streamed
        if not streamed["model_text_equal"]:
            problems.append("stream_mode=chunked grew other trees than the "
                            "resident chunk run")
        if h2d != want_h2d:
            problems.append("streamed %s H2D bytes per iteration, want %d"
                            % (h2d, want_h2d))
        if r_peak - s_peak < codes_bytes:
            problems.append("the streamed peak %d is not below the "
                            "resident %d by the codes' %d bytes"
                            % (s_peak, r_peak, codes_bytes))
        if streamed["device_data_bytes"]["mode"] != "streamed":
            problems.append("the streamed learner holds resident rows")
        del sb

        # ---- 4. quantized, streamed against resident ------------------
        q = dict(p0, quantized_grad=True)
        qr, _, qr_s, _ = timed_train(q, ds, loop="generic",
                                     rounds=QUANT_STREAM_ROUNDS)
        qs, q_counts, qs_s, _ = timed_train(
            dict(q, stream_mode="chunked"), ds, rounds=QUANT_STREAM_ROUNDS)
        add(q_counts)
        row["stream_quantized"] = {
            "rounds": QUANT_STREAM_ROUNDS, "grad_bits": 8,
            "s_per_iter": qs_s / QUANT_STREAM_ROUNDS,
            "resident_s_per_iter": qr_s / QUANT_STREAM_ROUNDS,
            "launches": q_counts,
            "model_text_equal": trees_text(qs) == trees_text(qr)}
        if not row["stream_quantized"]["model_text_equal"]:
            problems.append("quantized streamed trees differ from the "
                            "resident chunk run's")
        if q_counts["k3_win"] <= 0:
            problems.append("the quantized streamed run did not launch K3's "
                            "window entry")
        del qr, qs

    # ---- 5. stream_mode=goss ------------------------------------------
    gp = dict(p0, boosting="goss", stream_mode="goss", learning_rate=0.5,
              top_rate=0.2, other_rate=0.1)
    runs = []
    for _ in range(2):
        gb, g_counts, g_s, g_peak = timed_train(gp, ds, rounds=rounds)
        add(g_counts)
        gl = gb._gbdt.learner
        runs.append((gb, g_counts, g_s, g_peak, gl._shard, gl.stream_ws_hits))
    gb, g_counts, g_s, g_peak, gshard, hits = runs[0]
    g_auc = auc_of(gb)
    goss = dict({"settings": {"learning_rate": 0.5, "top_rate": 0.2,
                              "other_rate": 0.1},
                 "launches": g_counts}, **growth(gb, g_counts, g_s))
    goss.update(
        train_s=g_s, s_per_iter=g_s / rounds, peak_device_bytes=g_peak,
        valid_auc=g_auc,
        h2d_bytes_per_iter=gshard.h2d_bytes / rounds,
        h2d_vs_chunked=gshard.h2d_bytes / rounds / max(h2d, 1),
        working_set_rows=int(gshard.working_set()[0].size),
        working_set_hits=hits, overlap_fraction=gshard.overlap_fraction(),
        router_launches=g_counts["route"],
        model_text_equal_run_to_run=trees_text(runs[0][0])
        == trees_text(runs[1][0]))
    row["stream_goss"] = goss
    if not g_auc > 0.7:
        problems.append("streamed GOSS AUC %.5f" % g_auc)
    if not goss["model_text_equal_run_to_run"]:
        problems.append("two streamed GOSS runs grew other trees")
    if hits <= 0 or g_counts["route"] <= 0:
        problems.append("streamed GOSS: %d working-set hits, %d router "
                        "launches" % (hits, g_counts["route"]))
    del runs, gb

    # ---- 6. two-round loading -----------------------------------------
    m = TWO_ROUND_ROWS
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.csv")
        t1 = time.time()
        np.savetxt(path, np.column_stack([y[:m], x[:m]]), fmt="%.9g",
                   delimiter=",")
        write_s = time.time() - t1
        p2 = dict(p0)
        t1 = time.time()
        two = lgb.Dataset(path, params=dict(p2, two_round=True)).construct()
        two_s = time.time() - t1
        t1 = time.time()
        rows = np.loadtxt(path, delimiter=",")
        mem = lgb.Dataset(rows[:, 1:], rows[:, 0], params=p2).construct()
        mem_s = time.time() - t1
        same_bins = bool(
            np.array_equal(two._inner.binned, mem._inner.binned)
            and two._inner.feature_infos() == mem._inner.feature_infos())
        b_two = lgb.train(dict(p2, two_round=True), two, num_boost_round=2)
        b_mem = lgb.train(p2, mem, num_boost_round=2)
        row["two_round"] = {
            "rows": m, "csv_write_s": write_s, "two_round_load_s": two_s,
            "in_memory_load_s": mem_s, "bins_equal": same_bins,
            "model_text_equal": trees_text(b_two) == trees_text(b_mem)}
        if not same_bins or not row["two_round"]["model_text_equal"]:
            problems.append("two_round: bins equal %s, model text equal %s"
                            % (same_bins, row["two_round"]["model_text_equal"]))
        del two, mem, b_two, b_mem
    return row, problems, counts


def f32_threshold_rows(inner, x):
    """(N,) bool: the training rows that lie between a bin's upper bound
    (f64: what the bins, and so the training scores, split at) and its
    f32 rounding (what predict compares raw values with, as in the JAX
    package): predict may send them to the other side of a split on that
    bin, with or without sampling."""
    out = np.zeros(len(x), bool)
    for f, mapper in enumerate(inner.bin_mappers):
        ub = np.asarray(mapper.bin_upper_bound, dtype=np.float64)[:-1]
        ub32 = ub.astype(np.float32).astype(np.float64)
        keep = ub != ub32
        lo, hi = np.minimum(ub, ub32)[keep], np.maximum(ub, ub32)[keep]
        if not len(hi):
            continue
        col = x[:, f].astype(np.float64)
        i = np.minimum(np.searchsorted(hi, col, side="left"), len(hi) - 1)
        out |= (col > lo[i]) & (col <= hi[i])
    return out


# ---- serve: online serving on the card ------------------------------------
# rounds of the served higgs-1m model (bench.py's 500 cut to fit the time
# limit: 100 trees pad to 128); the buckets the registry warms
SERVE_ROUNDS = 100
SERVE_WARM = (1, 16, 256, 4096)
# the parity slices: (rows, slice size) of the 100,000 held-out rows
SERVE_PARITY = ((100_000, 4096), (2048, 16), (2048, 100), (2048, 256),
                (512, 1), (512, 7))
SERVE_LAT_CALLS = 100
SERVE_PROFILE_CALLS = 20
SERVE_HTTP_S = 5.0
SERVE_CLIENTS = 8
SERVE_CANARY_REQUESTS = 500
SERVE_CANARY_WEIGHT = 0.2
SERVE_SHADOW_REQUESTS = 50


def _pcts(samples_s):
    a = np.sort(np.asarray(samples_s, dtype=np.float64)) * 1e3
    if not len(a):
        return {"p50_ms": None, "p99_ms": None}
    return {"p50_ms": float(a[min(len(a) - 1, int(0.50 * len(a)))]),
            "p99_ms": float(a[min(len(a) - 1, int(0.99 * len(a)))])}


def _http(port, method, path, payload=None, timeout=60):
    """(status, parsed JSON or text) of one request to 127.0.0.1:port."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        body = None if payload is None else json.dumps(payload)
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        try:
            return resp.status, json.loads(data)
        except ValueError:
            return resp.status, data.decode()
    finally:
        conn.close()


def _http_load(port, rows, seconds, clients):
    """`clients` threads, each on one keep-alive connection, POST
    /predict with `rows` until `seconds` pass: (requests, errors, client
    latencies in s, wall s)."""
    import http.client
    import threading
    body = json.dumps({"rows": rows})
    lats, errors, lock = [], [0], threading.Lock()
    start = threading.Barrier(clients + 1)
    stop_at = [0.0]

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        mine, bad = [], 0
        start.wait()
        while time.perf_counter() < stop_at[0]:
            t1 = time.perf_counter()
            conn.request("POST", "/predict", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            mine.append(time.perf_counter() - t1)
            bad += resp.status != 200
        conn.close()
        with lock:
            lats.extend(mine)
            errors[0] += bad

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(clients)]
    for t in threads:
        t.start()
    stop_at[0] = time.perf_counter() + seconds
    t0 = time.perf_counter()
    start.wait()
    for t in threads:
        t.join(timeout=seconds + 120)
    return len(lats), errors[0], lats, time.perf_counter() - t0


def serve_phase(torch, lgb, params, ds, xv, yv, reset_counts, read_counts):
    """serve: online serving of a SERVE_ROUNDS-round higgs-1m model on the
    card -- the registry warmed at SERVE_WARM, parity against
    Booster.predict, no entry built after warm-up or on the swap to the
    model's refit, in-process latency per bucket and launches per flush,
    the HTTP server under 8 clients, the canary router and shadow mode,
    and `python -m lightgbm_tpu_torch task=serve` as a subprocess.
    Returns (row, problems, the served Booster)."""
    import signal
    import socket
    import tempfile
    import threading

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lightgbm_tpu_torch.serving import (ModelRegistry, PredictorCache,
                                            ServingApp, make_http_server)

    problems = []
    row = {"phase": "serve", "rounds": SERVE_ROUNDS,
           "warm_buckets": list(SERVE_WARM)}
    t0 = time.time()
    bst = lgb.train(params, ds, num_boost_round=SERVE_ROUNDS)
    torch.cuda.synchronize()
    row["train_s"] = time.time() - t0
    text = bst.model_to_string()
    ref = bst.predict(xv)
    reset_counts()         # the serving path: no hand kernel launches
    marks = [("model", time.time())]

    # -- the CLI: `python -m lightgbm_tpu_torch task=serve` on the card, as
    # a subprocess; started first, so its start-up overlaps the sections
    # below (its warm-up runs beside the parity checks, which time nothing)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    path = os.path.join(tmp, "model.txt")
    with open(path, "w") as fh:
        fh.write(text)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        cli_port = sock.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    # PYTHONFAULTHANDLER: a crash of the server prints every thread's
    # stack into its log, which a failure below reports
    env = dict(os.environ, PYTHONFAULTHANDLER="1", PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t_cli = time.time()
    log_path = os.path.join(tmp, "serve.log")
    log_fh = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", "task=serve",
         "input_model=" + path, "serve_port=%d" % cli_port],
        cwd=root, env=env, stdout=log_fh, stderr=subprocess.STDOUT)
    try:
        # -- load and warm ----------------------------------------------------
        reg = ModelRegistry(PredictorCache(max_batch_rows=4096),
                            warm_buckets=SERVE_WARM)
        t1 = time.time()
        reg.load(text, version="v1")
        row["load_and_warm_s"] = time.time() - t1
        m = reg.get("v1")
        row["entries"] = [{"bucket": b, "build_ms": e.build_s * 1e3}
                          for _, b, e in reg.predictor.entries()]
        row["model"] = {"trees": m.n_trees,
                        "padded_trees": int(m.arrays.split_feature.shape[0]),
                        "padded_nodes": int(m.arrays.split_feature.shape[1]),
                        "padded_leaves": int(m.arrays.leaf_value.shape[1]),
                        "depth_steps": m.max_depth,
                        "deepest_tree": max(t.depth() for t in
                                            bst._gbdt.models),
                        "device": m.device_key}
        if m.arrays.split_feature.shape[0] != 128:
            problems.append("the padded ensemble has %d trees, want 128"
                            % m.arrays.split_feature.shape[0])
        if m.device_key != "cuda:0":
            problems.append("the model sits on %s" % m.device_key)

        # -- parity: PredictorCache.predict against Booster.predict -----------
        parity = {}
        for rows, step in SERVE_PARITY:
            worst = 0.0
            for i in range(0, rows, step):
                out = reg.predictor.predict(m, xv[i:i + step])
                if not np.all(np.isfinite(out)) or out.shape != (
                        len(xv[i:i + step]), 1):
                    problems.append("slice %d:%d not finite or of shape %s"
                                    % (i, i + step, out.shape))
                    break
                worst = max(worst, float(np.max(np.abs(out[:, 0]
                                                       - ref[i:i + step]))))
            parity["%d rows by %d" % (rows, step)] = worst
            if worst > 1e-6:
                problems.append("predictor vs Booster.predict: %g over %d "
                                "rows in slices of %d (want <= 1e-6)"
                                % (worst, rows, step))
        row["parity_max_abs"] = parity
        marks.append(("parity", time.time()))

        # -- no entry after warm-up; the swap to the refit model builds none --
        builds = reg.predictor.compile_count
        for n in range(1, 257):
            reg.predictor.predict(m, xv[:n])
        row["builds_after_warmup"] = reg.predictor.compile_count - builds
        if row["builds_after_warmup"]:
            problems.append("%d entries built by requests of 1..256 rows "
                            "after warm-up" % row["builds_after_warmup"])
        refit = lgb.Booster(model_str=text)
        t1 = time.time()
        refit.refit(xv, yv, decay_rate=0.9)
        row["refit_s"] = time.time() - t1
        ref2 = refit.predict(xv)
        reg.load(refit.model_to_string(), version="refit", warm=False)
        m2 = reg.get("refit")
        same = (reg.predictor.family(m2, xv.shape[1], False)
                == reg.predictor.family(m, xv.shape[1], False))
        swap_err = 0.0
        for i in range(0, 8192, 4096):
            out = reg.predictor.predict(m2, xv[i:i + 4096])
            swap_err = max(swap_err, float(np.max(np.abs(out[:, 0]
                                                         - ref2[i:i + 4096]))))
        row["swap"] = {"same_family": same,
                       "builds": reg.predictor.compile_count - builds,
                       "max_abs_vs_refit_predict": swap_err,
                       "max_abs_refit_minus_v1": float(np.max(np.abs(
                           ref2[:8192] - ref[:8192])))}
        if not same or row["swap"]["builds"] or swap_err > 1e-6 \
                or row["swap"]["max_abs_refit_minus_v1"] < 1e-4:
            problems.append("swap to the refit model: %s" % row["swap"])
        marks.append(("sweep_and_swap", time.time()))

        # -- in-process latency per bucket, launches per flush ----------------
        lat = {}
        for b in SERVE_WARM:
            xs = xv[:b]
            reg.predictor.predict(m, xs)
            times = []
            for _ in range(SERVE_LAT_CALLS):
                t1 = time.perf_counter()
                reg.predictor.predict(m, xs)
                times.append(time.perf_counter() - t1)
            torch.cuda.synchronize()
            # device activity only, read from the raw kineto events: the
            # host ops' events, and building the profiler's function
            # events, would cost tens of seconds at ~2,000 kernels a flush
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(SERVE_PROFILE_CALLS):
                    reg.predictor.predict(m, xs)
                torch.cuda.synchronize()
            dev = [(e.name(), e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA]
            copies = [d for d in dev
                      if d[0].startswith(("Memcpy", "Memset"))]
            names = {}
            for name, _ in dev:
                names[name[:60]] = names.get(name[:60], 0) + 1
            per = float(SERVE_PROFILE_CALLS)
            lat[b] = dict(_pcts(times), rows_per_s=b * len(times) / sum(times),
                          mean_ms=1e3 * sum(times) / len(times),
                          kernels_per_flush=(len(dev) - len(copies)) / per,
                          copies_per_flush=len(copies) / per,
                          device_ms_per_flush=sum(d[1] for d in dev) / 1e6
                          / per,
                          top=[{"name": k, "calls": v / per} for k, v in
                               sorted(names.items(), key=lambda kv: -kv[1])
                               [:5]])
        row["in_process"] = lat
        marks.append(("in_process", time.time()))

        # -- HTTP: 8 clients for SERVE_HTTP_S s at 1 row, then at 64 rows -----
        http = {}
        for rows in (1, 64):
            app = ServingApp(reg, max_batch=256, max_delay_ms=2.0)
            httpd = make_http_server(app, port=0)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            port = httpd.server_address[1]
            try:
                builds = reg.predictor.compile_count
                n, errs, lats, wall = _http_load(
                    port, xv[:rows].tolist(), SERVE_HTTP_S, SERVE_CLIENTS)
                code_h, health = _http(port, "GET", "/healthz")
                code_s, stats = _http(port, "GET", "/stats")
                code_m, metrics = _http(port, "GET", "/metrics")
                lines = [ln for ln in str(metrics).splitlines()
                         if ln.startswith(("lgbm_tpu_serve_batches_total",
                                           "lgbm_tpu_serve_rows_total",
                                           "lgbm_tpu_serve_requests_total",
                                           "lgbm_tpu_serve_compiles_total",
                                           "lgbm_tpu_predictor_cache_hits"))]
                code_d, drained = _http(port, "POST", "/drain", {})
                c = stats["counters"]
                http["%d_row" % rows] = {
                    "requests": n, "errors": errs, "wall_s": wall,
                    "requests_per_s": n / wall, "rows_per_s": n * rows / wall,
                    "client": _pcts(lats),
                    "stats_request": {k: stats["latency"]["serve_request"][k]
                                      for k in ("p50_ms", "p99_ms", "count")},
                    "stats_batch_exec_p50_ms":
                        stats["latency"]["serve_batch_exec"]["p50_ms"],
                    "rows_per_flush": c["serve_rows"] / max(
                        c["serve_batches"], 1),
                    "flushes": c["serve_batches"],
                    "builds_during_load": reg.predictor.compile_count - builds,
                    "healthz": code_h, "metrics": lines,
                    "drain": [code_d, drained.get("status")]}
                h = http["%d_row" % rows]
                if errs or not n or h["builds_during_load"] or code_h != 200 \
                        or code_s != 200 or len(lines) < 4 or code_d != 200 \
                        or drained.get("status") != "draining":
                    problems.append("HTTP at %d rows: %s" % (rows, h))
            finally:
                httpd.shutdown()
                httpd.server_close()
                app.close()
        row["http"] = http
        marks.append(("http", time.time()))

        # -- canary and shadow ------------------------------------------------
        app = ServingApp(reg, max_batch=256, max_delay_ms=2.0)
        # no auto-promotion within the run
        app.router.min_requests = 10 * SERVE_CANARY_REQUESTS
        httpd = make_http_server(app, port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        port = httpd.server_address[1]
        try:
            app.router_action({"action": "stable", "version": "v1"})
            app.router_action({"action": "deploy", "version": "refit",
                               "weight": SERVE_CANARY_WEIGHT})
            answers = [None] * SERVE_CANARY_REQUESTS
            nxt, lock = [0], threading.Lock()

            def canary_client():
                while True:
                    with lock:
                        i = nxt[0]
                        nxt[0] += 1
                    if i >= SERVE_CANARY_REQUESTS:
                        return
                    out = app.predict({"rows": xv[i:i + 1].tolist()})
                    answers[i] = (out["version"], out["predictions"][0])

            threads = [threading.Thread(target=canary_client, daemon=True)
                       for _ in range(SERVE_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            versions = [a[0] if a else None for a in answers]
            want = {"v1": ref, "refit": ref2}
            wrong = sum(1 for i, a in enumerate(answers) if a is None
                        or abs(a[1] - want[a[0]][i]) > 1e-6)
            canary = {"requests": SERVE_CANARY_REQUESTS,
                      "weight": SERVE_CANARY_WEIGHT,
                      "answered_by_canary": versions.count("refit"),
                      "answered_by_stable": versions.count("v1"),
                      "wrong_answers": wrong}
            app.router_action({"action": "promote"})
            app.router_action({"action": "deploy", "version": "v1",
                               "weight": SERVE_CANARY_WEIGHT})
            app.router_action({"action": "demote", "reason": "chip_smoke"})
            code_a, audit = _http(port, "GET", "/router/audit")
            actions = [d["action"] for d in audit.get("decisions", [])]
            canary["audit"] = actions
            # shadow: the canary sees mirrored copies and answers none
            app.router_action({"action": "deploy", "version": "v1",
                               "shadow": True})
            shadow_versions = [app.predict({"rows": xv[i:i + 1].tolist()})
                               ["version"]
                               for i in range(SERVE_SHADOW_REQUESTS)]
            deadline = time.time() + 30
            while time.time() < deadline:
                mirrored = (app.stats.snapshot()["versions"].get("v1") or {}) \
                    .get("requests", 0) - versions.count("v1")
                if mirrored >= SERVE_SHADOW_REQUESTS:
                    break
                time.sleep(0.05)
            canary["shadow"] = {
                "requests": SERVE_SHADOW_REQUESTS,
                "answered_by": sorted(set(shadow_versions)),
                "mirrored": app.stats.get("serve_shadow_mirrored"),
                "shadow_version_requests": mirrored}
            row["canary"] = canary
            if canary["answered_by_canary"] != int(
                    SERVE_CANARY_REQUESTS * SERVE_CANARY_WEIGHT) or wrong \
                    or code_a != 200 or "promote" not in actions \
                    or "demote" not in actions \
                    or canary["shadow"]["answered_by"] != ["refit"] \
                    or canary["shadow"]["mirrored"] != SERVE_SHADOW_REQUESTS \
                    or mirrored < SERVE_SHADOW_REQUESTS:
                problems.append("canary / shadow: %s" % canary)
        finally:
            httpd.shutdown()
            httpd.server_close()
            app.close()
        row["cache_info"] = reg.predictor.cache_info()
        marks.append(("canary_shadow", time.time()))

        # -- the CLI: the task=serve subprocess started above -----------------
        cli = {}
        try:
            while time.time() - t_cli < 180 and proc.poll() is None:
                try:
                    if _http(cli_port, "GET", "/healthz",
                             timeout=5)[0] == 200:
                        break
                except OSError:
                    pass
                time.sleep(0.25)
            cli["ready_s"] = time.time() - t_cli
            code_p, out = _http(cli_port, "POST", "/predict",
                                {"rows": xv[:5].tolist()})
            inproc = reg.predictor.predict(m, xv[:5])[:, 0]
            cli["predict"] = code_p
            cli["max_abs_vs_in_process"] = float(np.max(np.abs(
                np.asarray(out["predictions"]) - inproc))) \
                if code_p == 200 else None
            code_d, drained = _http(cli_port, "POST", "/drain", {})
            cli["drain"] = [code_d, drained.get("status")]
            proc.send_signal(signal.SIGINT)
            cli["exit"] = proc.wait(timeout=60)
        except Exception as e:   # noqa: BLE001 — reported as a problem below
            cli["error"] = repr(e)
        row["cli"] = cli
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        log_fh.close()
        with open(log_path) as fh:
            log_tail = fh.read()[-2000:]
        shutil.rmtree(tmp, ignore_errors=True)
    cli = row["cli"]
    if cli.get("predict") != 200 or cli.get("max_abs_vs_in_process") is None \
            or cli["max_abs_vs_in_process"] > 1e-6 \
            or cli.get("drain") != [200, "draining"] or cli.get("exit") != 0:
        problems.append("task=serve subprocess: %s; its log: %s"
                        % (cli, log_tail))
    counts = read_counts()
    row["hand_kernel_launches"] = {k: v for k, v in counts.items()
                                   if not k.endswith("rows")
                                   and not k.endswith("rows_win")}
    if any(row["hand_kernel_launches"].values()):
        problems.append("the serving path launched hand kernels: %s"
                        % row["hand_kernel_launches"])
    marks.append(("cli", time.time()))
    row["section_s"] = dict(
        [("train_predict", marks[0][1] - t0)]
        + [(b[0], b[1] - a[1]) for a, b in zip(marks, marks[1:])])
    row["phase_s"] = time.time() - t0
    return row, problems, bst


# ---- fleet: the fleet and the continual loop on the card -------------------
# rounds of the fleet's model when the serve phase did not run in the call
FLEET_ROUNDS = 20
FLEET_WARM = (1, 16, 256)
# the manifest's replica weights (A, B) and the gateway's one-row requests
FLEET_WEIGHTS = (1.0, 3.0)
FLEET_SPLIT_REQUESTS = 400
FLEET_PARITY_ROWS = 2048
FLEET_POLL_S = 0.5
FLEET_CANARY_WEIGHT = 0.2
# the continual episode: the appended rows, the top-up rounds, the drifted
# traffic per fire (one drift window), the canary's requests and labels
FLEET_APPEND_ROWS = 100_000
FLEET_TOPUP_ROUNDS = 10
FLEET_DRIFT_ROWS = 512
FLEET_CANARY_REQUESTS = 100
FLEET_FEEDBACK_ROWS = 256


def drifted_rows(n, f, w, seed, shift=1.0):
    """Rows of the higgs-1m ground truth w whose first four features are
    shifted by `shift` (covariate drift), with their labels."""
    r = np.random.RandomState(seed)
    x = r.randn(n, f).astype(np.float32)
    x[:, :4] += shift
    noisy = higgs_margin(x, w) + r.randn(n) * 1.5
    return x, (noisy > 0).astype(np.float64)


def _wait_ready(port, proc, t0, limit=240):
    """Seconds from t0 until 127.0.0.1:port answers /healthz with 200,
    or None when the process died or the limit passed."""
    while time.time() - t0 < limit and proc.poll() is None:
        try:
            if _http(port, "GET", "/healthz", timeout=5)[0] == 200:
                return time.time() - t0
        except OSError:
            pass
        time.sleep(0.1)
    return None


def _metric(text, name):
    for ln in str(text).splitlines():
        if ln.startswith(name + " "):
            return float(ln.split()[-1])
    return 0.0


def _post_raw(port, path, body, content_type, timeout=60):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": content_type})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def fleet_phase(torch, lgb, params, ds, xv, yv, w, src, reset_counts,
                read_counts):
    """fleet: two `task=serve` replicas following a fleet manifest with
    the persistent entry cache, a `task=gateway` over them, a canary
    rollout through the manifest, a rolling restart under traffic, an
    in-process continual episode (drift -> refit -> promote, drift again
    -> 100,000 appended rows and a 10-round continuation -> promote) and
    `task=continual` as a subprocess. `src`: the serve phase's (model
    text, drift baseline), or None (train FLEET_ROUNDS rounds here).
    Appends rows to `ds`. Returns (row, problems, the continuation's
    launch counts)."""
    import signal
    import socket
    import tempfile
    import threading

    from lightgbm_tpu_torch import telemetry
    from lightgbm_tpu_torch.continual.loop import ContinualLoop
    from lightgbm_tpu_torch.continual.update import (append_rows,
                                                     continue_training)
    from lightgbm_tpu_torch.fleet import ManifestPublisher, load_manifest
    from lightgbm_tpu_torch.serving import (DriftMonitor, ModelRegistry,
                                            PredictorCache, ServingApp,
                                            make_http_server)
    from lightgbm_tpu_torch.serving.drift import save_baseline
    from lightgbm_tpu_torch.serving.transforms import (capture_transform,
                                                       save_transform)
    from lightgbm_tpu_torch.telemetry import watchdogs

    problems = []
    row = {"phase": "fleet", "warm_buckets": list(FLEET_WARM),
           "weights": list(FLEET_WEIGHTS)}
    t0 = time.time()
    marks = []
    f = xv.shape[1]
    if src is None:
        bst = lgb.train(params, ds, num_boost_round=FLEET_ROUNDS)
        src = (bst.model_to_string(), bst._gbdt.drift_baseline())
        del bst
        row["model"] = "trained here, %d rounds" % FLEET_ROUNDS
    else:
        row["model"] = "the serve phase's"
    text, baseline = src
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    v1 = os.path.join(tmp, "v1.txt")
    with open(v1, "w") as fh:
        fh.write(text)
    save_baseline(baseline, v1 + ".drift.json")
    save_transform(capture_transform(ds), v1 + ".transform.json")
    manifest = os.path.join(tmp, "fleet_manifest.json")
    ports = []
    for _ in range(4):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    pa, pb, pg, pc = ports
    urls = ["http://127.0.0.1:%d" % p for p in (pa, pb)]
    pub = ManifestPublisher(manifest)
    pub.seed({"v1": v1}, stable="v1",
             replicas=[{"url": u, "weight": wt}
                       for u, wt in zip(urls, FLEET_WEIGHTS)])
    # the continual subprocess's data= file (re-read at every retrain;
    # this smoke only starts and stops it)
    data_csv = os.path.join(tmp, "extract.csv")
    np.savetxt(data_csv, np.column_stack([yv[:1000], xv[:1000]]),
               delimiter=",", fmt="%.7g")
    marks.append(("files", time.time()))

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONFAULTHANDLER="1", PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs, logs = {}, {}

    def spawn(name, args):
        log_path = os.path.join(tmp, "%s.log" % name)
        if name in logs:
            logs[name][1].close()
        fh = open(log_path, "a")
        fh.write("---- %s\n" % " ".join(args))
        fh.flush()
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "lightgbm_tpu_torch"] + args, cwd=root,
            env=env, stdout=fh, stderr=subprocess.STDOUT), time.time())
        logs[name] = (log_path, fh)

    def replica(port, cache="auto", publish=False):
        return (["task=serve", "serve_manifest=" + manifest,
                 "serve_export_cache=" + cache, "serve_port=%d" % port,
                 "serve_manifest_poll_s=%g" % FLEET_POLL_S,
                 "serve_warm_buckets=" + ",".join(map(str, FLEET_WARM))]
                + (["serve_manifest_publish=1"] if publish else []))

    def stop(name):
        proc = procs[name][0]
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
        try:
            return proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            return proc.wait(timeout=30)

    # the subprocesses first, so their start-up overlaps the in-process
    # continual episode below
    spawn("A", replica(pa, publish=True))
    spawn("B", replica(pb))
    spawn("gateway", ["task=gateway", "gateway_manifest=" + manifest,
                      "gateway_port=%d" % pg, "gateway_retries=2",
                      "gateway_backoff_ms=10",
                      "gateway_health_period_s=%g" % FLEET_POLL_S])
    spawn("continual", ["task=continual", "input_model=" + v1,
                        "data=" + data_csv, "serve_port=%d" % pc,
                        "serve_warm_buckets=1", "continual_poll_s=1"])
    retrain_log, tails = {}, {}

    def wait_for(pred, limit=30):
        t1 = time.time()
        while time.time() - t1 < limit:
            if pred():
                return time.time() - t1
            time.sleep(0.02)
        return None

    try:
        # -- the continual episode, in process on the card ------------------
        ep = {}
        telemetry.events.enable(True)
        telemetry.events.reset()
        watchdogs.reset()
        reg = ModelRegistry(PredictorCache(max_batch_rows=4096),
                            warm_buckets=(1, 256))
        app = ServingApp(reg, drift=DriftMonitor(baseline, min_interval_s=0),
                         max_batch=256, max_delay_ms=1.0)
        httpd = make_http_server(app, port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        app_port = httpd.server_address[1]
        # the gate promotes on labels: 20 canary requests, then 256
        # labels per version through POST /feedback (the canary's
        # latency is not what this episode judges)
        app.router.min_requests = FLEET_CANARY_REQUESTS // 5
        app.router.feedback_min_labels = FLEET_FEEDBACK_ROWS
        app.router.p99_ratio = 100.0
        reg.load(text, version="base")
        app.router.set_stable("base")
        rows_before = ds.num_data()
        x_new, y_new = drifted_rows(FLEET_APPEND_ROWS, f, w, seed=606)

        def retrain(action):
            stable_text = reg.get(app.router.stable).gbdt \
                .save_model_to_string(num_iteration=-1)
            prev = lgb.Booster(model_str=stable_text)
            t1 = time.time()
            if action == "refit":
                out = prev.refit(x_new[:FLEET_APPEND_ROWS // 10],
                                 y_new[:FLEET_APPEND_ROWS // 10],
                                 decay_rate=0.9)
                torch.cuda.synchronize()
                retrain_log["refit_s"] = time.time() - t1
                return out
            append_rows(ds, x_new, y_new)
            retrain_log["append_s"] = time.time() - t1
            retrain_log["stable_text"] = stable_text
            torch.cuda.synchronize()
            reset_counts()
            t1 = time.time()
            out = continue_training(prev, ds, FLEET_TOPUP_ROUNDS,
                                    params=params)
            torch.cuda.synchronize()
            retrain_log["continue_s"] = time.time() - t1
            retrain_log["counts"] = read_counts()
            return out

        clock = [0.0]
        loop = ContinualLoop(reg, app.router, retrain, policy="auto",
                             cooldown_s=30.0,
                             canary_weight=FLEET_CANARY_WEIGHT,
                             checkpoint_dir=os.path.join(tmp, "ckpt"),
                             time_fn=lambda: clock[0])

        def episode(n, now, seed):
            te = time.time()
            xd, _ = drifted_rows(FLEET_DRIFT_ROWS, f, w, seed=seed)
            for i in range(0, FLEET_DRIFT_ROWS, 128):
                app.predict({"rows": xd[i:i + 128].tolist()})
            app.drift.check_now()
            fires = watchdogs.fired().get("drift_psi", 0)
            clock[0] = now
            step = loop.step()
            canary = app.router.canary
            xc, _ = drifted_rows(FLEET_CANARY_REQUESTS, f, w,
                                 seed=seed + 1)
            answered = [app.predict({"rows": xc[i:i + 1].tolist()})
                        ["version"] for i in range(FLEET_CANARY_REQUESTS)]
            held = app.router.canary == canary
            xf, yf = drifted_rows(FLEET_FEEDBACK_ROWS, f, w, seed=seed + 2)
            auc_of = {}
            for v in (app.router.stable, canary):
                # scored beside the app, so the drift monitor sees only
                # the traffic above
                scores = reg.predictor.predict(reg.get(v), xf)[:, 0] \
                    .tolist()
                auc_of[v] = auc(yf, np.asarray(scores))
                code, _ = _http(app_port, "POST", "/feedback",
                                {"version": v, "labels": yf.tolist(),
                                 "scores": scores})
                if code != 200:
                    problems.append("POST /feedback answered %d" % code)
            outcome = loop.step()
            ep[n] = {"fires": fires, "step": step, "canary": canary,
                     "canary_answers": answered.count(canary),
                     "held_before_labels": held,
                     "feedback_auc": auc_of, "outcome": outcome,
                     "stable_after": app.router.stable,
                     "episode_s": time.time() - te}

        episode(1, 100.0, 700)
        episode(2, 160.0, 800)
        events = [(e["kind"], e.get("action"))
                  for e in telemetry.events.events()
                  if e["kind"].startswith("continual_")
                  and e["kind"] != "continual_append"]
        telemetry.events.enable(False)
        want_events = [ev for a in ("refit", "continue") for ev in (
            ("continual_fire", a), ("continual_retrain", a),
            ("continual_deploy", None), ("continual_promote", a))]
        # the continuation against engine.train run directly on the same
        # appended rows from the same stable model
        counts = retrain_log.get("counts", {})
        cont = reg.get(ep[2]["canary"]).gbdt.save_model_to_string(
            num_iteration=-1) if ep[2]["canary"] else ""
        t1 = time.time()
        direct = lgb.train(params, ds, FLEET_TOPUP_ROUNDS,
                           init_model=lgb.Booster(
                               model_str=retrain_log.get("stable_text", "")))
        torch.cuda.synchronize()
        direct_s = time.time() - t1
        direct_text = direct._gbdt.save_model_to_string(num_iteration=-1)
        del direct
        ckpts = sorted(os.listdir(os.path.join(tmp, "ckpt"))) \
            if os.path.isdir(os.path.join(tmp, "ckpt")) else []
        row["continual"] = {
            "episodes": ep, "events": [list(e) for e in events],
            "refit_s": retrain_log.get("refit_s"),
            "append_s": retrain_log.get("append_s"),
            "rows_after_append": ds.num_data(),
            "continue_s": retrain_log.get("continue_s"),
            "s_per_topup_iteration": (retrain_log.get("continue_s") or 0)
            / FLEET_TOPUP_ROUNDS,
            "direct_train_s": direct_s,
            "launches": {k: counts.get(k) for k in (
                "k1_win", "k4_win", "split_key", "k1", "k4")},
            "text_equal_to_direct": cont == direct_text,
            "checkpoints": ckpts}
        c = row["continual"]
        if [e for e in events] != want_events:
            problems.append("continual events %s, want %s"
                            % (events, want_events))
        for n, action in ((1, "refit"), (2, "continue")):
            e = ep[n]
            if e["fires"] != n or e["step"] != "deployed" \
                    or e["outcome"] != "promoted" \
                    or e["stable_after"] != e["canary"] \
                    or not e["held_before_labels"] \
                    or e["canary_answers"] != int(
                        FLEET_CANARY_REQUESTS * FLEET_CANARY_WEIGHT):
                problems.append("continual episode %d (%s): %s"
                                % (n, action, e))
        if not counts.get("k1_win") or not counts.get("k4_win") \
                or not counts.get("split_key"):
            problems.append("the continuation launched K1 %s, K4 %s, the "
                            "split key %s" % (counts.get("k1_win"),
                                              counts.get("k4_win"),
                                              counts.get("split_key")))
        if not c["text_equal_to_direct"]:
            problems.append("the continuation's model text differs from "
                            "engine.train(init_model=stable) run directly")
        if c["rows_after_append"] != rows_before + FLEET_APPEND_ROWS \
                or len([n for n in ckpts if n.endswith(".txt")]) != 2:
            problems.append("continual rows %d, checkpoints %s"
                            % (c["rows_after_append"], ckpts))
        httpd.shutdown()
        httpd.server_close()
        app.close()
        watchdogs.reset()
        marks.append(("continual", time.time()))

        # -- every subprocess ready ------------------------------------------
        ready = {}
        for name, port in (("A", pa), ("B", pb), ("continual", pc)):
            ready[name] = _wait_ready(port, procs[name][0], procs[name][1])
        t_gw = procs["gateway"][1]
        while time.time() - t_gw < 120 and procs["gateway"][0].poll() is None:
            try:
                if _http(pg, "GET", "/gateway", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.1)
        ready["gateway"] = time.time() - t_gw
        row["ready_s"] = ready
        if None in ready.values():
            raise RuntimeError("a subprocess did not come up: %s" % ready)
        # the gateway's health sweep has seen both replicas up (one that
        # it found unreachable during start-up is ejected until then)
        if wait_for(lambda: all(r["healthy"] for r in _http(
                pg, "GET", "/stats")[1]["replicas"])) is None:
            raise RuntimeError("the gateway never saw both replicas "
                               "healthy")
        marks.append(("ready", time.time()))

        # -- the gateway: parity, CSV through the edge transform, the split --
        ref = lgb.Booster(model_str=text).predict(xv[:FLEET_PARITY_ROWS])
        got_json, got_csv = [], []
        for i in range(0, FLEET_PARITY_ROWS, 256):
            rows = xv[i:i + 256]
            code, out = _http(pg, "POST", "/predict",
                              {"rows": rows.tolist()})
            got_json.extend(out["predictions"] if code == 200 else
                            [np.nan] * len(rows))
            csv = "\n".join(",".join("%.9g" % v for v in r) for r in rows)
            code, out = _post_raw(pg, "/predict", csv.encode(), "text/csv")
            got_csv.extend(out["predictions"] if code == 200 else
                           [np.nan] * len(rows))
        got_json, got_csv = np.asarray(got_json), np.asarray(got_csv)
        gw = {"parity_max_abs": float(np.max(np.abs(got_json - ref))),
              "csv_equal_json": bool(np.array_equal(got_csv, got_json))}
        if not gw["parity_max_abs"] <= 1e-6 or not gw["csv_equal_json"]:
            problems.append("gateway parity: %s" % gw)
        _, before = _http(pg, "GET", "/stats")
        picks0 = {r["url"]: r["picks"] for r in before["replicas"]}
        lats, errs, nxt, lock = [], [0], [0], threading.Lock()

        def split_client():
            mine, bad = [], 0
            while True:
                with lock:
                    i = nxt[0]
                    nxt[0] += 1
                if i >= FLEET_SPLIT_REQUESTS:
                    break
                t1 = time.perf_counter()
                code, _ = _http(pg, "POST", "/predict",
                                {"rows": xv[i:i + 1].tolist()})
                mine.append(time.perf_counter() - t1)
                bad += code != 200
            with lock:
                lats.extend(mine)
                errs[0] += bad

        threads = [threading.Thread(target=split_client, daemon=True)
                   for _ in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        _, after = _http(pg, "GET", "/stats")
        split = {r["url"]: r["picks"] - picks0.get(r["url"], 0)
                 for r in after["replicas"]}
        gw["split"] = [split.get(u) for u in urls]
        gw["split_errors"] = errs[0]
        gw["one_row"] = _pcts(lats)
        row["gateway"] = gw
        want_split = [int(FLEET_SPLIT_REQUESTS * wt / sum(FLEET_WEIGHTS))
                      for wt in FLEET_WEIGHTS]
        if gw["split"] != want_split or errs[0]:
            problems.append("gateway split %s, %d errors (want %s)"
                            % (gw["split"], errs[0], want_split))
        marks.append(("gateway", time.time()))

        # -- the rollout through the manifest --------------------------------
        x_ref, y_ref = x_new[:FLEET_APPEND_ROWS], y_new[:FLEET_APPEND_ROWS]
        v2 = os.path.join(tmp, "v2.txt")
        lgb.Booster(model_str=text).refit(x_ref, y_ref, decay_rate=0.9) \
            .save_model(v2)
        roll = {}

        def router_of(port):
            return _http(port, "GET", "/router")[1]

        def canary_v2(m):
            m["models"]["v2"] = v2
            m["canary"] = {"version": "v2", "weight": FLEET_CANARY_WEIGHT,
                           "shadow": False}

        # one rev: the model's file and its canary slot
        t1 = time.time()
        pub.update(canary_v2)
        roll["rev_published"] = load_manifest(manifest)["rev"]
        roll["canary_convergence_s"] = wait_for(
            lambda: all(router_of(p)["canary"] == "v2" for p in (pa, pb)))
        code, _ = _http(pa, "POST", "/router", {"action": "promote"})
        t1 = time.time()
        reached = wait_for(lambda: router_of(pb)["stable"] == "v2")
        roll["promote_reached_b_s"] = reached
        roll["manifest_after_promote"] = {
            k: load_manifest(manifest)[k] for k in ("rev", "stable",
                                                     "canary")}
        revs = roll["manifest_after_promote"]["rev"]
        # A's follower applies its own publication at its next poll
        roll["last_rev_applied_s"] = wait_for(lambda: all(
            _metric(_http(p, "GET", "/metrics")[1],
                    "lgbm_tpu_manifest_rev") == revs for p in (pa, pb)))
        applies = {}
        for name, port in (("A", pa), ("B", pb)):
            metrics = _http(port, "GET", "/metrics")[1]
            audit = _http(port, "GET", "/router/audit")[1]
            applies[name] = {
                "manifest_applies": _metric(
                    metrics, "lgbm_tpu_manifest_applies_total"),
                "manifest_rev": _metric(metrics, "lgbm_tpu_manifest_rev"),
                "audit": [d["action"] for d in audit["decisions"]]}
        roll["replicas"] = applies
        row["rollout"] = roll
        for name, a in applies.items():
            if a["manifest_applies"] != revs or a["manifest_rev"] != revs \
                    or a["audit"][-2:] != ["deploy", "promote"]:
                problems.append("replica %s after the rollout: %s (want %d "
                                "applies, one per rev)" % (name, a, revs))
        if code != 200 or roll["canary_convergence_s"] is None \
                or roll["manifest_after_promote"]["stable"] != "v2" \
                or reached is None or reached > 2 * FLEET_POLL_S:
            problems.append("rollout: %s" % roll)
        marks.append(("rollout", time.time()))

        # -- rolling restart of B under traffic ------------------------------
        rs = {}
        stop_traffic = threading.Event()
        tally = {"ok": 0, "errors": 0}

        def traffic(seed):
            r = np.random.RandomState(seed)
            while not stop_traffic.is_set():
                i = int(r.randint(0, len(xv)))
                try:
                    code, _ = _http(pg, "POST", "/predict",
                                    {"rows": xv[i:i + 1].tolist()})
                except OSError:
                    code = None
                with lock:
                    tally["ok" if code == 200 else "errors"] += 1

        def gw_replica(url):
            return next(r for r in _http(pg, "GET", "/stats")[1]["replicas"]
                        if r["url"] == url)

        def set_weight(url, weight):
            def fn(m):
                for r in m["replicas"]:
                    if r["url"] == url:
                        r["weight"] = weight
            pub.update(fn)

        retries0 = _http(pg, "GET", "/stats")[1]["counters"][
            "gateway_retries"]
        threads = [threading.Thread(target=traffic, args=(s,), daemon=True)
                   for s in range(4)]
        for t in threads:
            t.start()
        # out of rotation first (the gateway re-reads the manifest every
        # sweep), then drained, stopped and restarted on the same cache
        set_weight(urls[1], 0.0)
        wait_for(lambda: gw_replica(urls[1])["weight"] == 0.0)
        last = [gw_replica(urls[1])["picks"]]

        def b_idle():
            time.sleep(1.0)
            now = gw_replica(urls[1])["picks"]
            idle, last[0] = now == last[0], now
            return idle
        wait_for(b_idle)
        code, drained = _http(pb, "POST", "/drain", {})
        rs["drain"] = [code, drained.get("status")]
        rs["b_exit"] = stop("B")
        set_weight(urls[1], FLEET_WEIGHTS[1])
        spawn("B", replica(pb))
        rs["ready_with_cache_s"] = _wait_ready(pb, procs["B"][0],
                                               procs["B"][1])
        wait_for(lambda: gw_replica(urls[1])["healthy"])
        picks_b = gw_replica(urls[1])["picks"]
        wait_for(lambda: gw_replica(urls[1])["picks"] >= picks_b + 20)
        stop_traffic.set()
        for t in threads:
            t.join(timeout=60)
        st = _http(pb, "GET", "/stats")[1]
        metrics = _http(pb, "GET", "/metrics")[1]
        models = len(st["models"])
        rs.update({
            "client_ok": tally["ok"], "client_errors": tally["errors"],
            "gateway_retries": _http(pg, "GET", "/stats")[1]["counters"][
                "gateway_retries"] - retries0,
            "b_models": models,
            "export_cache_hits": _metric(
                metrics, "lgbm_tpu_export_cache_hits_total"),
            "export_cache_misses": _metric(
                metrics, "lgbm_tpu_export_cache_misses_total"),
            "b_entries_built": st["predictor_cache"]["compiles"],
            "b_entries": st["predictor_cache"]["entries"],
            "b_requests_after_restart": gw_replica(urls[1])["picks"]
            - picks_b})
        want_hits = models * len(FLEET_WARM)
        if rs["client_errors"] or rs["b_exit"] != 0 \
                or rs["drain"] != [200, "draining"] \
                or rs["export_cache_hits"] != want_hits \
                or rs["export_cache_misses"] or rs["b_entries_built"] \
                or rs["b_requests_after_restart"] < 20 \
                or rs["ready_with_cache_s"] is None:
            problems.append("rolling restart: %s (want %d hits)"
                            % (rs, want_hits))
        # the same restart on a fresh cache directory: time to ready only
        rs["b_exit_2"] = stop("B")
        spawn("B", replica(pb, cache=os.path.join(tmp, "fresh.xcache")))
        rs["ready_without_cache_s"] = _wait_ready(pb, procs["B"][0],
                                                  procs["B"][1])
        st = _http(pb, "GET", "/stats")[1]
        rs["fresh_entries_built"] = st["predictor_cache"]["compiles"]
        row["restart"] = rs
        if rs["ready_without_cache_s"] is None \
                or not rs["fresh_entries_built"]:
            problems.append("restart without the cache: %s" % rs)
        marks.append(("restart", time.time()))

        # -- task=continual: answers, exits 0 on SIGINT ----------------------
        code, health = _http(pc, "GET", "/healthz")
        row["cli_continual"] = {"healthz": code, "exit": stop("continual")}
        if code != 200 or row["cli_continual"]["exit"] != 0:
            problems.append("task=continual: %s" % row["cli_continual"])
    except Exception as e:   # noqa: BLE001 — reported as a problem below
        import traceback
        problems.append("fleet phase raised %r: %s"
                        % (e, traceback.format_exc()[-1500:]))
    finally:
        exits = {name: stop(name) for name in list(procs)}
        row["exits"] = exits
        for name, (log_path, fh) in logs.items():
            fh.close()
            with open(log_path) as fh2:
                log_text = fh2.read()
            tails[name] = log_text[-1500:]
            bad = [ln for ln in log_text.splitlines()
                   if "[Warning] manifest:" in ln or "Traceback" in ln]
            if bad:
                problems.append("%s logged %s; its log: %s"
                                % (name, bad[:3], tails[name]))
        shutil.rmtree(tmp, ignore_errors=True)
    if any(v != 0 for v in row["exits"].values()):
        problems.append("subprocess exits %s; logs: %s"
                        % (row["exits"], tails))
    marks.append(("stop", time.time()))
    row["section_s"] = dict(
        [("files", marks[0][1] - t0)]
        + [(b[0], b[1] - a[1]) for a, b in zip(marks, marks[1:])])
    row["phase_s"] = time.time() - t0
    return row, problems, retrain_log.get("counts", {})


def booster_api_phase(torch, lgb, params, ds, bst, x, y, xv, yv, rounds,
                      reset_counts, read_counts):
    """booster_api: the Booster and Dataset surface on the train phase's
    Booster (`bst`, higgs-1m, `rounds` rounds on the card) and its 100,000
    held-out rows. Returns (row, problems); `bst` has freed its dataset on
    return."""
    import pickle
    import tempfile

    from lightgbm_tpu_torch.continual import refit as crefit
    from lightgbm_tpu_torch.io import parser as io_parser

    problems = []
    dev = bst.device
    text = bst.model_to_string()
    cpu = lgb.Booster(model_str=text, device="cpu")

    def card_ms(fn):
        torch.cuda.synchronize()
        t1 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.time() - t1) * 1e3

    # -- pred_leaf: the card's walk against the CPU's, and the leaf sums
    leaf = {}
    for name, rows in (("held_out", xv), ("training", x)):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got, ms = card_ms(lambda: bst.predict(rows, pred_leaf=True))
        peak = int(torch.cuda.max_memory_allocated()) - base
        want = cpu.predict(rows, pred_leaf=True)
        unequal = int(np.sum(got != want))
        vals = np.stack([t.leaf_value[got[:, i]].astype(np.float32)
                         for i, t in enumerate(bst._gbdt.models)], 1)
        sums = np.zeros(len(rows), np.float32)
        for i in range(vals.shape[1]):
            sums += vals[:, i]
        raw = bst.predict(rows, raw_score=True)
        err = float(np.max(np.abs(sums - raw)))
        leaf[name] = {"rows": len(rows), "trees": got.shape[1], "ms": ms,
                      "peak_device_bytes_over_base": peak,
                      "leaves_unequal_to_cpu": unequal,
                      "leaf_sum_vs_raw_max_abs": err}
        if unequal or got.shape != (len(rows), bst.num_trees()):
            problems.append("pred_leaf on the %s rows: %d leaves differ "
                            "from the CPU's" % (name, unequal))
        if not err <= 1e-5:
            problems.append("pred_leaf on the %s rows: the leaf values sum "
                            "%g off the raw score" % (name, err))

    # -- pred_early_stop (freq 2, margin 2.0) against the CPU
    kw = dict(raw_score=True, pred_early_stop=True, pred_early_stop_freq=2,
              pred_early_stop_margin=2.0)
    got, es_ms = card_ms(lambda: bst.predict(xv, **kw))
    used = bst._gbdt.last_early_stop_trees
    want = cpu.predict(xv, **kw)
    used_cpu = cpu._gbdt.last_early_stop_trees
    other = np.nonzero(used != used_cpu)[0]
    same = used == used_cpu
    es_err = float(np.max(np.abs(got[same] - want[same]), initial=0.0))
    # a row that stopped on one device only: its margin at the first chunk
    # where they parted must lie within 1e-5 of the bound
    near = 0
    for i in other:
        its = int(min(used[i], used_cpu[i]))
        m = 2.0 * abs(float(cpu.predict(xv[i:i + 1], raw_score=True,
                                        num_iteration=its)[0]))
        near += abs(m - 2.0) <= 1e-5
    stopped = float(np.mean(used < bst.num_trees()))
    early = {"freq": 2, "margin": 2.0, "ms": es_ms,
             "stopped_share": stopped,
             "stopped_share_cpu": float(np.mean(used_cpu
                                                < bst.num_trees())),
             "rows_stopped_on_one_device": len(other),
             "of_them_within_1e-5_of_the_bound": int(near),
             "max_abs_vs_cpu": es_err}
    if es_err > 1e-5 or near != len(other):
        problems.append("pred_early_stop: %g off the CPU, %d of %d rows "
                        "that stopped on one device away from the bound"
                        % (es_err, len(other) - near, len(other)))

    # -- pred_contrib on 20 held-out rows, the first 3 trees
    moved = f32_threshold_rows(ds._inner, xv)
    rows20 = xv[np.nonzero(~moved)[0][:20]]
    t1 = time.time()
    contrib = bst.predict(rows20, pred_contrib=True, num_iteration=3)
    contrib_s = time.time() - t1
    raw3 = bst.predict(rows20, raw_score=True, num_iteration=3)
    c_err = float(np.max(np.abs(contrib.sum(axis=1) - raw3)))
    shap = {"rows": 20, "trees": 3, "s_per_row_per_tree":
            contrib_s / 60.0, "sum_vs_raw_max_abs": c_err,
            "f32_threshold_rows_left_out": int(moved.sum())}
    if not c_err <= 1e-5 or contrib.shape != (20, x.shape[1] + 1):
        problems.append("pred_contrib: rows sum %g off the raw score"
                        % c_err)

    # -- refit on the held-out rows at decay 0.9: the device sums against
    # the host loop
    refit_params = dict(params)
    auc_before = auc(yv, bst.predict(xv))
    dev_b = lgb.Booster(params=refit_params, model_str=text, device=dev)
    timing = {}
    stats_fn, apply_fn = crefit.leaf_stats, crefit.apply_leaf_values

    def timed_stats(*a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        out = stats_fn(*a, **k)
        e1.record()
        torch.cuda.synchronize()
        timing["stats_device_ms"] = e0.elapsed_time(e1)
        return out

    def timed_apply(*a, **k):
        t1 = time.time()
        apply_fn(*a, **k)
        timing["host_finish_ms"] = (time.time() - t1) * 1e3

    crefit.leaf_stats, crefit.apply_leaf_values = timed_stats, timed_apply
    n0 = crefit.dispatches
    try:
        _, refit_ms = card_ms(lambda: dev_b.refit(xv, yv, decay_rate=0.9))
    finally:
        crefit.leaf_stats, crefit.apply_leaf_values = stats_fn, apply_fn
    dispatches = crefit.dispatches - n0
    os.environ["LGBM_TPU_HOST_REFIT"] = "1"
    try:
        host_b = lgb.Booster(params=refit_params, model_str=text,
                             device=dev)
        _, host_ms = card_ms(lambda: host_b.refit(xv, yv, decay_rate=0.9))
    finally:
        os.environ.pop("LGBM_TPU_HOST_REFIT")
    lv = [np.concatenate([t.leaf_value[:t.num_leaves]
                          for t in b._gbdt.models]) for b in (dev_b, host_b)]
    rel = float(np.max(np.abs(lv[0] - lv[1])
                       / np.maximum(np.abs(lv[1]), 1e-12)))
    refit = dict(timing, decay_rate=0.9, rows=len(xv), dispatches=dispatches,
                 refit_ms=refit_ms, host_loop_refit_ms=host_ms,
                 leaf_rel_diff_vs_host_loop=rel,
                 held_out_auc_before=auc_before,
                 held_out_auc_after=auc(yv, dev_b.predict(xv)))
    if rel > 1e-5 or dispatches != 1:
        problems.append("refit: leaves %g relative off the host loop's, "
                        "%d stats dispatches" % (rel, dispatches))

    # -- file input: the held-out rows as CSV, read back
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "held_out.csv")
        t1 = time.time()
        np.savetxt(path, np.column_stack([yv, xv]), fmt="%.9g",
                   delimiter=",")
        write_s = time.time() - t1
        t1 = time.time()
        dv = lgb.Dataset(path, reference=ds, params=params).construct()
        read_s = time.time() - t1
        parser_used = io_parser.last_parser
        t1 = time.time()
        pf = bst.predict(path)
        predict_file_s = time.time() - t1
        # the file's rows as numpy reads them (correctly rounded): the
        # array path of what the file holds
        t1 = time.time()
        held = np.loadtxt(path, delimiter=",")
        loadtxt_s = time.time() - t1
    da = lgb.Dataset(held[:, 1:], held[:, 0], reference=ds,
                     params=params).construct()
    codes_unequal = int(np.sum(dv._inner.binned != da._inner.binned))
    # 9 significant digits are not the f32 values: a value within ~5e-9
    # relative of a bin bound may bin on its other side
    d32 = lgb.Dataset(xv, yv, reference=ds, params=params).construct()
    codes_vs_f32 = int(np.sum(dv._inner.binned != d32._inner.binned))
    label_ok = bool(np.array_equal(dv.get_label(), yv))
    p_err = float(np.max(np.abs(pf - bst.predict(xv))))
    file_in = {"rows": len(xv), "parser": parser_used,
               "write_csv_s": write_s, "dataset_s": read_s,
               "numpy_loadtxt_s": loadtxt_s,
               "predict_file_s": predict_file_s,
               "codes_unequal_to_array": codes_unequal,
               "codes_unequal_to_the_f32_rows": codes_vs_f32,
               "predict_max_abs_vs_array": p_err}
    if codes_unequal or not label_ok or p_err != 0.0:
        problems.append("file input: %d codes differ, label equal %s, "
                        "predict %g off" % (codes_unequal, label_ok, p_err))

    # -- round trips, then free_dataset
    want_raw = bst.predict(xv, raw_score=True)
    rt = {}
    for name, other in (("pickle", pickle.loads(pickle.dumps(bst))),
                        ("model_from_string",
                         lgb.Booster(model_str=text, device=dev))):
        rt[name + "_max_abs"] = float(np.max(np.abs(
            other.predict(xv, raw_score=True) - want_raw)))
        if rt[name + "_max_abs"] != 0.0 or other.device != dev:
            problems.append("%s round trip: %g off" % (name,
                                                       rt[name + "_max_abs"]))
        del other
    import gc
    gc.collect()
    torch.cuda.synchronize()
    mem_before = int(torch.cuda.memory_allocated())
    bst.free_dataset()
    gc.collect()
    torch.cuda.synchronize()
    mem_after = int(torch.cuda.memory_allocated())
    after = bst.predict(xv, raw_score=True)
    rt.update(device_bytes_before_free_dataset=mem_before,
              device_bytes_after_free_dataset=mem_after)
    if not mem_after < mem_before or not np.array_equal(after, want_raw):
        problems.append("free_dataset: device bytes %d -> %d, predict "
                        "after it equal %s" % (
                            mem_before, mem_after,
                            np.array_equal(after, want_raw)))

    # -- the classifier on the card: the main path again, from the
    # estimator, at the higgs-1m params
    torch.cuda.empty_cache()
    reset_counts()
    clf = lgb.LGBMClassifier(
        n_estimators=rounds, num_leaves=params["num_leaves"],
        max_bin=params["max_bin"], learning_rate=params["learning_rate"],
        min_child_samples=params["min_data_in_leaf"], verbosity=-1)
    _, fit_ms = card_ms(lambda: clf.fit(x, y, verbose=False))
    counts = read_counts()
    proba = clf.predict_proba(xv)[:, 1]
    # bst may have grown more trees since (the steady-state updates)
    c_diff = float(np.max(np.abs(proba - bst.predict(
        xv, num_iteration=rounds))))
    sk = {"fit_s": fit_ms / 1e3, "n_estimators": rounds,
          "launches": {k: v for k, v in counts.items() if v},
          "strategy": clf.booster_._gbdt.learner.strategy,
          "fused": clf.booster_._gbdt._fused_step is not None,
          "predict_proba_max_abs_vs_train_phase": c_diff,
          "classes": clf.classes_.tolist()}
    if c_diff > 1e-6:
        problems.append("LGBMClassifier: predict_proba %g off the train "
                        "phase's Booster" % c_diff)
    if min(counts[k] for k in ("k1_win", "k4_win", "split_key")) <= 0 \
            or not sk["fused"]:
        problems.append("LGBMClassifier did not run the device loop's "
                        "kernels: %s" % counts)
    del clf, dev_b, host_b, cpu
    return {"phase": "booster_api", "rows": len(x), "held_out": len(xv),
            "pred_leaf": leaf, "pred_early_stop": early,
            "pred_contrib": shap, "refit": refit, "file_input": file_in,
            "round_trips": rt, "sklearn": sk}, problems


def bag_case(torch, name, p, extra, rounds, dset, x_train, base_auc,
             timed_train, growth, k4_path, steady_s, valid_auc_of,
             profile_one):
    """One train_bag run: `rounds` rounds of the main path's entry point
    with the sampling settings `extra`; (row, problems). The row: time,
    steady s per iteration, host syncs and launches per tree (the router's
    among them), K4's window rows per tree, each carry's capture time,
    peak memory, held-out AUC beside the unbagged float run's, and the
    largest gap between the training scores and predict(raw_score=True)
    on the training rows (out-of-bag rows score through the router),
    and one more iteration profiled,
    over the rows whose values no f32 threshold of predict moves across a
    bin boundary (f32_threshold_rows: a dozen of 1M rows, on the
    unsampled path too)."""
    b, counts, secs, peak = timed_train(p, dset, rounds=rounds)
    gb = b._gbdt
    lr = gb.learner
    diff = np.abs(gb.score_updater.score[0].cpu().numpy()
                  - b.predict(x_train, raw_score=True))
    moved = f32_threshold_rows(dset._inner, x_train)
    gap = float(np.max(diff[~moved]))
    vauc = valid_auc_of(b)
    row = dict({"case": name, "settings": extra, "rounds": rounds,
                "strategy": lr.strategy,
                "iteration": "fused" if gb._fused_step else "generic",
                "fused_steps": sorted("goss" if k else "plain"
                                      for k in gb._fused_step or {}),
                "launches": counts}, **growth(b, counts, secs))
    row["carries"] = {"%d rows, qcap_op %d" % key if key != "masked"
                      else key: {"capture_s": loop.capture_s}
                      for key, (_, loop) in lr._states.items()}
    if lr.strategy == "compact":
        row["k4_path"] = k4_path(b, counts)
    row.update(train_s=secs, peak_device_bytes=peak, valid_auc=vauc,
               unbagged_float_auc=base_auc,
               auc_minus_unbagged=vauc - base_auc,
               train_score_vs_predict_max_abs=gap,
               f32_threshold_rows=int(moved.sum()),
               their_max_abs=float(np.max(diff[moved], initial=0.0)),
               s_per_iter_steady=steady_s(b), profile=profile_one(b))
    problems = []
    if row["host_syncs_per_tree"] != 1:
        problems.append("%s host syncs per tree" % row["host_syncs_per_tree"])
    if not gap <= 1e-5:
        problems.append("training scores differ from predict by %g" % gap)
    if not vauc > 0.7 or vauc < base_auc - 0.005:
        problems.append("AUC %.5f (want > 0.7 and at most 0.005 below the "
                        "unbagged %.5f)" % (vauc, base_auc))
    pos_neg = p.get("pos_bagging_fraction", 1.0) < 1.0
    if row["iteration"] != ("generic" if pos_neg else "fused"):
        problems.append("took the %s iteration" % row["iteration"])
    if p.get("boosting") == "goss" and row["fused_steps"] != ["goss",
                                                              "plain"]:
        problems.append("GOSS ran the fused steps %s" % row["fused_steps"])
    # one router launch per sampled compact tree (GOSS samples after its
    # 1 / learning_rate warm-up)
    sampled = rounds - (int(1.0 / p["learning_rate"])
                        if p.get("boosting") == "goss" else 0)
    if lr.strategy == "compact" and (counts["route"] != sampled
                                     or counts["split_key_col"]):
        problems.append("%d router launches for %d sampled trees"
                        % (counts["route"], sampled))
    if lr.strategy == "masked" and (counts["route"] or counts["split_key"]
                                    or counts["split_key_col"] <= 0):
        problems.append("the masked loop's kernels did not run alone")
    del b
    return row, problems


def train_valid_phase(torch, lgb, params, ds, xv, yv, rounds, train,
                      growth, profile, reset_counts, read_counts):
    """The train_valid phase: the main path with the held-out rows as a
    validation set, evaluated every iteration, under early stopping;
    (row, problems)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from lightgbm_tpu_torch.models.gbdt import ScoreUpdater
    # every sampling key set: the Dataset's config keeps what earlier
    # phases' Boosters set
    p = dict(params, boosting="gbdt", quantized_grad=False,
             bagging_fraction=1.0, bagging_freq=0, pos_bagging_fraction=1.0,
             neg_bagging_fraction=1.0, metric=["auc", "binary_logloss"])
    dv = ds.create_valid(xv, yv)
    ev = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    b = lgb.train(p, ds, num_boost_round=rounds, valid_sets=[dv],
                  valid_names=["valid"], early_stopping_rounds=5,
                  evals_result=ev, verbose_eval=False)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    counts = read_counts()
    gb = b._gbdt
    lr = gb.learner
    vu = gb.valid_updaters[0]
    row = dict({"phase": "train_valid", "rows": ds.num_data(),
                "valid_rows": len(yv), "rounds": rounds,
                "metric": p["metric"], "early_stopping_rounds": 5,
                "iteration": "fused" if gb._fused_step else "generic",
                "best_iteration": b.best_iteration, "trees": b.num_trees(),
                "train_s": train_s, "launches": counts,
                "peak_device_bytes": int(torch.cuda.max_memory_allocated())},
               **growth(b, counts, train_s))
    vs = vu.score[0].cpu().numpy()
    pr = b.predict(xv, raw_score=True, num_iteration=-1)
    moved = f32_threshold_rows(ds._inner, xv)
    gap = float(np.max(np.abs(vs - pr)[~moved]))
    rec_auc = ev["valid"]["auc"][-1]
    row.update(valid_score_vs_predict_max_abs=gap,
               f32_threshold_rows=int(moved.sum()),
               recorded_valid_auc=rec_auc,
               auc_of_valid_scores=auc(yv, vs),
               valid_history={m: v for m, v in ev["valid"].items()})

    # steady iterations as train() runs them: the update, then the
    # training and validation metrics (host numpy over fetched scores)
    ups = [gb.score_updater] + gb.valid_updaters
    s0, f0 = lr.stats.host_syncs, sum(u.fetches for u in ups)
    upd, evl = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.time()
        b.update()
        torch.cuda.synchronize()
        t2 = time.time()
        b.eval_train()
        b.eval_valid()
        t3 = time.time()
        upd.append(t2 - t1)
        evl.append(t3 - t2)
    both = [a + c for a, c in zip(upd, evl)]
    # one more iteration's evaluation taken apart: each dataset's fetch
    # (the f64 host copy) and each metric on it
    b.update()
    torch.cuda.synchronize()
    parts = {}
    for dname, su, metrics in [("training", gb.score_updater,
                                gb.train_metrics)] + list(zip(
                                    gb.valid_names, gb.valid_updaters,
                                    gb.valid_metrics)):
        t1 = time.time()
        host = su.host_scores()[0]
        parts["%s fetch" % dname] = (time.time() - t1) * 1e3
        for m in metrics:
            t1 = time.time()
            m.eval(host, gb.objective)
            parts["%s %s" % (dname, m.name)] = (time.time() - t1) * 1e3
    row.update({
        "s_per_iter_steady": float(np.median(both)),
        "update_s_per_iter_steady": float(np.median(upd)),
        "eval_ms_per_iter": float(np.median(evl)) * 1e3,
        "eval_breakdown_ms": parts,
        "fetches_per_iter": (lr.stats.host_syncs - s0
                             + sum(u.fetches for u in ups) - f0) / 4,
        "train_phase_s_per_iter_steady": train["s_per_iter_steady"]
        if train else "not measured: train phase not run"})

    # the validation update alone: each tree walked over the validation
    # codes, into a fresh updater, profiled
    fresh = ScoreUpdater(dv._inner, 1, vu.score.device)
    fresh.add_tree(gb.models[0], 0)
    torch.cuda.synchronize()
    trees = gb.models[1:]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        for t in trees:
            fresh.add_tree(t, 0)
        torch.cuda.synchronize()
        wall = time.time() - t1
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    row["valid_update_per_tree"] = {
        "device_ms": sum(e.self_device_time_total for e in kern)
        / 1e3 / len(trees),
        "launches": sum(e.count for e in kern) / len(trees),
        "wall_ms": wall * 1e3 / len(trees),
        "depth": float(np.mean([t.depth() for t in trees]))}
    problems = []
    if row["iteration"] != "fused":
        problems.append("took the generic iteration")
    if row["host_syncs_per_tree"] != 1:
        problems.append("%s host syncs per tree" % row["host_syncs_per_tree"])
    if not gap <= 1e-5:
        problems.append("validation scores differ from predict by %g" % gap)
    if not abs(rec_auc - row["auc_of_valid_scores"]) <= 1e-9:
        problems.append("recorded AUC %.9f, AUC of the scores %.9f"
                        % (rec_auc, row["auc_of_valid_scores"]))
    if not rec_auc > 0.7 or not np.all(np.isfinite(vs)):
        problems.append("validation AUC %.5f" % rec_auc)
    del b
    return row, problems


# the objectives beside binary, and how each one's targets come from the
# generator's margin m: the noisy margin (the L2-like and renewal ones),
# Poisson counts at mean exp(m / 2), a Gamma draw of that mean, or a
# probability sigmoid(m + noise)
OBJECTIVE_TARGETS = (
    ("regression", "noisy"), ("regression_l1", "noisy"), ("huber", "noisy"),
    ("fair", "noisy"), ("quantile", "noisy"), ("mape", "noisy"),
    ("poisson", "poisson"), ("tweedie", "poisson"), ("gamma", "gamma"),
    ("cross_entropy", "probability"),
    ("cross_entropy_lambda", "probability"))


def objective_targets(kind, m, r):
    """Targets of `kind` from margins m, drawing from RandomState r."""
    if kind == "noisy":
        return m + r.randn(len(m)) * 1.5
    if kind == "poisson":
        return r.poisson(np.exp(0.5 * m)).astype(np.float64)
    if kind == "gamma":
        return r.gamma(2.0, np.exp(0.5 * m) / 2.0)
    return 1.0 / (1.0 + np.exp(-(m + r.randn(len(m)) * 1.5)))


class _Labels:
    """The metadata a metric's init reads."""

    def __init__(self, label):
        self.label, self.weight = label, None


def held_out_metric(b, xv, yv):
    """(name, the model's value, the constant model's value) of booster
    b's default metric on held-out rows (lower is better for every
    objective here); the constant model scores every row at the
    objective's boost-from-score."""
    from lightgbm_tpu_torch.metrics import metric as tm
    gb = b._gbdt
    m = tm.create_metrics([], gb.config, gb.objective.name)[0]
    m.init(_Labels(yv), len(yv))
    raw = b.predict(xv, raw_score=True)
    k = gb.num_class
    const = np.array([[gb.objective.boost_from_score(c)] for c in range(k)])
    const = np.broadcast_to(const, (k, len(yv)))
    score = raw.T if k > 1 else raw
    return m.name, m.eval(score, gb.objective)[0], \
        m.eval(const if k > 1 else const[0], gb.objective)[0]


def objectives_phase(torch, lgb, params, ds, x, xv, w, rounds, timed_train,
                     growth, steady_s):
    """train_objectives: every objective but binary and the multiclass
    ones on the higgs-1m rows (the train phase's Dataset, its label set to
    each objective's targets in turn), `rounds` rounds each; per objective
    the iteration it ran (fused, or generic with leaf renewal), steady s
    per iteration, host syncs and fetches per tree, the renewal's host ms
    per tree, launches per tree, and the held-out default metric against
    the constant model's. Returns (row, problems)."""
    from lightgbm_tpu_torch.models import gbdt as tg
    r = np.random.RandomState(31)
    m_t, m_v = higgs_margin(x, w), higgs_margin(xv, w)
    y_binary = ds.get_label()
    renew_ms = []
    renew = tg.GBDT._renew_tree_output

    def timed_renew(self, tree, class_id):
        t1 = time.perf_counter()
        renew(self, tree, class_id)
        renew_ms.append((time.perf_counter() - t1) * 1e3)
    runs, problems = [], []
    tg.GBDT._renew_tree_output = timed_renew
    try:
        for objective, kind in OBJECTIVE_TARGETS:
            yt = objective_targets(kind, m_t, r)
            yv = objective_targets(kind, m_v, r)
            ds.set_label(yt)
            del renew_ms[:]
            p = dict(params, objective=objective, num_class=1)
            b, counts, secs, peak = timed_train(p, ds, rounds=rounds)
            gb, lr = b._gbdt, b._gbdt.learner
            trees = max(lr.stats.trees, 1)
            row = dict({"objective": objective, "targets": kind,
                        "iteration": "fused" if gb._fused_step else
                        "generic (leaf renewal)",
                        "fetches_per_tree": gb.score_updater.fetches / trees,
                        "renew_host_ms_per_tree": float(np.mean(renew_ms))
                        if renew_ms else None, "train_s": secs,
                        "peak_device_bytes": peak},
                       **growth(b, counts, secs))
            name, got, const = held_out_metric(b, xv, yv)
            scores = gb.score_updater.score.cpu().numpy()
            row.update({"metric": name, "valid_metric": got,
                        "constant_model_metric": const,
                        "finite": bool(np.isfinite(scores).all()
                                       and np.isfinite(got)),
                        "s_per_iter_steady": steady_s(b)})
            runs.append(row)
            want_syncs = 1 if gb._fused_step else 2
            if not row["finite"] or not got < const:
                problems.append("%s: held-out %s %.6g vs the constant "
                                "model's %.6g" % (objective, name, got,
                                                  const))
            if row["host_syncs_per_tree"] != want_syncs:
                problems.append("%s: %s host syncs per tree" % (
                    objective, row["host_syncs_per_tree"]))
            if min(counts[k] for k in ("k1_win", "k4_win", "split_key")) \
                    <= 0:
                problems.append("%s: the device loop's kernels did not "
                                "launch: %s" % (objective, counts))
            del b
    finally:
        tg.GBDT._renew_tree_output = renew
        ds.set_label(y_binary)
    return {"phase": "train_objectives", "rows": len(x), "rounds": rounds,
            "runs": runs}, problems


def multiclass_phase(torch, lgb, params, ds, rows, f, xv, rounds,
                     reset_counts, read_counts, growth, steady_s):
    """train_multiclass: bench.py's 5-class variant of the higgs-1m rows
    (the same features, so the train phase's Dataset with its label set
    to the classes), multiclass and multiclassova for `rounds` rounds with
    the 100,000 held-out rows as a validation set (multi_logloss,
    multi_error); per run steady s per iteration (5 trees), captures,
    host syncs per tree, K1 / K4 launches per iteration, and the gates:
    held-out multi_logloss below the class prior's, class-0 one-vs-rest
    AUC > 0.7 (bench.py's gate). Returns (row, problems)."""
    k = 5
    _, ym, w = make_higgs_like(rows, f, n_classes=k)
    _, yvm, _ = make_higgs_like(len(xv), f, seed=4242, w=w, n_classes=k)
    y_binary = ds.get_label()
    prior = np.bincount(ym.astype(int), minlength=k) / len(ym)
    prior_loss = float(-np.mean(np.log(prior[yvm.astype(int)])))
    runs, problems = [], []
    ds.set_label(ym)
    try:
        for objective in ("multiclass", "multiclassova"):
            p = dict(params, objective=objective, num_class=k,
                     metric=["multi_logloss", "multi_error"])
            ev = {}
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            torch.cuda.synchronize()
            t1 = time.time()
            b = lgb.train(p, ds, rounds, valid_sets=[ds.create_valid(xv, yvm)],
                          valid_names=["v"], evals_result=ev,
                          verbose_eval=False)
            torch.cuda.synchronize()
            secs = time.time() - t1
            counts = read_counts()
            gb, lr = b._gbdt, b._gbdt.learner
            raw = b.predict(xv, raw_score=True)
            iters = max(b.current_iteration(), 1)
            row = dict({"objective": objective, "num_class": k,
                        "trees": b.num_trees(), "captures": lr.stats.captures,
                        "k1_win_per_iteration": counts["k1_win"] / iters,
                        "k4_win_per_iteration": counts["k4_win"] / iters,
                        "valid_multi_logloss": ev["v"]["multi_logloss"][-1],
                        "valid_multi_error": ev["v"]["multi_error"][-1],
                        "class_prior_logloss": prior_loss,
                        "class0_auc": auc((yvm == 0).astype(np.float64),
                                          raw[:, 0]),
                        "finite": bool(np.isfinite(raw).all()),
                        "train_s": secs,
                        "peak_device_bytes":
                            int(torch.cuda.max_memory_allocated())},
                       **growth(b, counts, secs))
            row["s_per_iter_steady"] = steady_s(b)
            runs.append(row)
            if not row["finite"] or raw.shape != (len(xv), k) \
                    or not row["valid_multi_logloss"] < prior_loss \
                    or not row["class0_auc"] > 0.7:
                problems.append("%s: held-out multi_logloss %.5f (class "
                                "prior %.5f), class-0 AUC %.5f, shape %s"
                                % (objective, row["valid_multi_logloss"],
                                   prior_loss, row["class0_auc"],
                                   raw.shape))
            if row["captures"] != 1 or row["host_syncs_per_tree"] != 1 \
                    or gb._fused_step is not None:
                problems.append("%s: %s captures, %s host syncs per tree "
                                "(want 1 and 1 on the generic iteration)"
                                % (objective, row["captures"],
                                   row["host_syncs_per_tree"]))
            if counts["k1_win"] <= 0 or counts["k4_win"] <= 0:
                problems.append("%s: K1 / K4's window entries did not "
                                "launch: %s" % (objective, counts))
            del b
    finally:
        ds.set_label(y_binary)
    return {"phase": "train_multiclass", "rows": rows, "rounds": rounds,
            "runs": runs}, problems


def categorical_phase(torch, lgb, convert, params, rows, f, rounds,
                      timed_train, growth, steady_s, profile_one, host_side,
                      train):
    """train_cat: bench.py's categorical variant (the last CAT_FEATURES
    columns hold CAT_CARD categories each) trained with those columns as
    categorical_feature. higgs-1m-cat: the fused iteration on the compact
    device loop (held-out AUC > 0.7, one host sync per tree, one capture,
    model-text round trip within 1e-6, training scores equal to predict
    off the f32-threshold rows); beside it the same rows with those
    columns numerical (the categorical AUC must be higher), the compact
    host loop for HOST_ROUNDS rounds (AUC within 0.001 of the device
    loop's model of as many rounds), bagging 0.8 (the router on
    categorical records, one launch per tree), and the first 60,000 rows
    on the masked device loop, float and quantized (the column entry).
    The profile names the split step's sort and gather kernels, the
    categorical scan's, beside the numerical run's. Returns (row,
    problems)."""
    cols = list(range(f - CAT_FEATURES, f))
    x, y, w = make_higgs_like(rows, f, n_cat=CAT_FEATURES)
    xv, yv, _ = make_higgs_like(100_000, f, seed=4242, w=w,
                                n_cat=CAT_FEATURES)
    # every key the runs change set in every run (a Booster updates its
    # Dataset's config with its parameters)
    pc = dict(params, categorical_feature=cols, bagging_fraction=1.0,
              bagging_freq=0, quantized_grad=False, grad_bits=8)
    dset = lgb.Dataset(x, y, params=pc).construct()
    problems = []
    sort_gather = r"sort|gather|scatter|index"

    def check_run(name, b, counts, secs, xt, pv, want):
        """One run's row and its gates: the strategy, the kernels `want`
        launched, one host sync per tree, AUC > 0.7, finite scores, and
        the training scores against predict on xt (the f32-threshold
        rows apart, on the 1M rows)."""
        lr = b._gbdt.learner
        row = dict({"case": name, "strategy": lr.strategy,
                    "captures": lr.stats.captures, "train_s": secs,
                    "fused": b._gbdt._fused_step is not None,
                    "launches": counts, "valid_auc": auc(yv, pv),
                    "trees_with_categorical_nodes": sum(
                        1 for t in b._gbdt.models if t.num_cat)},
                   **growth(b, counts, secs))
        diff = np.abs(b._gbdt.score_updater.score[0].cpu().numpy()
                      - b.predict(xt, raw_score=True))
        moved = f32_threshold_rows(b.train_set._inner, xt)
        row["train_score_vs_predict_max_abs"] = float(diff[~moved].max())
        bad = []
        if any(counts[k] <= 0 for k in want):
            bad.append("%s not launched: %s" % (want, counts))
        if row["host_syncs_per_tree"] != 1 or not row["fused"]:
            bad.append("%s host syncs per tree, fused %s"
                       % (row["host_syncs_per_tree"], row["fused"]))
        if not np.all(np.isfinite(pv)) or row["valid_auc"] <= 0.7:
            bad.append("AUC %.5f" % row["valid_auc"])
        if row["train_score_vs_predict_max_abs"] > 1e-5:
            bad.append("training scores vs predict %g"
                       % row["train_score_vs_predict_max_abs"])
        if not row["trees_with_categorical_nodes"]:
            bad.append("no categorical node")
        problems.extend("%s: %s" % (name, p) for p in bad)
        return row

    # higgs-1m-cat: the main path
    b, counts, secs, peak = timed_train(pc, dset)
    pv = b.predict(xv)
    main = check_run("higgs-1m-cat", b, counts, secs, x, pv,
                     ("k1_win", "k4_win", "split_key"))
    back = convert.booster_from_model_string(b.model_to_string())
    main["model_text_roundtrip_max_abs"] = float(np.max(np.abs(
        back.predict(xv, raw_score=True) - b.predict(xv, raw_score=True))))
    # the host loop's rounds of the main path's model, before the steady
    # rounds grow it
    auc_h = auc(yv, b.predict(xv, num_iteration=HOST_ROUNDS))
    main.update(peak_device_bytes=peak, s_per_iter_steady=steady_s(b),
                profile=profile_one(b, named=sort_gather))
    if main["captures"] != 1:
        problems.append("higgs-1m-cat: %d captures" % main["captures"])
    if main["model_text_roundtrip_max_abs"] > 1e-6:
        problems.append("model-text round trip %g"
                        % main["model_text_roundtrip_max_abs"])
    # the host loop beside it, HOST_ROUNDS rounds
    hb, _, host = host_side(pc, dset, xv, yv)
    main["host_loop"] = host
    main["auc_minus_host_loop"] = auc_h - host["valid_auc"]
    if abs(main["auc_minus_host_loop"]) > 0.001:
        problems.append("higgs-1m-cat: AUC at %d rounds %+.5f from the "
                        "host loop's" % (HOST_ROUNDS,
                                         main["auc_minus_host_loop"]))
    del hb, back
    # the same rows, the categorical columns numerical
    dnum = lgb.Dataset(x, y, params=params).construct()
    bn, ncounts, nsecs, _ = timed_train(params, dnum)
    num = dict({"case": "higgs-1m-cat columns as numerical",
                "valid_auc": auc(yv, bn.predict(xv)), "train_s": nsecs},
               **growth(bn, ncounts, nsecs))
    num.update(s_per_iter_steady=steady_s(bn),
               profile=profile_one(bn, named=sort_gather))
    del bn, dnum
    if not main["valid_auc"] > num["valid_auc"]:
        problems.append("categorical AUC %.5f not above the numerical "
                        "treatment's %.5f" % (main["valid_auc"],
                                              num["valid_auc"]))
    # the split step's extra kernels (per split step: 254 per tree)
    steps = 254.0
    extra = {"device_launches_per_step": (
        main["profile"]["device_launches"]
        - num["profile"]["device_launches"]) / steps,
        "device_ms_per_iteration": main["profile"]["device_ms"]
        - num["profile"]["device_ms"],
        "sort_gather_kernels_per_step": {
            e["name"]: e["calls"] / steps
            for e in main["profile"]["named"]}}
    runs = [main, num]
    # bagging 0.8: the router on categorical records
    bb, bcounts, bsecs, _ = timed_train(
        dict(pc, bagging_fraction=0.8, bagging_freq=1), dset)
    bag = check_run("higgs-1m-cat bagging 0.8", bb, bcounts, bsecs, x,
                    bb.predict(xv), ("k1_win", "k4_win", "split_key",
                                     "route"))
    bag["router_launches_per_tree"] = bcounts["route"] / max(
        bb._gbdt.learner.stats.trees, 1)
    if bag["router_launches_per_tree"] != 1:
        problems.append("bagging: %s router launches per tree"
                        % bag["router_launches_per_tree"])
    runs.append(bag)
    del bb, dset
    # higgs-60k-masked-cat: the first 60,000 rows on the masked loop
    dm = lgb.Dataset(x[:60_000], y[:60_000], params=pc).construct()
    for quant in (False, True):
        mb, mcounts, msecs, _ = timed_train(dict(pc, quantized_grad=quant),
                                            dm)
        runs.append(check_run(
            "higgs-60k-masked-cat" + (" quantized" if quant else ""), mb,
            mcounts, msecs, x[:60_000], mb.predict(xv),
            ("k3t" if quant else "k2", "split_key_col")))
        runs[-1]["s_per_iter_steady"] = steady_s(mb)
        if runs[-1]["strategy"] != "masked":
            problems.append("the 60,000-row run took %s"
                            % runs[-1]["strategy"])
        del mb
    return {"phase": "train_cat", "rows": rows, "rounds": rounds,
            "categorical_features": cols, "categories": CAT_CARD,
            "runs": runs, "categorical_scan_extra": extra,
            "higgs_1m_s_per_iter_steady": (train or {}).get(
                "s_per_iter_steady", "not measured: train not run")}, \
        problems


def make_ranking_like(n_queries, docs_per_query, f, seed=17, w=None):
    """Seeded learning-to-rank task (bench.py's make_ranking_like, draw for
    draw): query-grouped documents with relevance grades 0..4 from a
    score that a per-query context shifts; pass `w` to draw a held-out
    sample from the same ground truth. Returns (x, y, group, w)."""
    r = np.random.RandomState(seed)
    n = n_queries * docs_per_query
    x = r.randn(n, f).astype(np.float32)
    if w is None:
        w = r.randn(f) * (r.rand(f) > 0.4)
    ctx = np.repeat(r.randn(n_queries, 1) * 0.5, docs_per_query, axis=0)
    score = x @ w * 0.4 + 0.2 * x[:, 0] * x[:, 1] + ctx[:, 0] \
        + r.randn(n) * 0.8
    # grade into 0..4 by global quantile so every query mixes grades
    edges = np.quantile(score, [0.5, 0.75, 0.9, 0.97])
    y = np.digitize(score, edges).astype(np.float64)
    group = np.full(n_queries, docs_per_query, dtype=np.int64)
    return x, y, group, w


def device_profile(torch, fn):
    """fn() once under torch.profiler: its device ms and kernel launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kern) / 1e3,
            sum(e.count for e in kern))


def rank_phase(torch, lgb, convert, rounds, reset_counts, read_counts,
               growth, steady_s, profile_one):
    """train_rank: bench.py's lambdarank scenario (make_ranking_like:
    50,000 queries of 20 documents x 28 features, lambdarank, 255 leaves,
    learning_rate 0.1, max_bin 63, min_data_in_leaf 20) with 5,000
    held-out queries as a validation set (metric ndcg, eval_at 10), float
    and quantized on the compact strategy's fused iteration, and its first
    3,000 queries (60,000 rows) float on the masked one. Per run: steady s
    per iteration, host syncs and launches per tree, peak device memory,
    the lambdarank gradient's device ms, launches and working set, the
    host ndcg's ms per iteration, held-out ndcg@10 beside the all-zero
    scores' ndcg@10 of the same queries, the training scores against
    predict; rank-1m float is profiled. Returns (row, problems)."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.metrics import create_metric
    x, y, g, w = make_ranking_like(50_000, 20, 28)
    xv, yv, gv, _ = make_ranking_like(5_000, 20, 28, seed=4242, w=w)
    params = {"objective": "lambdarank", "num_leaves": 255,
              "learning_rate": 0.1, "max_bin": 63, "min_data_in_leaf": 20,
              "metric": ["ndcg"], "eval_at": [10], "quantized_grad": False,
              "grad_bits": 8, "verbosity": -1}
    t0 = time.time()
    ds = lgb.Dataset(x, y, group=g, params=params).construct()
    data_s = time.time() - t0
    # the held-out queries' ndcg@10 of all-zero scores (documents in
    # their given order)
    meta = Metadata(len(yv))
    meta.set_label(yv)
    meta.set_group(gv)
    zero = create_metric("ndcg", Config(params))
    zero.init(meta, len(yv))
    zero_ndcg = zero.eval(np.zeros(len(yv)), None)[0]

    def run(name, p, dset, xt, n_groups, expect):
        dv = lgb.Dataset(xv, yv, group=gv, reference=dset)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        ev = {}
        t1 = time.time()
        b = lgb.train(p, dset, num_boost_round=rounds, valid_sets=[dv],
                      valid_names=["v"], evals_result=ev, verbose_eval=False)
        torch.cuda.synchronize()
        secs = time.time() - t1
        counts = read_counts()
        peak = int(torch.cuda.max_memory_allocated())
        gb = b._gbdt
        score = gb.score_updater.score[0]
        raw = b.predict(xt, raw_score=True)
        # within 1e-5 of predict, or within the f32 rounding of adding the
        # trees in another order where that is larger: 2 * trees * eps *
        # the sum of the trees' largest |leaf| (the quantized run's leaves
        # reach 10^3, as the JAX package's do: PERF.md section 7)
        leaf_sum = sum(float(np.max(np.abs(t.leaf_value[:t.num_leaves])))
                       for t in gb.models)
        tol = max(1e-5, 2 * len(gb.models) * float(np.finfo(np.float32).eps)
                  * leaf_sum)
        diff = np.abs(score.cpu().numpy() - raw)
        moved = f32_threshold_rows(dset._inner, xt)
        text = b.model_to_string()
        back = convert.booster_from_model_string(text)
        rt = float(np.max(np.abs(back.predict(xv, raw_score=True)
                                 - b.predict(xv, raw_score=True))))
        row = dict({"case": name, "rows": len(xt), "queries": n_groups,
                    "strategy": gb.learner.strategy,
                    "quantized_grad": p["quantized_grad"],
                    "iteration": "fused" if gb._fused_step else "generic",
                    "launches": counts}, **growth(b, counts, secs))
        # the gradient alone, at this run's scores: device time behind a
        # sleep kernel, launches, and the memory it allocates beyond what
        # is held
        obj = gb.objective
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        obj.get_gradients(score)
        torch.cuda.synchronize()
        grad_peak = int(torch.cuda.max_memory_allocated()) - held
        grad_ms, grad_launches = device_profile(
            torch, lambda: obj.get_gradients(score))
        # the host evaluation of one iteration: each dataset's ndcg
        t1 = time.perf_counter()
        b.eval_train()
        train_eval_ms = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        b.eval_valid()
        valid_eval_ms = (time.perf_counter() - t1) * 1e3
        row.update({
            "train_s": secs, "peak_device_bytes": peak,
            "valid_ndcg10": ev["v"]["ndcg@10"][-1],
            "zero_score_ndcg10": zero_ndcg,
            "valid_ndcg10_history": ev["v"]["ndcg@10"],
            "gradient": {"device_ms": grad_ms, "launches": grad_launches,
                         "device_ms_behind_sleep": time_ms(
                             torch, lambda: obj.get_gradients(score), 5,
                             hold=True),
                         "pad_len": obj.pad_len, "chunk_queries": obj._chunk,
                         "peak_bytes_beyond_held": grad_peak},
            "host_ndcg_ms_per_iteration": {
                "training": train_eval_ms, "validation": valid_eval_ms},
            "model_text_roundtrip_max_abs": rt,
            "max_abs_leaf_value": max(
                float(np.max(np.abs(t.leaf_value[:t.num_leaves])))
                for t in gb.models),
            "max_abs_training_score": float(np.max(np.abs(raw))),
            "train_score_vs_predict": {
                "f32_threshold_rows": int(moved.sum()),
                "their_max_abs": float(np.max(diff[moved], initial=0.0)),
                "other_rows_max_abs": float(np.max(diff[~moved])),
                "tolerance": tol}})
        problems = []
        if row["strategy"] != expect[0] or row["iteration"] != "fused":
            problems.append("took the %s strategy's %s iteration"
                            % (row["strategy"], row["iteration"]))
        if row["host_syncs_per_tree"] != 1:
            problems.append("%s host syncs per tree"
                            % row["host_syncs_per_tree"])
        if min(counts[k] for k in expect[1:]) <= 0:
            problems.append("%s did not launch: %s" % (expect[1:], counts))
        if not row["valid_ndcg10"] > zero_ndcg:
            problems.append("held-out ndcg@10 %.5f not above the zero "
                            "scores' %.5f" % (row["valid_ndcg10"],
                                              zero_ndcg))
        if not row["train_score_vs_predict"]["other_rows_max_abs"] <= tol:
            problems.append("training scores differ from predict by %g"
                            % row["train_score_vs_predict"][
                                "other_rows_max_abs"])
        if rt > 1e-6:
            problems.append("model-text round trip differs by %g" % rt)
        return b, row, ["%s: %s" % (name, pr) for pr in problems]

    runs, problems = [], []
    b, row, pr = run("rank-1m", params, ds, x, len(g),
                     ("compact", "k1_win", "k4_win", "split_key"))
    row["s_per_iter_steady"] = steady_s(b)
    prof = profile_one(b)
    row["profile"] = prof
    row["gradient_share_of_iteration_device_ms"] = \
        row["gradient"]["device_ms"] / prof["device_ms"]
    runs.append(row)
    problems += pr
    del b
    qp = dict(params, quantized_grad=True)
    b, row, pr = run("rank-1m-quant", qp, ds, x, len(g),
                     ("compact", "k3_win", "k4_win", "split_key"))
    row["s_per_iter_steady"] = steady_s(b)
    # recorded, not gated: quantized lambdarank grows leaves of 10^2 -
    # 10^3 and loses ndcg to float in the JAX package as in the port
    # (tests/rank_quant_witness.py: on the same gradients both store the
    # same integers and grow the same trees; PERF.md section 6)
    row["ndcg10_minus_float"] = row["valid_ndcg10"] - runs[0]["valid_ndcg10"]
    runs.append(row)
    problems += pr
    del b, ds
    dm = lgb.Dataset(x[:60_000], y[:60_000], group=g[:3_000],
                     params=params).construct()
    b, row, pr = run("rank-60k-masked", params, dm, x[:60_000],
                     len(g[:3_000]),
                     ("masked", "k2", "split_key_col"))
    row["s_per_iter_steady"] = steady_s(b)
    runs.append(row)
    problems += pr
    del b, dm
    return {"phase": "train_rank", "rounds": rounds, "params": params,
            "dataset_s": data_s, "valid_queries": len(gv),
            "runs": runs}, problems


def boost_phase(torch, lgb, convert, params, ds, x, xv, yv, rounds,
                reset_counts, read_counts, growth, steady_s):
    """train_boost: the higgs-1m rows and params with boosting=dart at
    LightGBM's defaults (drop_rate 0.1, skip_drop 0.5, max_drop 50) and
    with boosting=rf (bagging_fraction 0.8, bagging_freq 1), `rounds`
    rounds each on the generic iteration over the compact device loop:
    time, steady s per iteration, host syncs and launches per tree (RF:
    the router's launches for the out-of-bag rows), DART's drop sets,
    held-out AUC, model-text round trip, and the training scores against
    predict (DART's rescaled trees, RF's running average). Returns (row,
    problems)."""
    plain = {"objective": "binary", "num_class": 1, "quantized_grad": False,
             "bagging_fraction": 1.0, "bagging_freq": 0,
             "pos_bagging_fraction": 1.0, "neg_bagging_fraction": 1.0,
             "feature_fraction": 1.0, "metric": ["auc"]}
    cases = (("higgs-1m dart", {"boosting": "dart", "drop_rate": 0.1,
                                "skip_drop": 0.5, "max_drop": 50}),
             ("higgs-1m rf", {"boosting": "rf", "bagging_fraction": 0.8,
                              "bagging_freq": 1}))
    moved = f32_threshold_rows(ds._inner, x)
    runs, problems = [], []
    for name, extra in cases:
        p = dict(params, **dict(plain, **extra))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        t1 = time.time()
        b = lgb.Booster(params=p, train_set=ds)
        drops = []
        for _ in range(rounds):
            b.update()
            drops.append(list(getattr(b._gbdt, "drop_index", [])))
        torch.cuda.synchronize()
        secs = time.time() - t1
        counts = read_counts()
        gb = b._gbdt
        diff = np.abs(gb.score_updater.score[0].cpu().numpy()
                      - b.predict(x, raw_score=True))
        back = convert.booster_from_model_string(b.model_to_string())
        rt = float(np.max(np.abs(back.predict(xv, raw_score=True)
                                 - b.predict(xv, raw_score=True))))
        vauc = auc(yv, b.predict(xv))
        trees = max(gb.learner.stats.trees, 1)
        row = dict({"case": name, "settings": extra, "rounds": rounds,
                    "strategy": gb.learner.strategy,
                    "iteration": "fused" if gb._fused_step else "generic",
                    "launches": counts}, **growth(b, counts, secs))
        row.update({
            "train_s": secs,
            "peak_device_bytes": int(torch.cuda.max_memory_allocated()),
            "valid_auc": vauc, "model_text_roundtrip_max_abs": rt,
            "train_score_vs_predict": {
                "f32_threshold_rows": int(moved.sum()),
                "their_max_abs": float(np.max(diff[moved], initial=0.0)),
                "other_rows_max_abs": float(np.max(diff[~moved]))}})
        if extra["boosting"] == "dart":
            row["drop_sets"] = drops
        else:
            # the out-of-bag rows reach their leaves through the split
            # key's router (a host bag compacted into its own carry)
            row["out_of_bag_rows"] = len(x) - int(len(x) * 0.8)
            row["router_launches_per_tree"] = counts["route"] / trees
        row["s_per_iter_steady"] = steady_s(b)
        runs.append(row)
        bad = []
        if row["iteration"] != "generic" or row["strategy"] != "compact":
            bad.append("took the %s strategy's %s iteration"
                       % (row["strategy"], row["iteration"]))
        if row["host_syncs_per_tree"] != 1:
            bad.append("%s host syncs per tree" % row["host_syncs_per_tree"])
        if not vauc > 0.7:
            bad.append("held-out AUC %.5f" % vauc)
        if not row["train_score_vs_predict"]["other_rows_max_abs"] <= 1e-5:
            bad.append("training scores differ from predict by %g"
                       % row["train_score_vs_predict"]["other_rows_max_abs"])
        if rt > 1e-6:
            bad.append("model-text round trip differs by %g" % rt)
        if extra["boosting"] == "dart" and not any(drops):
            bad.append("no tree was dropped")
        if extra["boosting"] == "rf" and (
                row["router_launches_per_tree"] != 1
                or not gb.average_output):
            bad.append("%s router launches per tree"
                       % row["router_launches_per_tree"])
        problems += ["%s: %s" % (name, pr) for pr in bad]
        del b, back
    return {"phase": "train_boost", "rows": len(x), "runs": runs}, problems


def boosting_reference_rows(torch, dev, lgb, sp, xs, ys, shape_of,
                            _quant_prepare, prng_key, ds_of):
    """The reference phase's learning-to-rank and boosting-mode runs, card
    against CPU: lambdarank on 1,000 queries of 20 rows (make_ranking_like)
    on compact float, masked float and compact quantized, OBJ_REF_ROUNDS
    rounds; DART (drop_rate 0.5, skip_drop 0, so that trees drop) and RF
    (bagging 0.7) on the 20,000-row binary task, compact float, REF_ROUNDS
    rounds. Held to the same trees as functions of the training rows
    (shape_of) and raw scores within 1e-5; quantized within 1e-4 and the
    same trees, unless the witness (multiclass_witness, on the CPU run's
    scores) finds stored integers that differ between the devices and
    both devices grow the same trees from the CPU's gradients
    (fixed_gradient_trees); DART's drop sets equal. Each row carries
    "ok"."""
    xr, yr, gr, _ = make_ranking_like(1_000, 20, xs.shape[1], seed=99)
    rp = dict(sp, objective="lambdarank", metric=["ndcg"], eval_at=[10])
    base = lgb.Dataset(xr, yr, group=gr, params=rp).construct()

    def rank_ds(_labels):
        return lgb.Dataset(xr, yr, group=gr, reference=base)
    cases = [("lambdarank", st, q, rp, rank_ds, xr, OBJ_REF_ROUNDS)
             for st, q in (("compact", False), ("masked", False),
                           ("compact", True))]
    cases += [(b, "compact", False, dict(sp, **extra), ds_of, xs,
               REF_ROUNDS) for b, extra in (
                   ("dart", {"boosting": "dart", "drop_rate": 0.5,
                             "skip_drop": 0.0}),
                   ("rf", {"boosting": "rf", "bagging_fraction": 0.7,
                           "bagging_freq": 1}))]
    rows = []
    for kind, strategy, quant, p, dset_of, xt, rounds in cases:
        os.environ["LGBM_TPU_STRATEGY"] = strategy
        p = dict(p, quantized_grad=quant, grad_bits=8)
        label = yr if kind == "lambdarank" else ys
        card = lgb.train(p, dset_of(label), num_boost_round=rounds)
        cpu = lgb.train(p, dset_of(label), num_boost_round=rounds,
                        device="cpu")
        tol = 1e-4 if quant else 1e-5
        row = {"case": kind, "strategy": strategy, "quantized_grad": quant,
               "rounds": rounds,
               "iteration": "fused" if card._gbdt._fused_step
               else "generic",
               "same_trees": shape_of(card) == shape_of(cpu),
               "max_abs_raw_diff": float(np.max(np.abs(
                   card.predict(xt, raw_score=True)
                   - cpu.predict(xt, raw_score=True)))),
               "raw_tolerance": tol}
        ok = row["max_abs_raw_diff"] <= tol
        if kind == "dart":
            row["drop_index_last"] = [card._gbdt.drop_index,
                                      cpu._gbdt.drop_index]
            ok = ok and card._gbdt.drop_index == cpu._gbdt.drop_index
        if quant:
            # the card's gradients may differ from the CPU's in the last
            # ulp, and a stored integer then rounds the other way: the
            # witness counts such rows from the CPU run's scores, and the
            # grower is held to the same trees from the CPU's gradients
            row["stored_rows_differ"] = multiclass_witness(
                torch, dev, lgb, p, label, card, _quant_prepare, prng_key,
                dset_of, rounds)
            row["fixed_gradient_trees"] = fixed_gradient_trees(
                torch, dev, lgb, p, dset_of, label, card, rounds)
            exempt = row["stored_rows_differ"] > 0 and all(
                t["equal"] for t in row["fixed_gradient_trees"])
            row["other_trees_allowed"] = exempt
            ok = (ok or exempt) and (row["same_trees"] or exempt)
        else:
            ok = ok and row["same_trees"]
        row["ok"] = bool(ok)
        rows.append(row)
    return rows


# card against CPU for the sums and leaf outputs of quantized lambdarank
# trees grown from the same gradients: ~3x the gap measured on an H100
# 80GB HBM3 (3.67e-4 relative, chip_smoke.py reference phase)
RANK_SCAN_TOL = 1.1e-3


def fixed_gradient_trees(torch, dev, lgb, p, dset_of, label, card_b,
                         rounds):
    """At the CPU run's scores before each of `rounds` iterations, a tree
    grown by the card's learner and one by the CPU's from the CPU's
    gradients (the iteration's quantization key), held by compare_records
    on the leaf, feature and count columns and the sums and leaf outputs,
    plus the largest relative gap of the gain. "equal" holds the first
    two and the sums and outputs within RANK_SCAN_TOL (the split scan
    sums in another order on the card, and a lambdarank leaf's gradients
    cancel, as fair's and gamma's do: see FAIR_GAMMA_TOL). Left to the
    maps are the threshold and the missing direction (where a leaf has no
    rows in the bins between two thresholds, both make its split and f32
    rounding picks one on each device; ROADMAP section 3), and recorded
    only is the gain, a difference of squared sums whose relative gap
    grows with their cancellation."""
    from lightgbm_tpu_torch.models.device_learner import (
        R_FEAT, R_GAIN, R_LCNT, R_LEAF, R_LOUT, R_LSG, R_LSH, R_RCNT,
        R_ROUT, R_RSG, R_RSH, R_THR)
    cpu_b = lgb.Booster(params=p, train_set=dset_of(label), device="cpu")
    ints = [R_LEAF, R_FEAT, R_LCNT, R_RCNT]
    floats = [R_LSG, R_LSH, R_RSG, R_RSH, R_LOUT, R_ROUT]
    trees = []
    for it in range(rounds):
        g, h = cpu_b._gbdt._compute_gradients()
        rc, lc, kc = cpu_b._gbdt.learner.grow(g[0], h[0], iter_seed=it)
        rd, ld, kd = card_b._gbdt.learner.grow(g[0].to(dev), h[0].to(dev),
                                               iter_seed=it)
        rc, rd = rc[:kc], rd[:kd]
        t = compare_records(torch, rd, ld, rc, lc, ints, floats,
                            RANK_SCAN_TOL)
        if kc == kd:
            t.update(gain_max_rel=float(np.max(
                np.abs(rd[:, R_GAIN] - rc[:, R_GAIN])
                / np.maximum(np.abs(rc[:, R_GAIN]), 1e-3), initial=0.0)),
                thresholds_differ=int(np.sum(rc[:, R_THR] != rd[:, R_THR])))
        t["equal"] = (t["ints_equal"] and t["leaf_ids_equal"]
                      and t["floats_close"])
        trees.append(t)
        cpu_b.update()
    return trees


def kernel_phases(torch, dev, args, run, k1, k4, build, ds, params, Config,
                  DeviceTreeLearner, quant_ops, prng_key, parents):
    """The k1, k2, k3 and k4 phases that `run` names, on the main path's
    working rows; {kernel: [case rows]} for the kernels line. `parents`,
    where given, holds another checkout's histogram and partition
    libraries and its histogram wrapper module, checked and timed beside
    each case. Every tensor made here
    is freed on return, before the training phases."""
    f = 28
    probe = DeviceTreeLearner(Config(params), ds._inner, device=dev)
    r = np.random.RandomState(0)
    g = torch.from_numpy(r.randn(args.rows).astype(np.float32)).to(dev)
    h = torch.from_numpy((r.rand(args.rows) * 0.25).astype(np.float32)) \
        .to(dev)
    buf = probe.working_buffer(g, h)                     # (N, 7 + 4) int32
    d_cols = buf.shape[1]
    cw = d_cols - 4
    b_root = probe.col_device_bins
    c_cols = probe.c_cols
    codes_root = buf.view(torch.uint8)[:, :c_cols]
    gh_root = buf.view(torch.float32)[:, cw:cw + 3]
    # the ragged 256-bin codes of k1 and k3
    tail_codes = None
    if run & {"k1", "k3"}:
        tail_codes = torch.from_numpy(np.random.RandomState(1).randint(
            0, 256, size=(args.rows + 3, f)).astype(np.uint8)).to(dev)
    out = {}

    def library_ms(pf, src, nb, reps):
        """One index_add_ over precomputed flat slots: the library call
        that computes the same histogram ((P, F) view `pf`)."""
        p, ff = pf.shape
        slot = (pf.long() + torch.arange(ff, device=dev) * nb).reshape(-1)
        src_r = src.repeat_interleave(ff, dim=0)
        res = torch.zeros((ff * nb, 3), dtype=src.dtype, device=dev)
        try:
            return time_ms(torch, lambda: res.index_add_(0, slot, src_r),
                           reps), "index_add_ (%s)" % src.dtype
        except RuntimeError as e:
            return None, "none: index_add_ on %s raised %s" % (
                src.dtype, str(e).splitlines()[0][:160])

    def parent_of(kernel):
        """The parent's wrapper of the same name as `kernel`."""
        return getattr(parents["histogram_wrapper"], kernel.__name__)

    def k4_parent():
        return parent_k4(torch, k4, parents["partition"])

    def timings(row, fn, reps, parent_fn=None,
                on_parent=contextlib.nullcontext):
        """row's ms and device_ms of fn; with parents, also parent_ms and
        parent_device_ms, parent_fn (default fn) run under on_parent(),
        the device times in the order parent, change, change, parent."""
        row["ms"] = time_ms(torch, fn, reps)
        if not parents:
            row["device_ms"] = time_ms(torch, fn, reps, hold=True)
            return
        pfn = parent_fn or fn
        d = []
        for par in (True, False, False, True):
            with on_parent() if par else contextlib.nullcontext():
                d.append(time_ms(torch, pfn if par else fn, reps,
                                 hold=True))
        with on_parent():
            row["parent_ms"] = time_ms(torch, pfn, reps)
        row["device_ms"] = (d[1] + d[2]) / 2
        row["parent_device_ms"] = (d[0] + d[3]) / 2

    # the device-window entries: their window comes from a split
    # descriptor; buffer 0 is `buf` (or the quantized rows), buffer 1 a
    # second buffer of the same shape
    from lightgbm_tpu_torch.ops.kernels import desc as dsc
    from lightgbm_tpu_torch.ops.kernels import split_key as kkey
    spare = torch.empty_like(buf)
    windows = [min(wn, args.rows) for wn in (args.rows, 250_000, 62_000,
                                             16_000, 4_000, 1_000)]

    def reps_for(wn):
        return 20 if wn > 500_000 else 50 if wn > 100_000 else 200

    def desc_for(words=(), **fields):
        # words: a categorical split's bitset words (uint32 values)
        d = torch.zeros(dsc.size(len(words)), dtype=torch.int32)
        for name, v in fields.items():
            d[getattr(dsc, name)] = int(v)
        if len(words):
            d[dsc.WORDS:] = torch.from_numpy(np.asarray(
                words, np.int64).astype(np.uint32).view(np.int32))
        return d.to(dev)

    def hist_desc(wn):
        """The histogram window of rows [0, wn) of buffer 0, as a split
        whose left child (the smaller) they are."""
        return desc_for(GO=1, SRC=1, BEGIN=0, COUNT=wn, LPHYS=wn,
                        LEFT_SMALL=1)

    def window_case(rows_out, label, check, fn, plain_fn, reps, nbytes,
                    nops=0, host_fn=None, library=None):
        """A device-window entry against its plain version: check() ->
        (ok, max_abs_err) on the same inputs, then fn (one launch) timed
        on both timers, plain_fn, and host_fn (the host-int entry over the
        same window) on the device timer."""
        ok, err = check()
        row = {"shape": label, "ok": bool(ok), "max_abs_err": float(err),
               "ms": time_ms(torch, fn, reps),
               "device_ms": time_ms(torch, fn, reps, hold=True),
               "plain_ms": time_ms(torch, plain_fn, 3, warmup=1)}
        if host_fn is not None:
            row["host_entry_device_ms"] = time_ms(torch, host_fn, reps,
                                                  hold=True)
        bms, by = bound(nbytes, nops)
        lib, note = library or (None, "none: no single PyTorch call "
                                      "computes it")
        row.update(bound_ms=bms, bound_by=by, library_ms=lib, library=note)
        rows_out.append(row)
        return row

    # ---- K1 / K2 vs plain -------------------------------------------------
    def repeat(fn, n=20):
        """fn's result over n launches on one input, and whether every
        launch gave the same bits."""
        outs = [fn() for _ in range(n)]
        return outs[0], all(torch.equal(o, outs[0]) for o in outs[1:])

    def float_case(rows, label, kernel, plain, codes, gh, nb, reps, pf,
                   atol=1e-4):
        got, same = repeat(lambda: kernel(codes, gh, nb))
        want = plain(codes, gh, nb)
        # f32 sums in two orders differ by up to ~eps * sqrt(n) * the bin's
        # sum of |terms|; at 1M rows a bin sums ~15k gradients that cancel,
        # so the tolerance adds 1e-5 * sum|terms| to rtol = atol = 1e-4
        mag = plain(codes, gh.abs(), nb)
        torch.cuda.synchronize()
        ea, er = errors(got, want)

        def within(res):
            return bool(((res - want).abs() <= atol + 1e-4 * want.abs()
                         + 1e-5 * mag).all()
                        and torch.equal(res[..., 2], want[..., 2]))
        diff = (got - want).abs()
        count_exact = bool(torch.equal(got[..., 2], want[..., 2]))
        ok = within(got)
        err_vs_mag = float((diff / mag.clamp(min=1e-30)).max())
        p, ff = pf.shape
        extra = {}
        if parents:
            extra["parent_ok"] = within(parent_of(kernel)(codes, gh, nb))
        timings(extra, lambda: kernel(codes, gh, nb), reps,
                lambda: parent_of(kernel)(codes, gh, nb))
        plain_ms = time_ms(torch, lambda: plain(codes, gh, nb), 3, warmup=1)
        lib, lib_note = library_ms(pf, gh, nb, reps)
        bms, by = bound(p * ff * codes.element_size() + 12 * p
                        + 12 * ff * nb, 3 * p * ff)
        row = {"shape": label, "P": p, "F": ff, "B": nb,
               "max_abs_err": ea, "max_rel_err": er,
               "max_err_over_abs_sum": err_vs_mag, "ok": ok,
               "count_exact": count_exact, "repeat_20_equal": same,
               "slots_unequal_to_f64_plain": int((got != want).sum()),
               "plain_ms": plain_ms, "library_ms": lib,
               "library": lib_note, "bound_ms": bms, "bound_by": by}
        row.update(extra)
        rows.append(row)
        return row

    tolerance = ("|diff| <= 1e-4 + 1e-4*|plain| + 1e-5*sum|terms| per bin; "
                 "count lane exact")
    if "k1" in run:
        rk = np.random.RandomState(11)
        k1_rows = []
        float_case(k1_rows, "root window (packed rows)", k1.build_histogram,
                   k1.build_histogram_plain, codes_root, gh_root, b_root, 20,
                   codes_root)
        float_case(k1_rows, "child window (packed rows)",
                   k1.build_histogram, k1.build_histogram_plain,
                   codes_root[:250_000], gh_root[:250_000], b_root, 50,
                   codes_root[:250_000])
        tail_gh = torch.from_numpy(np.stack(
            [rk.randn(args.rows + 3), rk.rand(args.rows + 3),
             np.ones(args.rows + 3)], 1).astype(np.float32)).to(dev)
        float_case(k1_rows, "ragged tail, 256 bins", k1.build_histogram,
                   k1.build_histogram_plain, tail_codes, tail_gh, 256, 20,
                   tail_codes)
        # dynamic range: feature 0's bin 7 holds hessians from 1e-7 to 0.25
        # and gradients from 1e-6 to 1e3 (log-uniform, random signs), bin 8
        # only the small ends of both, beside ordinary rows; held without
        # the absolute term, so a sum that drops small terms fails
        pd = min(args.rows, 200_003)
        dc = rk.randint(0, b_root, size=(pd, f)).astype(np.uint8)
        dg, dh = rk.randn(pd), rk.rand(pd) * 0.25
        for code, (glo, ghi), (hlo, hhi) in ((7, (-6, 3), (-7, np.log10(
                0.25))), (8, (-6, -4), (-7, -5))):
            sel = dc[:, 0] == code
            k = int(sel.sum())
            dg[sel] = np.where(rk.rand(k) < 0.5, -1.0, 1.0) \
                * 10.0 ** rk.uniform(glo, ghi, k)
            dh[sel] = 10.0 ** rk.uniform(hlo, hhi, k)
        dcodes = torch.from_numpy(dc).to(dev)
        dgh = torch.from_numpy(np.stack([dg, dh, np.ones(pd)], 1)
                               .astype(np.float32)).to(dev)
        dyn = float_case(k1_rows, "dynamic range (bins 7, 8 of feature 0)",
                         k1.build_histogram, k1.build_histogram_plain,
                         dcodes, dgh, b_root, 20, dcodes, atol=0.0)
        dyn["tolerance"] = ("|diff| <= 1e-4*|plain| + 1e-5*sum|terms| per "
                            "bin; count lane exact")
        # shapes a grid with the feature tiles along y, each block walking
        # at most kMaxRowsPerBlock rows, could not hold at once: 4,500
        # features of 256 bins (every block walks 563 tiles in turn), and
        # a grid of one block over 2^20 + 4,099 rows (its words flushed
        # every kMaxRowsPerBlock = 2^16 rows: 17 chunks)
        for label, pw, fw, nbw, grid in (
                ("wide F: 4,500 features of 256 bins", 20_003, 4_500, 256,
                 None),
                ("one block over 2^20 + 4,099 rows: 17 chunks",
                 (1 << 20) + 4_099, f, b_root, 1)):
            wcodes = torch.from_numpy(rk.randint(0, nbw, size=(pw, fw))
                                      .astype(np.uint8)).to(dev)
            wgh = torch.from_numpy(np.stack(
                [rk.randn(pw), rk.rand(pw), np.ones(pw)], 1)
                .astype(np.float32)).to(dev)
            grid_x = k1._grid_x
            if grid:
                k1._grid_x = lambda dev_, rows_, per_sm: grid
            try:
                float_case(k1_rows, label, k1.build_histogram,
                           k1.build_histogram_plain, wcodes, wgh, nbw, 3,
                           wcodes)
            finally:
                k1._grid_x = grid_x
            del wcodes, wgh
        # K1's device-window entry over rows [0, W) of the working rows
        k1w_rows = []
        for wn in windows:
            hd = hist_desc(wn)
            wargs = (buf, spare, hd, cw, c_cols, 8, b_root)

            def check():
                got, same = repeat(lambda: k1.build_histogram_window(*wargs))
                want = k1.build_histogram_window_plain(*wargs)
                mag = k1.build_histogram_plain(codes_root[:wn],
                                               gh_root[:wn].abs(), b_root)
                ok = bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()
                           + 1e-5 * mag).all()) \
                    and torch.equal(got[..., 2], want[..., 2])
                win_extra[wn] = {"repeat_20_equal": same,
                                 "slots_unequal_to_f64_plain":
                                     int((got != want).sum())}
                return ok, (got - want).abs().max()
            win_extra = {}
            window_case(
                k1w_rows, "device-window entry, rows [0, %d) (D=11)" % wn,
                check, lambda: k1.build_histogram_window(*wargs),
                lambda: k1.build_histogram_window_plain(*wargs),
                reps_for(wn), wn * (c_cols + 12) + 12 * c_cols * b_root,
                3 * wn * c_cols,
                host_fn=lambda: k1.build_histogram(
                    codes_root[:wn], gh_root[:wn], b_root),
                library=library_ms(codes_root[:wn], gh_root[:wn], b_root,
                                   reps_for(wn)))
            k1w_rows[-1].update(win_extra[wn])
        emit({"phase": "k1", "tolerance": tolerance,
              "cases": k1_rows + k1w_rows})
        if not all(rw["ok"] for rw in k1_rows + k1w_rows):
            fail("K1 disagrees with its plain version")
        if not all(rw["repeat_20_equal"] for rw in k1_rows + k1w_rows):
            fail("K1 gave other bits in 20 launches on one input")
        out["k1"], out["k1_win"] = k1_rows, k1w_rows
        del tail_gh, dcodes, dgh

    if "k2" in run:
        # the masked strategy's left-child operand: the rows outside the
        # leaf (here a random half) carry gh == 0
        rk = np.random.RandomState(12)
        k2_rows = []
        codes_t_full = codes_root.t().contiguous()           # (F, N) uint8
        gh_masked = gh_root.contiguous() * torch.from_numpy(
            rk.rand(args.rows) < 0.5).to(dev)[:, None].float()
        for n_cols, reps in ((60_000, 50), (args.rows, 20)):
            ct = codes_t_full[:, :n_cols].contiguous()
            float_case(k2_rows, "(F, N) column codes, masked left child",
                       k1.build_histogram_t, k1.build_histogram_t_plain, ct,
                       gh_masked[:n_cols].contiguous(), b_root, reps, ct.t())
            del ct
        col_rows = split_key_column_cases(
            torch, dev, k1, kkey, dsc, desc_for, window_case, reps_for,
            codes_t_full, probe.meta["t_feature_table"][0].tolist(),
            args.rows)
        emit({"phase": "k2", "tolerance": tolerance, "cases": k2_rows,
              "split_key_column_cases": col_rows})
        if not all(rw["ok"] for rw in k2_rows + col_rows):
            fail("K2 or the column split key disagrees with its plain "
                 "version")
        if not all(rw["repeat_20_equal"] for rw in k2_rows):
            fail("K2 gave other bits in 20 launches on one input")
        out["k2"], out["split_key_col"] = k2_rows, col_rows
        del codes_t_full, gh_masked

    # ---- K3 / K3t vs plain -------------------------------------------------
    def int_case(rows, label, kernel, plain, codes, ghq, nb, reps, pf):
        got = kernel(codes, ghq, nb)
        want = plain(codes, ghq, nb)
        torch.cuda.synchronize()
        exact = bool(got.dtype == torch.int32 and torch.equal(got, want))
        p, ff = pf.shape
        extra = {}
        if parents:
            extra["parent_bit_exact"] = bool(torch.equal(
                parent_of(kernel)(codes, ghq, nb), want))
        timings(extra, lambda: kernel(codes, ghq, nb), reps,
                lambda: parent_of(kernel)(codes, ghq, nb))
        plain_ms = time_ms(torch, lambda: plain(codes, ghq, nb), 3, warmup=1)
        lib, lib_note = library_ms(pf, ghq.to(torch.int32), nb, reps)
        bms, by = bound(p * ff * codes.element_size()
                        + 3 * p * ghq.element_size() + 12 * ff * nb,
                        3 * p * ff)
        row = {"shape": label, "P": p, "F": ff, "B": nb,
               "operand": str(ghq.dtype), "bit_exact": exact,
               "max_abs_err": 0.0 if exact else float(
                   (got.long() - want.long()).abs().max()),
               "plain_ms": plain_ms, "library_ms": lib,
               "library": lib_note, "bound_ms": bms, "bound_by": by}
        row.update(extra)
        rows.append(row)
        return row

    def rows_case(rows_out, label, rows, cw, qcap, r_g, r_h, nb, reps):
        """The packed-row entry over `rows` (grad_bits 8) against its plain
        version, bit-exact; the two-step it replaces timed beside it."""
        kargs = (rows, cw, c_cols, 8, r_g, r_h, qcap, 8, nb)

        def fn():
            return k1.build_histogram_quantized_rows(*kargs)

        def two_step(k3=k1.build_histogram_quantized):
            ghq = quant_ops.gh_operand_scaled(rows[:, cw], None, 8, qcap,
                                              r_g, r_h)
            return k3(rows.view(torch.uint8)[:, :c_cols], ghq, nb)

        def parent_two_step():
            return two_step(parent_of(k1.build_histogram_quantized))
        got = fn()
        want = k1.build_histogram_quantized_rows_plain(*kargs)
        torch.cuda.synchronize()
        exact = bool(got.dtype == torch.int32 and torch.equal(got, want))
        row = {"two_step_bit_exact": bool(torch.equal(two_step(), want))}
        if parents:
            row["parent_bit_exact"] = bool(torch.equal(parent_two_step(),
                                                       want))
        timings(row, fn, reps, parent_two_step)
        row["two_step_ms"] = time_ms(torch, two_step, reps)
        row["two_step_device_ms"] = time_ms(torch, two_step, reps,
                                            hold=True)
        w, d = rows.shape
        bms, by = bound(w * 4 * d + 12 * c_cols * nb, 3 * w * c_cols)
        row.update({
            "shape": label, "W": w, "D": d, "F": c_cols, "B": nb,
            "qcap_op": qcap, "bit_exact": exact,
            "max_abs_err": 0.0 if exact else float(
                (got.long() - want.long()).abs().max()),
            "plain_ms": time_ms(torch, lambda: k1
                                .build_histogram_quantized_rows_plain(
                                    *kargs), 3, warmup=1),
            "library_ms": None,
            "library": "none: no single PyTorch call re-quantizes the "
                       "rows and sums their histogram",
            "bound_ms": bms, "bound_by": by})
        rows_out.append(row)
        return row

    if "k3" in run:
        rk = np.random.RandomState(13)
        qprobe = DeviceTreeLearner(Config(dict(params, quantized_grad=True,
                                               grad_bits=8)),
                                   ds._inner, device=dev)
        qbuf, qrows = qprobe.quant_working_buffer(g, h, prng_key(0))
        qcw = qbuf.shape[1] - 2                              # (N, 9)
        r_g, r_h = (quant_ops.requant_ratio(qrows.root_max[i], qrows.qcap_op)
                    for i in (0, 1))
        ghq_root = quant_ops.gh_operand_scaled(qbuf[:, qcw], None, 8,
                                               qrows.qcap_op, r_g, r_h)
        qcodes = qbuf.view(torch.uint8)[:, :c_cols]
        k3_rows, k3t_rows = [], []
        int_case(k3_rows, "root window (quantized packed rows, D=9)",
                 k1.build_histogram_quantized,
                 k1.build_histogram_quantized_plain, qcodes, ghq_root,
                 b_root, 20, qcodes)
        int_case(k3_rows, "child window (quantized packed rows)",
                 k1.build_histogram_quantized,
                 k1.build_histogram_quantized_plain, qcodes[:250_000],
                 ghq_root[:250_000], b_root, 50, qcodes[:250_000])
        q16 = (1 << 15) - 1
        tail_ghq = torch.from_numpy(np.stack(
            [rk.randint(-q16, q16 + 1, args.rows + 3),
             rk.randint(0, q16 + 1, args.rows + 3), np.ones(args.rows + 3)],
            1).astype(np.int32)).to(dev)
        int_case(k3_rows,
                 "ragged tail, 256 bins, int32 operand (grad_bits 16)",
                 k1.build_histogram_quantized,
                 k1.build_histogram_quantized_plain, tail_codes, tail_ghq,
                 256, 20, tail_codes)
        del tail_ghq
        ct60 = codes_root[:60_000].t().contiguous()
        ghq60 = ghq_root[:60_000] * torch.from_numpy(
            rk.rand(60_000) < 0.5).to(dev)[:, None].to(torch.int8)
        int_case(k3t_rows, "(F, N) column codes, masked left child",
                 k1.build_histogram_quantized_t,
                 k1.build_histogram_quantized_t_plain, ct60, ghq60, b_root,
                 50, ct60.t())
        # the row walk cut short: one row per thread of the operand
        # path's full grid, so the time is mostly the blocks' flush
        grid = k1._grid_x(dev, 1 << 40, k1._BLOCKS_PER_SM)
        pn = min(grid * k1._THREADS, args.rows)
        int_case(k3_rows, "flush probe: one row per thread of the grid",
                 k1.build_histogram_quantized,
                 k1.build_histogram_quantized_plain, qcodes[:pn],
                 ghq_root[:pn], b_root, 50, qcodes[:pn])
        # the packed-row entry: the root and the compact core's child
        # windows of the quantized rows, the operand built in the kernel;
        # beside it the two-step (gh_operand_scaled, then K3), on this
        # tree's library and, with parents, on the parent's
        rows_rows = []
        for wn in (args.rows, 250_000, 62_000, 16_000, 4_000, 1_000):
            wn = min(wn, args.rows)
            rows_case(rows_rows, "packed quantized rows, D=9", qbuf[:wn],
                      qcw, qrows.qcap_op, r_g, r_h, b_root,
                      20 if wn > 500_000 else 50 if wn > 100_000 else 200)
        # K3's device-window entry over rows [0, W) of the quantized rows
        k3w_rows = []
        qspare = torch.empty_like(qbuf)
        for wn in windows:
            hd = hist_desc(wn)
            wargs = (qbuf, qspare, hd, qcw, c_cols, 8, r_g, r_h,
                     qrows.qcap_op, 8, b_root)

            def check():
                got = k1.build_histogram_quantized_window(*wargs)
                want = k1.build_histogram_quantized_window_plain(*wargs)
                return torch.equal(got, want), \
                    (got.long() - want.long()).abs().max()
            window_case(
                k3w_rows, "device-window entry, rows [0, %d) (D=9)" % wn,
                check, lambda: k1.build_histogram_quantized_window(*wargs),
                lambda: k1.build_histogram_quantized_window_plain(*wargs),
                reps_for(wn), wn * 4 * qbuf.shape[1] + 12 * c_cols * b_root,
                3 * wn * c_cols,
                host_fn=lambda: k1.build_histogram_quantized_rows(
                    qbuf[:wn], qcw, c_cols, 8, r_g, r_h, qrows.qcap_op, 8,
                    b_root))
        emit({"phase": "k3", "tolerance": "bit-exact",
              "cases": k3_rows + k3t_rows + rows_rows + k3w_rows})
        if not all(rw["bit_exact"] and rw.get("parent_bit_exact", True)
                   and rw.get("two_step_bit_exact", True)
                   for rw in k3_rows + k3t_rows + rows_rows) \
                or not all(rw["ok"] for rw in k3w_rows):
            fail("K3 / K3t disagree with their plain version")
        out["k3"], out["k3t"], out["k3_rows"] = k3_rows, k3t_rows, rows_rows
        out["k3_win"] = k3w_rows
        del ct60, ghq60, qbuf, qspare, ghq_root, qcodes, qprobe

    # ---- K4 vs plain ------------------------------------------------------
    if "k4" in run:
        rk = np.random.RandomState(14)
        k4_rows = []

        def k4_case(label, win, key, reps):
            res = torch.empty_like(win)
            got = k4.stable_partition3(win, key, res)
            want = k4.stable_partition3_plain(win, key)
            torch.cuda.synchronize()
            exact = bool(torch.equal(got, want))
            times = {}
            if parents:
                with k4_parent():
                    times["parent_bit_exact"] = bool(torch.equal(
                        k4.stable_partition3(win, key, res), want))
            timings(times, lambda: k4.stable_partition3(win, key, res), reps,
                    on_parent=k4_parent)
            plain = time_ms(torch,
                            lambda: k4.stable_partition3_plain(win, key),
                            3, warmup=1)
            wn, dn = win.shape
            bms, by = bound(wn * (8 * dn + 4), 0)
            row = {"shape": label, "W": wn, "D": dn, "bit_exact": exact,
                   "max_abs_err": 0.0 if exact else float("inf"),
                   "plain_ms": plain, "library_ms": None,
                   "library": "no single PyTorch call computes a stable "
                              "3-way row partition", "bound_ms": bms,
                   "bound_by": by}
            row.update(times)
            k4_rows.append(row)
            return row

        # the root split window: rows keyed by a feature threshold
        key_root = (codes_root[:, 0].to(torch.int32) > b_root // 3) \
            .to(torch.int32).contiguous()
        k4_case("root split window", buf, key_root, 20)
        w2 = torch.from_numpy(rk.randint(0, 2**32,
                                         size=(args.rows + 3, d_cols),
                                         dtype=np.uint32).view(np.int32)) \
            .to(dev)
        key2 = torch.from_numpy(rk.randint(0, 3, size=args.rows + 3)
                                .astype(np.int32)).to(dev)
        k4_case("ragged, 3 keys", w2, key2, 20)
        q9 = w2[:, :9].contiguous()
        k4_case("quantized rows, D=9", q9, key2, 20)
        # the compact core's child windows: leading row slices of the
        # working rows, a 0 / 1 key as the growth core passes
        for wn in (250_000, 62_000, 16_000, 4_000, 1_000):
            wn = min(wn, args.rows)
            reps = 50 if wn > 100_000 else 200
            k4_case("child window, D=11", buf[:wn], key_root[:wn], reps)
            k4_case("child window, D=9", q9[:wn], key_root[:wn], reps)
        ww = min(100_003, args.rows + 3)
        wide = torch.from_numpy(rk.randint(0, 2**32, size=(ww, 260),
                                           dtype=np.uint32).view(np.int32)) \
            .to(dev)
        k4_case("wide rows, D=260", wide, key2[:ww], 20)
        del wide
        # one tile more than the grid holds: one block moves two tiles
        over = k4._launcher(dev, d_cols)[1] * k4.tile_rows(d_cols) + 1
        k4_case("grid capacity + 1 tile", w2[:over], key2[:over], 50)
        # K4's device-window entry: rows [0, W) of buffer 0 into buffer 1
        # (D = 11, and D = 9 with the quantized width)
        k4w_rows, key_rows = [], []
        for src_buf, dn in ((buf, d_cols), (q9[:args.rows], 9)):
            dst_buf, plain_dst = torch.empty_like(src_buf), \
                torch.empty_like(src_buf)
            for wn in windows:
                wd = desc_for(GO=1, SRC=0, BEGIN=0, COUNT=wn)

                def check():
                    k4.stable_partition3_window(src_buf, dst_buf, key_root,
                                                wd)
                    k4.stable_partition3_window_plain(src_buf, plain_dst,
                                                      key_root, wd)
                    same = torch.equal(dst_buf[:wn], plain_dst[:wn])
                    return same, 0.0 if same else float("inf")
                window_case(
                    k4w_rows, "device-window entry, rows [0, %d) (D=%d)"
                    % (wn, dn), check,
                    lambda: k4.stable_partition3_window(src_buf, dst_buf,
                                                        key_root, wd),
                    lambda: k4.stable_partition3_window_plain(
                        src_buf, plain_dst, key_root, wd),
                    reps_for(wn), wn * (8 * dn + 4),
                    host_fn=lambda: k4.stable_partition3(
                        src_buf[:wn], key_root[:wn], dst_buf[:wn]))
            del dst_buf, plain_dst
        # the split key over the same windows: feature 0's decision on the
        # float rows, and with the side maxes on the quantized rows (D = 9)
        qprobe = DeviceTreeLearner(Config(dict(params, quantized_grad=True,
                                               grad_bits=8)),
                                   ds._inner, device=dev)
        qrows_buf, _ = qprobe.quant_working_buffer(g, h, prng_key(0))
        feat = probe.meta["t_feature_table"][0].tolist()
        for rows_buf, renew in ((buf, False), (qrows_buf, True)):
            kcw = rows_buf.shape[1] - (2 if renew else 4)
            other = spare if rows_buf is buf else torch.empty_like(rows_buf)
            for wn in windows:
                kd = desc_for(GO=1, SRC=0, BEGIN=0, COUNT=wn,
                              THR=b_root // 3, DLEFT=1, COL=feat[0],
                              BASE=feat[1], ELIDE=feat[2], NUMBINS=feat[3],
                              MISSING=feat[4], DEFAULT=feat[5])
                kw = dict(item_bits=8, cw=kcw, renew=renew)
                key_t, key_p = torch.empty_like(key_root), \
                    torch.empty_like(key_root)
                # the timed launches add into their own descriptors' counts
                kd_t, kd_p = kd.clone(), kd.clone()

                def check():
                    d1, d2 = kd.clone(), kd.clone()
                    kkey.split_key(rows_buf, other, d1, key_t, **kw)
                    kkey.split_key_plain(rows_buf, other, d2, key_p, **kw)
                    same = torch.equal(key_t[:wn], key_p[:wn]) \
                        and torch.equal(d1, d2)
                    return same, 0.0 if same else float("inf")
                window_case(
                    key_rows, "rows [0, %d) (D=%d%s)" % (
                        wn, rows_buf.shape[1], ", side maxes" if renew
                        else ""), check,
                    lambda: kkey.split_key(rows_buf, other, kd_t, key_t,
                                           **kw),
                    lambda: kkey.split_key_plain(rows_buf, other, kd_p,
                                                 key_p, **kw),
                    reps_for(wn), wn * (12 if renew else 8))
        del qprobe, qrows_buf
        key_rows += split_key_cat_cases(torch, dev, kkey, desc_for,
                                        window_case, buf, key_root, feat,
                                        args.rows)
        route_rows_out = router_cases(torch, dev, kkey, probe, g, h,
                                      window_case, args.rows)
        emit({"phase": "k4", "tolerance": "bit-exact",
              "cases": k4_rows + k4w_rows, "split_key_cases": key_rows,
              "router_cases": route_rows_out})
        if not all(rw["bit_exact"] and rw.get("parent_bit_exact", True)
                   for rw in k4_rows) \
                or not all(rw["ok"] for rw in k4w_rows + key_rows
                           + route_rows_out):
            fail("K4, the split key or the router disagrees with its plain "
                 "version")
        out["k4"], out["k4_win"], out["split_key"] = \
            k4_rows, k4w_rows, key_rows
        out["route"] = route_rows_out
    return out


def split_key_cat_cases(torch, dev, kkey, desc_for, window_case, buf,
                        key_root, feat, rows):
    """The split key's packed entry on categorical descriptors against its
    plain version, bit-exact in keys and the left count: the main path's
    8-bit rows (feature 0, fields `feat`, read as categorical) and random
    rows of 16-bit codes, at W = 2 and W = 8 bitset words, every bit set,
    none and random bits, over all `rows` rows. The byte bound: a code
    word read and a key written per row, and the words."""
    out = []
    d_cols = buf.shape[1]
    rc = np.random.RandomState(33)
    rows16 = torch.from_numpy(rc.randint(
        -2**31, 2**31, size=(rows, d_cols), dtype=np.int64)
        .astype(np.int32)).to(dev)
    for bits, rows_buf in ((8, buf), (16, rows16)):
        other = torch.empty_like(rows_buf)
        for n_words in (2, 8):
            for mask, words in cat_bitsets(rc, n_words):
                if bits == 8:
                    fld = dict(COL=feat[0], BASE=feat[1], ELIDE=feat[2],
                               NUMBINS=feat[3], MISSING=feat[4],
                               DEFAULT=feat[5])
                else:
                    fld = dict(COL=rc.randint(0, 2 * (d_cols - 4)),
                               BASE=rc.randint(0, 9), ELIDE=n_words == 8,
                               NUMBINS=32 * n_words, MISSING=0,
                               DEFAULT=rc.randint(0, 32))
                kd = desc_for(words, GO=1, SRC=0, BEGIN=0, COUNT=rows,
                              CAT=1, **fld)
                kw = dict(item_bits=bits, cw=d_cols - 4, renew=False)
                key_t, key_p = torch.empty_like(key_root), \
                    torch.empty_like(key_root)
                kd_t, kd_p = kd.clone(), kd.clone()

                def check():
                    d1, d2 = kd.clone(), kd.clone()
                    kkey.split_key(rows_buf, other, d1, key_t, **kw)
                    kkey.split_key_plain(rows_buf, other, d2, key_p, **kw)
                    same = torch.equal(key_t, key_p) and torch.equal(d1, d2)
                    return same, 0.0 if same else float("inf")
                row = window_case(
                    out, "categorical, %d-bit codes, W=%d, %s, rows [0, %d) "
                    "(D=%d)" % (bits, n_words, mask, rows, d_cols), check,
                    lambda: kkey.split_key(rows_buf, other, kd_t, key_t,
                                           **kw),
                    lambda: kkey.split_key_plain(rows_buf, other, kd_p,
                                                 key_p, **kw),
                    20, rows * 8 + 4 * n_words)
                row["left_rows"] = int((key_p == 0).sum())
        del other
    return out


def cat_bitsets(r, n_words):
    """(label, n_words uint32 values) bitsets of a categorical split:
    every bit set, none, and random bits."""
    return [("all bits set", [0xFFFFFFFF] * n_words),
            ("all bits clear", [0] * n_words),
            ("random bits", list(r.randint(0, 2**32, n_words,
                                           dtype=np.int64)))]


def router_cases(torch, dev, kkey, probe, g, h, window_case, rows):
    """The split key's router entry against its plain version, bit-exact
    in every row's leaf: the records of one 255-leaf tree grown by the
    main path's learner over the main path's packed 8-bit codes, and
    random records over random packed rows of 4-bit and 16-bit codes (28
    features, EFB bundle columns and plain ones, each missing type); M =
    200,000 rows and a ragged M; k = 0 (every row in leaf 0) and k = L - 1.
    Then the 8-bit and the 16-bit sets with half the features categorical
    (bitset words beside the records, W = 2 and 8: every bit set, none,
    random bits), M = 200,000, k = L - 1. The byte bound: the rows, the
    records (and their words) and the feature table read once, one leaf id
    written per row."""
    rec, _, k = probe.grow_compact(g, h, 0)
    sets = [("8-bit codes of the main path, the records of its tree",
             probe.codes_pack, rec, k, probe.meta["t_feature_table"], 8)]
    r = np.random.RandomState(22)
    for bits in (4, 16):
        per, nb, cw, f, L = 32 // bits, 1 << bits, 7, 28, 255
        rws = torch.from_numpy(r.randint(-2**31, 2**31, size=(rows, cw),
                                         dtype=np.int64).astype(np.int32))
        nbins = r.randint(3, min(nb, 256), f)
        elide = np.arange(f) % 3 == 0
        table = torch.from_numpy(np.stack([
            r.randint(0, cw * per, f),
            np.where(elide, r.randint(0, nb // 2, f), 0), elide, nbins,
            np.arange(f) % 3, r.randint(0, 100, f) % nbins],
            axis=1).astype(np.int32))
        rr = np.zeros((L - 1, 13), np.float32)
        feats = r.randint(0, f, L - 1)
        rr[:, 0] = [r.randint(0, i + 1) for i in range(L - 1)]
        rr[:, 1], rr[:, 2] = feats, r.randint(0, nbins[feats])
        rr[:, 3] = r.randint(0, 2, L - 1)
        sets.append(("random %d-bit codes and records" % bits, rws.to(dev),
                     torch.from_numpy(rr).to(dev),
                     torch.tensor(L - 1, dtype=torch.int32, device=dev),
                     table.to(dev), bits))
    # the 8-bit and 16-bit sets again with half the features categorical
    # and bitset words beside the records: W = 2 and W = 8, every bit set,
    # none, and random bits
    for label, codes, recs, k_full, table, bits in (sets[0], sets[2]):
        f_cat = torch.from_numpy((np.arange(table.shape[0]) % 2)
                                 .astype(np.int32)).to(dev)
        for n_words in (2, 8):
            for mask, words in cat_bitsets(r, n_words):
                rw = np.asarray(words, np.int64)[None, :] \
                    .repeat(recs.shape[0], 0)
                if mask.startswith("random"):
                    rw = r.randint(0, 2**32, rw.shape, dtype=np.int64)
                sets.append((
                    "%s, half the features categorical, W=%d, %s"
                    % (label, n_words, mask), codes, recs, k_full, table,
                    bits, torch.from_numpy(rw.astype(np.uint32)
                                           .view(np.int32)).to(dev),
                    f_cat))
    out = []
    for label, codes, recs, k_full, table, bits, *cat in sets:
        cat_kw = {} if not cat else dict(rec_cat=cat[0], f_cat=cat[1])
        for m in ((min(200_000, rows),) if cat else
                  (min(200_000, rows), min(100_003, rows))):
            rws = codes[:m].contiguous()
            for k in ((k_full,) if cat else
                      (k_full, torch.zeros_like(k_full))):
                kw = dict(item_bits=bits, **cat_kw)

                def check():
                    got = kkey.route_rows(rws, recs, k, table, **kw)
                    want = kkey.route_rows_plain(rws, recs, k, table, **kw)
                    same = torch.equal(got, want)
                    return same, 0.0 if same else float(
                        (got - want).abs().max())
                nbytes = rws.numel() * 4 + recs.numel() * 4 \
                    + table.numel() * 4 + 4 * m \
                    + sum(t.numel() * 4 for t in cat)
                row = window_case(
                    out, "%s, M=%d, k=%d" % (label, m, int(k)), check,
                    lambda: kkey.route_rows(rws, recs, k, table, **kw),
                    lambda: kkey.route_rows_plain(rws, recs, k, table, **kw),
                    200, nbytes)
                row.update(M=m, CW=rws.shape[1], k=int(k), item_bits=bits,
                           words=int(cat[0].shape[1]) if cat else 0)
    return out


def split_key_column_cases(torch, dev, k1, kkey, dsc, desc_for, window_case,
                           reps_for, codes_t_full, feat, rows):
    """The split key's column entry (the masked core's) against its plain
    version, bit-exact in leaf ids and the left operand (an f32 operand as
    its int32 words): the main path's (F, N) codes at 60,000 rows, at the
    full row count and at a ragged count, uint8 and 16-bit codes, f32,
    int8 and int32 operands, and a GO = 0 descriptor that must change
    nothing. Each case is the first split of a tree: every row in leaf 0,
    the middle of the feature's bins as threshold. Timed with NEW_ID = LEAF, so
    that every timed launch finds the same rows; the byte bound counts
    each row's leaf id read, its code read, the gh read of the rows going
    left, the operand row written and the leaf id written of the rows
    going right."""
    r = np.random.RandomState(21)
    out = []
    for n in (60_000, rows, 100_003):
        n = min(n, codes_t_full.shape[1])
        c8 = codes_t_full[:, :n].contiguous()
        # 16-bit codes: the same bins spread by m (above 32767 too, where
        # the int16 view is negative), and the split's bins with them
        m = 1031
        c16 = (c8.to(torch.int32) * m).to(torch.int16)
        for codes_t, cbytes, mul in ((c8, 1, 1), (c16, 2, m)):
            leaf0 = torch.zeros(n, dtype=torch.int32, device=dev)
            for op in (torch.float32, torch.int8, torch.int32):
                if op == torch.float32:
                    gh = torch.from_numpy(r.randn(n, 3).astype(np.float32))
                else:
                    gh = torch.from_numpy(r.randint(-127, 128, (n, 3))).to(op)
                gh = gh.to(dev)
                fields = dict(GO=1, THR=(feat[3] // 2) * mul, DLEFT=1,
                              COL=feat[0], BASE=feat[1] * mul,
                              ELIDE=feat[2], NUMBINS=feat[3] * mul,
                              MISSING=feat[4], DEFAULT=feat[5] * mul,
                              LEAF=0)
                check_desc = desc_for(NEW_ID=1, **fields)
                time_desc = desc_for(NEW_ID=0, **fields)
                got_l, want_l = leaf0.clone(), leaf0.clone()
                got_g, want_g = torch.empty_like(gh), torch.empty_like(gh)

                def words(t):
                    return t.view(torch.int32) if t.dtype == torch.float32 \
                        else t

                def check():
                    kkey.split_key_column(codes_t, check_desc, got_l, gh,
                                          got_g)
                    kkey.split_key_column_plain(codes_t, check_desc, want_l,
                                                gh, want_g)
                    same = torch.equal(got_l, want_l) \
                        and torch.equal(words(got_g), words(want_g))
                    # GO = 0 writes nothing
                    l0, g0 = got_l.clone(), got_g.clone()
                    kkey.split_key_column(codes_t, desc_for(GO=0), got_l,
                                          gh, got_g)
                    same = same and torch.equal(got_l, l0) \
                        and torch.equal(words(got_g), words(g0))
                    return same, 0.0 if same else float("inf")
                tl, tg = leaf0.clone(), torch.empty_like(gh)
                row = window_case(
                    out, "(28, %d) codes of %d bytes, %s operand"
                    % (n, cbytes, str(op).split(".")[-1]), check,
                    lambda: kkey.split_key_column(codes_t, time_desc, tl,
                                                  gh, tg),
                    lambda: kkey.split_key_column_plain(codes_t, time_desc,
                                                        tl, gh, tg),
                    reps_for(n), 0)
                left = int((want_l == 0).sum())
                ob = 3 * gh.element_size()
                nbytes = n * (4 + cbytes + ob) + left * ob + (n - left) * 4
                row["left_rows"] = left
                row["bound_ms"], row["bound_by"] = bound(nbytes, 0)
    # categorical descriptors at the masked path's 60,000 rows: uint8 and
    # 16-bit codes, W = 2 and W = 8 bitset words, every bit set, none and
    # random bits, an f32 operand
    n = min(60_000, codes_t_full.shape[1])
    c8 = codes_t_full[:, :n].contiguous()
    gh = torch.from_numpy(r.randn(n, 3).astype(np.float32)).to(dev)
    for codes_t, cbytes in ((c8, 1), ((c8.to(torch.int32) * 3 + 1)
                                      .to(torch.int16), 2)):
        for n_words in (2, 8):
            for mask, words in cat_bitsets(r, n_words):
                desc = desc_for(words, GO=1, CAT=1, COL=feat[0],
                                BASE=feat[1] if cbytes == 1 else 1,
                                ELIDE=feat[2] if cbytes == 1 else 1,
                                NUMBINS=32 * n_words, MISSING=feat[4],
                                DEFAULT=feat[5], LEAF=0, NEW_ID=1)
                leaf0 = torch.zeros(n, dtype=torch.int32, device=dev)
                got_l, want_l = leaf0.clone(), leaf0.clone()
                got_g, want_g = torch.empty_like(gh), torch.empty_like(gh)

                def check():
                    kkey.split_key_column(codes_t, desc, got_l, gh, got_g)
                    kkey.split_key_column_plain(codes_t, desc, want_l, gh,
                                                want_g)
                    same = torch.equal(got_l, want_l) and torch.equal(
                        got_g.view(torch.int32), want_g.view(torch.int32))
                    return same, 0.0 if same else float("inf")
                tl, tg = leaf0.clone(), torch.empty_like(gh)
                time_desc = desc.clone()
                time_desc[dsc.NEW_ID] = 0
                row = window_case(
                    out, "categorical, (28, %d) codes of %d bytes, W=%d, "
                    "%s, f32 operand" % (n, cbytes, n_words, mask), check,
                    lambda: kkey.split_key_column(codes_t, time_desc, tl,
                                                  gh, tg),
                    lambda: kkey.split_key_column_plain(
                        codes_t, time_desc, tl, gh, tg), reps_for(n), 0)
                left = int((want_l == 0).sum())
                row["left_rows"] = left
                row["bound_ms"], row["bound_by"] = bound(
                    n * (4 + cbytes + 12) + left * 12 + (n - left) * 4
                    + 4 * n_words, 0)
    return out


def compare_records(torch, ra, la, rb, lb, ints, floats, tol):
    """How two growers' trees differ, b the reference: the split counts,
    whether the record columns `ints` and the row -> leaf maps are equal,
    whether the f32 columns `floats` agree to rtol = atol = `tol`, and
    their largest difference relative to max(|b|, 1e-3)."""
    same_shape = ra.shape == rb.shape
    fa, fb = ra[:, floats], rb[:, floats]
    return {"splits": [len(ra), len(rb)],
            "ints_equal": bool(same_shape and np.array_equal(
                ra[:, ints], rb[:, ints])),
            "leaf_ids_equal": bool(torch.equal(la.cpu(), lb.cpu())),
            "floats_close": bool(same_shape and np.allclose(
                fa, fb, rtol=tol, atol=tol)),
            "max_rel_diff": float(np.max(
                np.abs(fa - fb) / np.maximum(np.abs(fb), 1e-3)))
            if same_shape and len(ra) else None}


def loop_phase(torch, dev, lgb, params, f, Config, DeviceTreeLearner,
               count_cols):
    """The loop phase: 20,000-row trees (31 leaves) of each strategy grown
    by its captured device loop on the card, by the same step run eagerly
    on the CPU (the kernels' plain versions) and by its host loop on the
    card, from the same numpy gradients, float and quantized. Against the
    CPU: equal leaf, feature and count columns and leaf ids, f32 columns
    within 1e-4 (the split scan's f32 prefix sums, and K1's / K2's, run in
    another order on the card: the reference phase's bound).
    Quantized, against the host loop on the same card: equal records,
    bit for bit. Also the capture's time and launches per step, and one
    tree grown on the card under the sync debug mode "error" (any
    synchronisation inside raises)."""
    R_LCNT, R_RCNT = count_cols
    xs, ys, w = make_higgs_like(20_000, f, seed=31)
    prob = 1.0 / (1.0 + np.exp(-0.3 * (xs @ w)))
    g = torch.from_numpy((prob - ys).astype(np.float32))
    h = torch.from_numpy((prob * (1.0 - prob)).astype(np.float32))
    # leaf, feature, counts; two thresholds with no training row between
    # them split alike (f32 rounding picks one), the leaf ids hold the
    # rows' routing
    ints = [0, 1, R_LCNT, R_RCNT]
    runs = []
    for strategy in ("compact", "masked"):
        for quant in (False, True):
            p = dict(params, num_leaves=31, min_gain_to_split=1e-3,
                     quantized_grad=quant, grad_bits=8)
            inner = lgb.Dataset(xs, ys, params=p).construct()._inner
            card = DeviceTreeLearner(Config(p), inner, strategy=strategy,
                                     device=dev)
            cpu = DeviceTreeLearner(Config(p), inner, strategy=strategy,
                                    device="cpu")
            on_device = card.grow_masked if strategy == "masked" \
                else card.grow_compact
            gc, hc = g.to(dev), h.to(dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.time()
            # the carry and the capture
            if strategy == "masked":
                card._masked_state()
            else:
                card._device_state()
            torch.cuda.synchronize()
            capture_s = time.time() - t1
            trees = []
            floats = [c for c in range(13)
                      if c not in ints and c not in (2, 3)]
            for seed in range(2):
                rc, lc, kc = card.grow(gc, hc, iter_seed=seed)
                rp, lp, kp = cpu.grow(g, h, iter_seed=seed)
                with host_loop(torch):
                    rh, lh, kh = card.grow(gc, hc, iter_seed=seed)
                t = compare_records(torch, rc, lc, rp, lp, ints, floats,
                                    1e-4)
                t.update(splits=[kc, kp, kh],
                         host_loop_records_equal=bool(np.array_equal(rc,
                                                                     rh)),
                         host_loop_leaf_ids_equal=bool(torch.equal(lc, lh)))
                trees.append(t)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                on_device(gc, hc, iter_seed=2)
                no_sync = True
            except RuntimeError as e:
                no_sync = str(e)[:200]
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            ok = no_sync is True and all(
                t["ints_equal"] and t["leaf_ids_equal"]
                and t["floats_close"] and t["splits"][0] > 1
                and (not quant or (t["host_loop_records_equal"]
                                   and t["host_loop_leaf_ids_equal"]))
                for t in trees)
            runs.append({
                "strategy": strategy, "quantized_grad": quant, "ok": ok,
                "trees": trees, "capture_s": capture_s,
                "captured_step_launches": {
                    k.rsplit(".", 2)[-2] + "." + k.rsplit(".", 1)[-1]: v
                    for k, v in card._loop.launches_per_step.items()},
                "replays_per_tree": card._loop.num_steps,
                "capture_s_in_loop": card._loop.capture_s,
                "no_sync_inside_tree": no_sync,
                "peak_device_bytes": int(torch.cuda.max_memory_allocated())})
    runs += bag_loop_runs(torch, dev, lgb, params, xs, ys, g, h, Config,
                          DeviceTreeLearner, ints, count_cols)
    emit({"phase": "loop", "rows": 20_000, "num_leaves": 31, "runs": runs})
    if not all(r["ok"] for r in runs):
        fail("a captured device loop disagrees with the same step on the "
             "CPU or with the host loop, or synchronised inside a tree")


def bag_loop_runs(torch, dev, lgb, params, xs, ys, g, h, Config,
                  DeviceTreeLearner, ints, count_cols):
    """The loop phase's bag carry: 20,000-row compact trees grown on a
    fused iteration's bag of 14,000 rows (exact_k_bag_weights, the in-bag
    rows first), float and quantized, by the bag's captured step on the
    card and the same step eagerly on the CPU, from the same gradients and
    bag: equal leaf, feature and count columns and leaf ids of every row
    (the out-of-bag rows' from the router and its plain version), f32
    columns within 1e-4; and one bagged tree grown under the sync debug
    mode "error"."""
    from lightgbm_tpu_torch.models import device_learner as dl
    R_LCNT, R_RCNT = count_cols
    n, bag_k = len(ys), 14_000

    def bag(seed):
        w = dl.exact_k_bag_weights(dl.trandom.prng_key(seed), n, bag_k, dev)
        order = torch.argsort((w <= 0).to(torch.int32), stable=True)
        return order[:bag_k], order[bag_k:]

    floats = [c for c in range(13) if c not in ints and c not in (2, 3)]
    runs = []
    for quant in (False, True):
        p = dict(params, num_leaves=31, min_gain_to_split=1e-3,
                 quantized_grad=quant, grad_bits=8)
        inner = lgb.Dataset(xs, ys, params=p).construct()._inner
        card = DeviceTreeLearner(Config(p), inner, strategy="compact",
                                 device=dev)
        cpu = DeviceTreeLearner(Config(p), inner, strategy="compact",
                                device="cpu")
        gc, hc = g.to(dev), h.to(dev)
        trees = []
        for seed in range(2):
            bi, oi = bag(seed)
            rc, lc, kc = card.grow_compact(gc, hc, seed, bi, oi)
            rc, kc, _ = card.fetch_tree(rc, kc)
            rp, lp, kp = cpu.grow_compact(g, h, seed, bi.cpu(), oi.cpu())
            rp, kp, _ = cpu.fetch_tree(rp, kp)
            t = compare_records(torch, rc, lc, rp, lp, ints, floats, 1e-4)
            t.update(splits=[kc, kp],
                     bag_rows=int(rp[0, R_LCNT] + rp[0, R_RCNT]))
            trees.append(t)
        bi, oi = bag(2)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            card.grow_compact(gc, hc, 2, bi, oi)
            no_sync = True
        except RuntimeError as e:
            no_sync = str(e)[:200]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ok = no_sync is True and all(
            t["ints_equal"] and t["leaf_ids_equal"] and t["floats_close"]
            and t["splits"][0] > 1 and t["bag_rows"] == bag_k
            for t in trees)
        runs.append({
            "strategy": "compact", "bag": "%d of %d rows" % (bag_k, n),
            "quantized_grad": quant, "ok": ok, "trees": trees,
            "carries": [list(key) for key in card._states],
            "captured_step_launches": {
                k.rsplit(".", 2)[-2] + "." + k.rsplit(".", 1)[-1]: v
                for k, v in card._loop.launches_per_step.items()},
            "capture_s_in_loop": card._loop.capture_s,
            "no_sync_inside_tree": no_sync})
    return runs


def reference_phase(torch, dev, lgb, k1, params, f, Config,
                    DeviceTreeLearner, _quant_prepare, quant_ops, prng_key,
                    record_cols):
    """The reference phase: small tasks trained on the card and on the
    CPU, held to the same trees and raw scores within 1e-4."""
    R_DLEFT, R_FEAT, R_LCNT, R_LEAF, R_RCNT, R_THR = record_cols
    # ---- reference: card vs CPU on small inputs ---------------------------
    xs, ys, w_small = make_higgs_like(20_000, f, seed=99)
    sp = dict(params, num_leaves=31, min_gain_to_split=1e-3)
    ds_of = rebinned(lgb, xs, ys, sp)

    def shape_of(b):
        return [(list(t.split_feature[:t.num_leaves - 1]),
                 list(t.left_child[:t.num_leaves - 1]),
                 list(t.leaf_count[:t.num_leaves]))
                for t in b._gbdt.models]

    def grown_q(device, strategy, qp):
        """Three trees grown from fixed gradients (iter_seed 0..2) and the
        first one's exact root histogram, as the strategy's core builds
        it (quantize with prng_key(0), K3 / K3t on the card, the plain
        versions on the CPU)."""
        dsr = ds_of(ys).construct()
        lr = DeviceTreeLearner(Config(qp), dsr._inner, strategy=strategy,
                               device=device)
        # binary-logloss gradients at a score with signal, made in numpy
        # so both devices get the same f32 inputs (noise gradients would
        # make every split a near-tie)
        prob = 1.0 / (1.0 + np.exp(-0.3 * (xs @ w_small)))
        gr = torch.from_numpy((prob - ys).astype(np.float32)).to(device)
        hr = torch.from_numpy((prob * (1.0 - prob)).astype(np.float32)) \
            .to(device)
        trees = []
        for seed in range(3):
            rec, leaf, k = lr.grow(gr, hr, iter_seed=seed)
            trees.append((rec[:k], leaf.cpu()))
        if strategy == "masked":
            packed, _, _, _ = _quant_prepare(gr, hr, prng_key(0),
                                             quant_bits=8,
                                             quant_renew=False)
            ghq = quant_ops.gh_operand(
                packed, torch.ones_like(packed, dtype=torch.bool), 8)
            root = k1.build_histogram_quantized_t(lr.codes_t, ghq,
                                                  lr.col_device_bins)
        else:
            data, qr = lr.quant_working_buffer(gr, hr, prng_key(0))
            rgs = [quant_ops.requant_ratio(qr.root_max[i], qr.qcap_op)
                   for i in (0, 1)]
            ghq = quant_ops.gh_operand_scaled(data[:, data.shape[1] - 2],
                                              None, 8, qr.qcap_op, *rgs)
            root = k1.build_histogram_quantized(
                data.view(torch.uint8)[:, :lr.c_cols], ghq,
                lr.col_device_bins)
        return trees, root.cpu()

    def record_diffs(ta, tb):
        """compare_records of two growers' trees, tree by tree, on the
        leaf / feature / threshold / count columns and the f32 columns
        within 1e-4. The split scan's f32 prefix sums run in another
        order on the card, and a gain is a difference of squared sums, so
        equal integer histograms give f32 columns that differ by up to
        ~5e-5 relative (measured); 1e-4 is the card-vs-CPU bound of the
        float runs."""
        ints = [R_LEAF, R_FEAT, R_THR, R_LCNT, R_RCNT]
        # default_left is left out of the f32 columns: where the leaf has
        # no rows in the feature's missing bin both directions make the
        # same split and f32 rounding picks one (the row -> leaf maps
        # hold the routing)
        floats = [c for c in range(13) if c not in ints and c != R_DLEFT]
        return [compare_records(torch, ra, la, rb, lb, ints, floats, 1e-4)
                for (ra, la), (rb, lb) in zip(ta, tb)]

    def gradient_witness(card_b, qp, strategy):
        """From the same f32 scores (the CPU run's after each iteration
        before the last of REF_ROUNDS),
        the largest gap in ulps between the card's and the CPU's objective
        gradients and hessians, and the number of rows whose stored (qg|qh)
        integer differs when both are quantized as that iteration's tree
        quantizes them (key prng_key(iteration), the strategy's storage
        bits)."""
        cpu_b = lgb.train(qp, ds_of(ys), num_boost_round=1,
                          device="cpu")
        lr = card_b._gbdt.learner
        renew = strategy == "compact" and lr.quant_renew
        out = []
        for it in range(1, REF_ROUNDS):
            sc = cpu_b._gbdt.score_updater.score[0].clone()
            gc, hc = cpu_b._gbdt.objective.get_gradients(sc)
            gd, hd = card_b._gbdt.objective.get_gradients(sc.to(dev))
            gd, hd = gd.cpu(), hd.cpu()

            def ulps(a, b):
                return int((a.view(torch.int32).long()
                            - b.view(torch.int32).long()).abs().max())

            pc = _quant_prepare(gc, hc, prng_key(it),
                                quant_bits=lr.quant_bits,
                                quant_renew=renew)[0]
            pd = _quant_prepare(gd.to(dev), hd.to(dev), prng_key(it),
                                quant_bits=lr.quant_bits,
                                quant_renew=renew)[0].cpu()
            out.append({"iteration": it, "max_ulp_gap_grad": ulps(gd, gc),
                        "max_ulp_gap_hess": ulps(hd, hc),
                        "grad_rows_differ": int((gd != gc).sum()),
                        "stored_rows_differ": int((pd != pc).sum())})
            cpu_b.update()
        return out

    # Every run is held to the same trees and raw scores within 1e-4, with
    # one exemption, which rests on a reading made in the same run: the
    # card's and the CPU's objective gradients may differ in the last ulp
    # (torch.exp), and at the compact core's 16-bit storage a row whose
    # g * s lies that close to an integer rounds the other way, so a
    # near-tie split may go another way. Compact quantized may therefore
    # grow other trees only where its witness counts rows whose stored
    # integer differs between the devices from the same scores. The
    # grower itself (quantization, K3 / K3t, the split scan) is held to
    # the same trees from identical gradients.
    def reference_row(strategy, quant):
        os.environ["LGBM_TPU_STRATEGY"] = strategy
        qp = dict(sp, quantized_grad=quant, grad_bits=8)
        on_card = lgb.train(qp, ds_of(ys),
                            num_boost_round=REF_ROUNDS)
        on_cpu = lgb.train(qp, ds_of(ys),
                           num_boost_round=REF_ROUNDS,
                           device="cpu")
        row = {"strategy": strategy, "quantized_grad": quant,
               "same_trees": shape_of(on_card) == shape_of(on_cpu),
               "max_abs_raw_diff": float(np.max(np.abs(
                   on_card.predict(xs, raw_score=True)
                   - on_cpu.predict(xs, raw_score=True)))),
               "raw_tolerance": 1e-4}
        row["ok"] = row["max_abs_raw_diff"] <= row["raw_tolerance"]
        if quant:
            wit = gradient_witness(on_card, qp, strategy)
            row["gradient_witness"] = wit
            row["witness_stored_rows_differ"] = sum(
                w["stored_rows_differ"] for w in wit)
        exempt = (strategy == "compact" and quant
                  and row["witness_stored_rows_differ"] > 0)
        row["other_trees_allowed"] = exempt
        row["ok"] = row["ok"] and (row["same_trees"] or exempt)
        if quant:
            card_trees, card_root = grown_q(dev, strategy, qp)
            cpu_trees, cpu_root = grown_q(torch.device("cpu"), strategy, qp)
            diffs = record_diffs(card_trees, cpu_trees)
            row["fixed_gradient_trees"] = diffs
            row["same_trees_from_fixed_gradients"] = all(
                d["ints_equal"] and d["leaf_ids_equal"] and d["floats_close"]
                for d in diffs)
            row["root_hist_equal"] = bool(torch.equal(card_root, cpu_root))
            row["ok"] = (row["ok"] and row["root_hist_equal"]
                         and row["same_trees_from_fixed_gradients"])
        return row

    ref_rows = []
    # wall seconds of each part of the phase
    seconds, t_part = {}, time.time()

    def part_done(name):
        nonlocal t_part
        seconds[name] = round(time.time() - t_part, 1)
        t_part = time.time()
    for strategy, quant, growth in (
            ("compact", False, "device loop"),
            ("compact", True, "device loop"),
            ("compact", False, "host loop"), ("compact", True, "host loop"),
            ("masked", False, "device loop"),
            ("masked", True, "device loop")):
        # a host-loop run: the generic iteration over the strategy's host
        # loop, on both devices
        with host_loop(torch) if growth == "host loop" \
                else contextlib.nullcontext():
            row = reference_row(strategy, quant)
        row["growth"] = growth
        ref_rows.append(row)

    def tie_separated(ba, bb):
        """Rows that reach another leaf of some tree on the two devices."""
        sep = np.zeros(len(xs), bool)
        for ta, tb in zip(ba._gbdt.models, bb._gbdt.models):
            sep |= np.array([ta.predict_leaf_row(rw) != tb.predict_leaf_row(rw)
                             for rw in xs])
        return sep

    def goss_witness(qp, first):
        """At the first sampled iteration whose trees differ between the
        devices, the GOSS sample each device draws from its own run's
        scores (both runs trained `first` rounds, whose trees are equal),
        under the iteration's bag key: the rows whose place in the sample
        differs (the order of |g * h| over all rows decides which rows the
        uniforms pick, so f32 noise in the scores or a last-ulp difference
        in the gradients moves the sample); and the card's sampler from the
        CPU's gradients, which must give the CPU's sample bit for bit."""
        from lightgbm_tpu_torch.models import device_learner as dl
        card_b = lgb.train(qp, ds_of(ys), num_boost_round=first)
        cpu_b = lgb.train(qp, ds_of(ys), num_boost_round=first,
                          device="cpu")
        gb = cpu_b._gbdt
        top_k, other_k, mult = gb._goss_params()
        sd = card_b._gbdt.score_updater.score[0]
        sc = gb.score_updater.score[0]
        gd, hd = card_b._gbdt.objective.get_gradients(sd)
        gc, hc = gb.objective.get_gradients(sc)
        key = prng_key((gb.config.bagging_seed + first) % (2**31 - 1))
        args = (key, len(ys), top_k, other_k, mult)
        want = dl.goss_sample(gc, hc, *args)
        own = dl.goss_sample(gd, hd, *args)
        same = dl.goss_sample(gc.to(dev), hc.to(dev), *args)
        return {"iteration": first,
                "trees_before_equal": shape_of(card_b) == shape_of(cpu_b),
                "max_abs_score_diff": float((sd.cpu() - sc).abs().max()),
                "grad_rows_differ": int((gd.cpu() != gc).sum()),
                "bag_rows_differ": int((own[3].cpu() != want[3]).sum()),
                "sampler_equal_from_same_gradients": all(
                    torch.equal(a.cpu(), b) for a, b in zip(same, want))}

    # sampled runs on the fused iteration: the bag drawn on each device
    # from the same key. Held to the same trees (their leaf counts are the
    # in-bag rows') and raw scores within 1e-4; where two thresholds tie
    # for a leaf's in-bag rows, f32 rounding picks one on each device and
    # the out-of-bag rows between them go each device's way (ROADMAP
    # section 3), so raw scores are then held on the other rows, with at
    # most 2 % of the rows so separated. Compact quantized keeps its
    # witness exemption. GOSS may grow other sampled trees only where its
    # own witness shows that the devices' samples differ from the same
    # scores, with its warm-up trees equal and its sampler bit-exact from
    # the same gradients.
    part_done("strategies")
    goss = {"boosting": "goss", "learning_rate": 0.5}
    for strategy, quant, name, extra in (
            ("compact", False, "bagging", {"bagging_fraction": 0.7,
                                           "bagging_freq": 1}),
            ("compact", True, "bagging", {"bagging_fraction": 0.7,
                                          "bagging_freq": 1}),
            ("compact", False, "goss", goss), ("compact", True, "goss", goss),
            ("masked", False, "bagging", {"bagging_fraction": 0.7,
                                          "bagging_freq": 1}),
            ("masked", True, "bagging", {"bagging_fraction": 0.7,
                                         "bagging_freq": 1}),
            ("masked", False, "goss", goss), ("masked", True, "goss", goss)):
        os.environ["LGBM_TPU_STRATEGY"] = strategy
        qp = dict(sp, quantized_grad=quant, grad_bits=8, **extra)
        on_card = lgb.train(qp, ds_of(ys),
                            num_boost_round=REF_ROUNDS)
        on_cpu = lgb.train(qp, ds_of(ys),
                           num_boost_round=REF_ROUNDS,
                           device="cpu")
        diff = np.abs(on_card.predict(xs, raw_score=True)
                      - on_cpu.predict(xs, raw_score=True))
        lr = on_card._gbdt.learner
        row = {"strategy": strategy, "quantized_grad": quant,
               "growth": "device loop", "sampling": name, "settings": extra,
               "fused_steps": len(on_card._gbdt._fused_step or {}),
               "host_syncs_per_tree": lr.stats.host_syncs
               / max(lr.stats.trees, 1),
               "same_trees": shape_of(on_card) == shape_of(on_cpu),
               "max_abs_raw_diff": float(diff.max()), "raw_tolerance": 1e-4}
        ok = row["same_trees"] and row["max_abs_raw_diff"] <= 1e-4
        if row["same_trees"] and not ok:
            sep = tie_separated(on_card, on_cpu)
            row["tie_separated_rows"] = int(sep.sum())
            row["max_abs_raw_diff_other_rows"] = float(diff[~sep].max())
            ok = sep.mean() <= 0.02 \
                and row["max_abs_raw_diff_other_rows"] <= 1e-4
        if not row["same_trees"] and name == "goss":
            # the first iteration whose tree differs; GOSS samples from
            # iteration 2 on (learning_rate 0.5)
            first = next(i for i, (a, b) in enumerate(zip(
                shape_of(on_card), shape_of(on_cpu))) if a != b)
            wit = goss_witness(qp, first)
            row["goss_witness"] = wit
            row["other_trees_allowed"] = ok = bool(
                first >= 2 and wit["trees_before_equal"]
                and wit["bag_rows_differ"] > 0
                and wit["sampler_equal_from_same_gradients"])
        elif not (row["same_trees"] and ok) and strategy == "compact" \
                and quant:
            # other trees, or the same trees whose leaves sum other
            # stored integers
            wit = gradient_witness(on_card, qp, strategy)
            row["gradient_witness"] = wit
            row["witness_stored_rows_differ"] = sum(
                w["stored_rows_differ"] for w in wit)
            row["other_trees_allowed"] = ok = \
                row["witness_stored_rows_differ"] > 0
        row["ok"] = bool(ok and row["host_syncs_per_tree"] == 1
                         and row["fused_steps"] == (2 if name == "goss"
                                                    else 1))
        ref_rows.append(row)
    part_done("sampled")
    ref_rows += valid_reference_rows(lgb, sp, xs, ys, w_small, shape_of,
                                     ds_of)
    part_done("validation")
    ref_rows += categorical_reference_rows(torch, lgb, params, f)
    part_done("categorical")
    ref_rows += objective_reference_rows(torch, dev, lgb, sp, xs, w_small,
                                         shape_of, _quant_prepare, prng_key,
                                         ds_of)
    part_done("objectives")
    ref_rows += boosting_reference_rows(torch, dev, lgb, sp, xs, ys,
                                        shape_of, _quant_prepare, prng_key,
                                        ds_of)
    part_done("rank_and_boosting")
    ref_rows += learner_reference_rows(torch, dev, lgb, params, f,
                                       _quant_prepare, quant_ops, prng_key)
    part_done("learners")
    repeats = formerly_flaky_cases(torch, dev, lgb, k1, Config,
                                   DeviceTreeLearner, record_cols)
    part_done("formerly_flaky")
    os.environ.pop("LGBM_TPU_STRATEGY", None)
    emit({"phase": "reference", "rows": 20_000, "rounds": REF_ROUNDS,
          "seconds": seconds,
          "runs": ref_rows, "formerly_flaky_cases": repeats})
    if not all(rw["ok"] for rw in ref_rows):
        fail("card and CPU runs disagree on the small reference tasks")
    if not all(c["agree"] == c["runs"] for c in repeats):
        fail("a formerly flaky card-vs-plain case disagreed: %s" % repeats)


def learners_phase(torch, lgb, params, ds, dsm, x, xv, yv, rounds,
                   timed_train, growth, steady_s, profile_one, dense=None):
    """train_learners: per-node feature sampling, the LRU-capped
    histogram pool and the host-loop serial learner on the train phase's
    rows. higgs-1m with feature_fraction_bynode 0.5 (float and quantized)
    and higgs-60k-masked with it (float), on the fused iteration of the
    device loops; higgs-1m with histogram_pool_size 2 (97 LRU slots of
    28 x 64 x 12 bytes for 255 leaves), float and quantized, beside the
    dense pool's run of the same settings; then the serial learner (3
    rounds, the generic iteration) with a forced-splits JSON (feature 0 at
    its median at the root, features 1 and 2 at theirs below), float and
    quantized, and with cegb_penalty_split at the 50th, then 75th, then
    90th percentile of the gain per row of the float run's last tree's
    unforced splits, until a run grows fewer leaves. `dense` holds the train / train_quant phases' runs
    (the same data and params on the dense pool, in this call) by "float"
    and "quant": their rows stand in for the dense-pool runs. Gates: the
    device runs' fused iteration at 1 host sync per tree, held-out AUC >
    0.7 (not for CEGB, which trades it for fewer splits), the LRU runs'
    AUC within 0.001 of their dense pool's, the forced splits on top of
    every serial tree, fewer leaves under CEGB. Returns (row,
    problems)."""
    import tempfile
    from lightgbm_tpu_torch.models.device_learner import plan_histogram_pool
    # every key of the cases set in every run: a Booster writes its
    # parameters into its Dataset's config, which the next one inherits
    plain = {"objective": "binary", "num_class": 1, "boosting": "gbdt",
             "metric": ["binary_logloss"], "quantized_grad": False,
             "grad_bits": 8, "bagging_fraction": 1.0, "bagging_freq": 0,
             "pos_bagging_fraction": 1.0, "neg_bagging_fraction": 1.0,
             "feature_fraction": 1.0, "feature_fraction_bynode": 1.0,
             "histogram_pool_size": -1.0, "forcedsplits_filename": "",
             "cegb_tradeoff": 1.0, "cegb_penalty_split": 0.0}
    quant = {"quantized_grad": True}
    runs, problems, kept = [], [], {}

    def run(name, extra, dset, n_rounds, profiled=False, steady=True):
        p = dict(params, **dict(plain, **extra))
        b, counts, secs, peak = timed_train(p, dset, rounds=n_rounds)
        lr = b._gbdt.learner
        row = dict({"case": name, "settings": extra, "rounds": n_rounds,
                    "learner": type(lr).__name__,
                    "strategy": getattr(lr, "strategy", None),
                    "iteration": "fused" if b._gbdt._fused_step
                    else "generic", "launches": counts},
                   **growth(b, counts, secs))
        row.update({"train_s": secs, "peak_device_bytes": peak,
                    "valid_auc": auc(yv, b.predict(xv))})
        if profiled:
            prof = profile_one(b)
            row["profile"] = {k: prof[k] for k in (
                "k1", "k3", "device_ms", "device_launches", "wall_ms",
                "device_busy_share")}
        if steady:
            row["s_per_iter_steady"] = steady_s(b)
        runs.append(row)
        return b, row

    def check(row, want_learner, want_strategy, auc_gate=True):
        bad = []
        if row["learner"] != want_learner or (
                want_strategy and row["strategy"] != want_strategy):
            bad.append("took %s (%s)" % (row["learner"], row["strategy"]))
        if want_learner == "DeviceTreeLearner" and (
                row["iteration"] != "fused"
                or row["host_syncs_per_tree"] != 1):
            bad.append("%s iteration, %s host syncs per tree"
                       % (row["iteration"], row["host_syncs_per_tree"]))
        if auc_gate and not row["valid_auc"] > 0.7:
            bad.append("held-out AUC %.5f" % row["valid_auc"])
        problems.extend("%s: %s" % (row["case"], b) for b in bad)

    # ---- the dense pool's runs: the LRU runs' and by-node runs' base ----
    for q in (False, True):
        name = "higgs-1m%s dense pool" % ("-quant" if q else "")
        known = (dense or {}).get("quant" if q else "float")
        if known is not None:
            kept[name] = dict(known, case=name + " (%s phase)" % (
                "train_quant" if q else "train"))
            continue
        b, row = run(name, quant if q else {}, ds, rounds, profiled=not q)
        check(row, "DeviceTreeLearner", "compact")
        kept[name] = row
        del b
    # ---- by-node sampling ----------------------------------------------
    bynode = {"feature_fraction_bynode": 0.5}
    for name, extra, dset, strategy, base in (
            ("higgs-1m bynode", bynode, ds, "compact", "higgs-1m dense pool"),
            ("higgs-1m-quant bynode", dict(bynode, **quant), ds, "compact",
             "higgs-1m-quant dense pool"),
            ("higgs-60k-masked bynode", bynode, dsm, "masked", None)):
        b, row = run(name, extra, dset, rounds, profiled=not extra.get(
            "quantized_grad") and strategy == "compact")
        check(row, "DeviceTreeLearner", strategy)
        row["bynode_k"] = b._gbdt.learner._statics()["bynode_k"]
        if base:
            row["dense_pool_captured_step_launches"] = \
                kept[base].get("captured_step_launches")
            if "profile" in row:
                row["device_launches_minus_plain"] = \
                    row["profile"]["device_launches"] \
                    - kept[base]["profile"]["device_launches"]
        if row["bynode_k"] != 14:
            problems.append("%s: bynode_k %s" % (name, row["bynode_k"]))
        del b
    # ---- the LRU-capped pool ------------------------------------------
    for q in (False, True):
        name = "higgs-1m%s LRU pool" % ("-quant" if q else "")
        base = kept["higgs-1m%s dense pool" % ("-quant" if q else "")]
        b, row = run(name, dict(quant if q else {}, histogram_pool_size=2.0),
                     ds, rounds, profiled=not q)
        check(row, "DeviceTreeLearner", "compact")
        lr = b._gbdt.learner
        row["plan_slot_bytes_pool_slots"] = list(plan_histogram_pool(
            lr.config, lr.dataset))
        row["pool_slots_in_carry"] = int(lr._carry.pool.shape[0])
        row["misses_per_tree"] = lr.stats.pool_misses / max(lr.stats.trees,
                                                            1)
        row["dense_pool_valid_auc"] = base["valid_auc"]
        row["auc_minus_dense_pool"] = row["valid_auc"] - base["valid_auc"]
        # the miss pass: a second window launch per step (GO 0 on a hit)
        key = "histogram.launches_qwin" if q else "histogram.launches_win"
        row["window_launches_per_step"] = row.get(
            "captured_step_launches", {}).get(key)
        if not q:
            pk1, dk1 = row["profile"]["k1"], base["profile"]["k1"]
            if isinstance(pk1, dict) and isinstance(dk1, dict):
                row["miss_pass_per_iteration"] = {
                    "launches": pk1["launches"] - dk1["launches"],
                    "device_ms": pk1["device_ms"] - dk1["device_ms"]}
        if not (lr._carry.pooled and row["pool_slots_in_carry"] < 255
                and row["misses_per_tree"] > 0
                and row["window_launches_per_step"] == 2):
            problems.append("%s: the pool is not LRU-capped (%s slots, %s "
                            "misses per tree, %s window launches per step)"
                            % (name, row["pool_slots_in_carry"],
                               row["misses_per_tree"],
                               row["window_launches_per_step"]))
        if abs(row["auc_minus_dense_pool"]) > 0.001:
            problems.append("%s: AUC %.5f, dense pool %.5f" % (
                name, row["valid_auc"], base["valid_auc"]))
        del b
    # ---- the serial learner: forced splits and CEGB -------------------
    med = np.median(x[:, :3], axis=0)
    spec = {"feature": 0, "threshold": float(med[0]),
            "left": {"feature": 1, "threshold": float(med[1])},
            "right": {"feature": 2, "threshold": float(med[2])}}
    fd, path = tempfile.mkstemp(suffix=".json")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(spec, fh)
        forced = {"forcedsplits_filename": path}
        def serial(name, extra, cegb=False):
            b, row = run(name, extra, ds, HOST_ROUNDS, steady=False)
            check(row, "SerialTreeLearner", None, auc_gate=not cegb)
            trees = b._gbdt.models
            row["forced_on_top"] = all(
                list(t.split_feature[:3]) == [0, 1, 2]
                and t.left_child[0] == 1 and t.right_child[0] == 2
                for t in trees)
            row["leaves"] = [int(t.num_leaves) for t in trees]
            row["s_per_iter"] = row["s_per_iter_in_train"]
            lp = row["launches_per_tree"]
            row["k1_host_int_per_tree"] = lp.get("k1", 0)
            row["k3_operand_per_tree"] = lp.get("k3", 0)
            if not row["forced_on_top"]:
                problems.append("%s: the top three nodes are not the "
                                "forced splits" % name)
            k_key = "k3" if extra.get("quantized_grad") else "k1"
            if not lp.get(k_key, 0) > 0:
                problems.append("%s: no %s launch" % (name, k_key))
            return trees, row

        trees, plain_row = serial("higgs-1m serial forced", forced)
        # the gain per row of the last tree's unforced splits, where it is
        # smallest
        last = trees[-1]
        per_row = last.split_gain[3:last.num_leaves - 1] \
            / last.internal_count[3:last.num_leaves - 1]
        del trees
        serial("higgs-1m-quant serial forced", dict(forced, **quant))
        # CEGB: the split penalty per row at rising percentiles of that
        # gain per row, until it prunes (leaf-wise growth finds other
        # leaves while enough candidates keep gain > penalty x rows: at
        # 200,000 rows the median still grew every leaf, at 70,000 the
        # 90th percentile left only the forced splits); a fixed cost per
        # row trades held-out AUC for fewer splits, so the AUC is
        # recorded, not gated
        pruned = False
        for q in (50, 75, 90):
            pen = float(np.percentile(per_row, q))
            _, row = serial("higgs-1m serial forced cegb p%d" % q, dict(
                forced, cegb_tradeoff=1.0, cegb_penalty_split=pen), True)
            row["penalty_percentile"] = q
            if sum(row["leaves"]) < sum(plain_row["leaves"]):
                pruned = True
                break
        if not pruned:
            problems.append("CEGB pruned no split at the 50th-90th "
                            "percentile penalties")
    finally:
        os.unlink(path)
    return {"phase": "train_learners", "rows": len(x), "runs": runs}, \
        problems


def learner_reference_rows(torch, dev, lgb, params, f, _quant_prepare,
                           quant_ops, prng_key):
    """The reference phase's runs of this slice's learners, card against
    CPU, 60,000 rows, 15 leaves, REF_ROUNDS rounds: by-node sampling on
    the compact and the masked device loops (threefry is bit-exact on
    both devices: the same trees), the LRU-capped pool (histogram_pool_size
    0.15: 8 slots) on the compact device loop, quantized, and the serial
    learner (LGBM_TPU_HOST_LEARNER=1), float and quantized. Held to the
    same trees and raw scores within 1e-4; a quantized run may grow other
    trees only where its witness counts stored integers that differ
    between the devices from the same scores (the card's and the CPU's
    objective gradients may differ in the last ulp)."""
    xs, ys, _ = make_higgs_like(60_000, f, seed=61)
    sp = dict(params, num_leaves=15, min_gain_to_split=1e-3,
              min_data_in_leaf=20)
    ds_of = rebinned(lgb, xs, ys, sp)

    def shape_of(b):
        return [(list(t.split_feature[:t.num_leaves - 1]),
                 list(t.left_child[:t.num_leaves - 1]),
                 list(t.leaf_count[:t.num_leaves]))
                for t in b._gbdt.models]

    def witness(card_b, qp, serial):
        """Rows whose stored integer differs when each device's gradients
        at the CPU run's scores are quantized as that iteration's tree
        quantizes them."""
        cpu_b = lgb.train(qp, ds_of(ys), num_boost_round=1, device="cpu")
        lr = card_b._gbdt.learner
        cfg = lr.config
        total = 0
        for it in range(1, REF_ROUNDS):
            sc = cpu_b._gbdt.score_updater.score[0].clone()
            gh = [cpu_b._gbdt.objective.get_gradients(sc),
                  card_b._gbdt.objective.get_gradients(sc.to(dev))]
            if serial:
                key = prng_key((cfg.feature_fraction_seed * 9973 + 2 * it
                                + 1) % (2**31 - 1))
                packed = [quant_ops.quantize_gh(g, h, key, grad_bits=8)[0]
                          for g, h in gh]
            else:
                packed = [_quant_prepare(g, h, prng_key(it), quant_bits=8,
                                         quant_renew=lr.quant_renew)[0]
                          for g, h in gh]
            total += int((packed[0] != packed[1].cpu()).sum())
            cpu_b.update()
        return total

    rows = []
    for case, strategy, extra, serial in (
            ("bynode", "compact", {"feature_fraction_bynode": 0.5}, False),
            ("bynode", "masked", {"feature_fraction_bynode": 0.5}, False),
            ("LRU pool, quantized", "compact",
             {"histogram_pool_size": 0.15, "quantized_grad": True,
              "grad_bits": 8}, False),
            ("serial", "compact", {}, True),
            ("serial, quantized", "compact",
             {"quantized_grad": True, "grad_bits": 8}, True)):
        os.environ["LGBM_TPU_STRATEGY"] = strategy
        if serial:
            os.environ["LGBM_TPU_HOST_LEARNER"] = "1"
        try:
            qp = dict(sp, **extra)
            on_card = lgb.train(qp, ds_of(ys), num_boost_round=REF_ROUNDS)
            on_cpu = lgb.train(qp, ds_of(ys), num_boost_round=REF_ROUNDS,
                               device="cpu")
            lr = on_card._gbdt.learner
            row = {"case": case, "strategy": strategy, "rows": len(ys),
                   "learner": type(lr).__name__,
                   "learner_on_cpu": type(on_cpu._gbdt.learner).__name__,
                   "same_trees": shape_of(on_card) == shape_of(on_cpu),
                   "max_abs_raw_diff": float(np.max(np.abs(
                       on_card.predict(xs, raw_score=True)
                       - on_cpu.predict(xs, raw_score=True)))),
                   "raw_tolerance": 1e-4}
            ok = row["same_trees"] and row["max_abs_raw_diff"] <= 1e-4
            pool_ok = True
            if "histogram_pool_size" in extra:
                row["pool_slots"] = int(lr._carry.pool.shape[0])
                row["misses"] = [lr.stats.pool_misses,
                                 on_cpu._gbdt.learner.stats.pool_misses]
                pool_ok = row["pool_slots"] == 8 and min(row["misses"]) > 0
                ok = ok and row["misses"][0] == row["misses"][1]
            if not ok and extra.get("quantized_grad"):
                row["witness_stored_rows_differ"] = witness(on_card, qp,
                                                            serial)
                row["other_trees_allowed"] = ok = \
                    row["witness_stored_rows_differ"] > 0
            want = "SerialTreeLearner" if serial else "DeviceTreeLearner"
            row["ok"] = bool(ok and pool_ok and row["learner"] == want
                             and row["learner_on_cpu"] == want)
            rows.append(row)
        finally:
            os.environ.pop("LGBM_TPU_HOST_LEARNER", None)
    return rows


def rebinned(lgb, x, y, params):
    """ds_of(labels): a Dataset of the rows x binned with the mappers of one
    Dataset of x and y built here with `params` -- the bins a new Dataset
    of those rows finds under the same binning parameters, without finding
    them again (the reference phase trains ~80 runs on one set of rows;
    binning 20,000 rows on the host takes seconds)."""
    base = lgb.Dataset(x, y, params=params).construct()
    return lambda labels: lgb.Dataset(x, labels, reference=base)


def categorical_reference_rows(torch, lgb, params, f):
    """The reference phase's categorical runs, card against CPU: 20,000
    rows of bench.py's categorical variant (CAT_FEATURES columns of
    CAT_CARD categories), 31 leaves, REF_ROUNDS rounds: compact float and
    quantized, masked float, and compact float with bagging 0.7 (the
    router).

    Held to the same trees as functions of the training rows: per tree,
    the rows of each leaf on the card are the rows of one leaf on the CPU,
    and raw training scores within 1e-4. A categorical cut whose leaf has
    rows in its valid bins only is one partition from either walk
    direction (k bins left, or the other n - k), with equal gains in exact
    arithmetic; the split scan's f32 prefix sums run in another order on
    the card, so each device may call either side left, and the tree then
    differs by children swapped (other_structure_trees). Under
    bagging an out-of-bag row in a bin the leaf's bag has no rows of goes
    right on either side, so a mirrored cut sends it each device's way:
    raw scores are then held on the rows that reach matching leaves in
    every tree (at most 2 % of the rows apart)."""
    from lightgbm_tpu_torch.ops.predict import (predict_leaf_index,
                                                trees_to_arrays)
    xs, ys, _ = make_higgs_like(20_000, f, seed=99, n_cat=CAT_FEATURES)
    sp = dict(params, num_leaves=31, min_gain_to_split=1e-3,
              categorical_feature=list(range(f - CAT_FEATURES, f)))
    ds_of = rebinned(lgb, xs, ys, sp)
    xt = torch.from_numpy(xs.astype(np.float32))

    def leaves(b):
        return predict_leaf_index(xt, trees_to_arrays(
            b._gbdt.models, "cpu")).numpy()

    def shape_of(b):
        return [(list(t.split_feature[:t.num_leaves - 1]),
                 list(t.left_child[:t.num_leaves - 1]),
                 list(t.leaf_count[:t.num_leaves]), list(t.cat_threshold))
                for t in b._gbdt.models]

    rows = []
    for strategy, quant, extra in (
            ("compact", False, {}), ("compact", True, {}),
            ("masked", False, {}),
            ("compact", False, {"bagging_fraction": 0.7,
                                "bagging_freq": 1})):
        os.environ["LGBM_TPU_STRATEGY"] = strategy
        qp = dict(sp, quantized_grad=quant, grad_bits=8, **extra)
        on_card = lgb.train(qp, ds_of(ys),
                            num_boost_round=REF_ROUNDS)
        on_cpu = lgb.train(qp, ds_of(ys),
                           num_boost_round=REF_ROUNDS,
                           device="cpu")
        la, lb = leaves(on_card), leaves(on_cpu)
        # a row whose leaf pair is not the one most rows of its card leaf
        # take is separated; every tree's leaves must pair one to one
        apart = np.zeros(len(xs), bool)
        one_to_one = la.shape == lb.shape
        for t in range(min(la.shape[1], lb.shape[1])):
            pairs = la[:, t].astype(np.int64) * 4096 + lb[:, t]
            vals, counts = np.unique(pairs, return_counts=True)
            best = {}
            for v, c in zip(vals, counts):
                a_leaf = v // 4096
                if c > best.get(a_leaf, (0, 0))[0]:
                    best[a_leaf] = (c, v)
            keep = np.array([best[v // 4096][1] for v in pairs]) == pairs
            apart |= ~keep
            used = [v for _, v in best.values()]
            one_to_one &= len({v % 4096 for v in used}) == len(used)
        diff = np.abs(on_card.predict(xs, raw_score=True)
                      - on_cpu.predict(xs, raw_score=True))
        same = [a == b for a, b in zip(shape_of(on_card), shape_of(on_cpu))]
        row = {"strategy": strategy, "quantized_grad": quant,
               "growth": "device loop", "categorical": CAT_FEATURES,
               "settings": extra, "trees": len(same),
               # split features, children, leaf counts and bitsets equal
               "same_structure_trees": int(sum(same)),
               "other_structure_trees": int(len(same) - sum(same)),
               "rows_apart": int(apart.sum()),
               "leaves_one_to_one": bool(one_to_one),
               "max_abs_raw_diff": float(diff.max()),
               "max_abs_raw_diff_other_rows": float(
                   diff[~apart].max(initial=0.0)),
               "raw_tolerance": 1e-4,
               "categorical_nodes": int(sum(t.num_cat
                                            for t in on_card._gbdt.models))}
        allowed = 0.02 if extra else 0.0
        row["ok"] = bool(row["categorical_nodes"] > 0 and one_to_one
                         and apart.mean() <= allowed
                         and row["max_abs_raw_diff_other_rows"] <= 1e-4)
        rows.append(row)
    return rows


def objective_reference_rows(torch, dev, lgb, sp, xs, w_small, shape_of,
                             _quant_prepare, prng_key, ds_of):
    """The reference phase's objective runs, card against CPU on the
    20,000-row task: every objective of OBJECTIVE_TARGETS on compact float
    (the same trees, raw scores within 1e-5; fair and gamma within
    FAIR_GAMMA_TOL: their leaves divide cancelling gradient sums by small
    hessian sums, which carries the split scan's f32 sums -- added in
    another order on the card, from histograms equal bit for bit -- to
    ~1.2e-4 after 5 trees (PERF.md, PR 11); their rows carry the leaf witness, which holds
    the first tree's leaves on each device to the exact f64 -G / H within
    the f32 rounding of the split scan's sums), and
    3-class multiclass on
    compact and masked float (the same) and on compact quantized (raw
    within 1e-4 and the same trees, or -- the quantized exemption of the
    binary rows -- other trees only where the stored integers of the
    card's gradients from the CPU's scores differ). Each row carries
    "ok"."""
    rows = []
    r = np.random.RandomState(31)
    m = higgs_margin(xs, w_small)
    _, ymc, _ = make_higgs_like(len(xs), xs.shape[1], seed=99, n_classes=3)
    cases = [(o, objective_targets(kind, m, r), "compact", False,
              FAIR_GAMMA_TOL if o in ("fair", "gamma") else 1e-5)
             for o, kind in OBJECTIVE_TARGETS]
    cases += [("multiclass", ymc, st, q, 1e-4 if q else 1e-5)
              for st, q in (("compact", False), ("masked", False),
                            ("compact", True))]
    for objective, y, strategy, quant, tol in cases:
        os.environ["LGBM_TPU_STRATEGY"] = strategy
        p = dict(sp, objective=objective, quantized_grad=quant, grad_bits=8,
                 num_class=3 if objective == "multiclass" else 1)
        card = lgb.train(p, ds_of(y),
                         num_boost_round=OBJ_REF_ROUNDS)
        cpu = lgb.train(p, ds_of(y),
                        num_boost_round=OBJ_REF_ROUNDS,
                        device="cpu")
        row = {"objective": objective, "strategy": strategy,
               "quantized_grad": quant,
               "iteration": "fused" if card._gbdt._fused_step
               else "generic",
               "same_trees": shape_of(card) == shape_of(cpu),
               "max_abs_raw_diff": float(np.max(np.abs(
                   card.predict(xs, raw_score=True)
                   - cpu.predict(xs, raw_score=True)))),
               "raw_tolerance": tol}
        ok = row["max_abs_raw_diff"] <= tol
        if objective in ("fair", "gamma"):
            row["leaf_witness"] = leaf_witness(torch, dev, lgb, p, y,
                                               ds_of)
            ok = ok and all(w["within"] for w in row["leaf_witness"].values())
        if quant and not row["same_trees"]:
            row["stored_rows_differ"] = multiclass_witness(
                torch, dev, lgb, p, y, card, _quant_prepare, prng_key,
                ds_of)
            row["other_trees_allowed"] = row["stored_rows_differ"] > 0
            ok = ok and row["other_trees_allowed"]
        else:
            ok = ok and row["same_trees"]
        row["ok"] = bool(ok)
        rows.append(row)
    return rows


# card against CPU for fair and gamma: ~3x the gap measured on an H100
# 80GB HBM3 (1.23e-4, chip_smoke.py reference phase)
FAIR_GAMMA_TOL = 4e-4


def leaf_witness(torch, dev, lgb, p, y, ds_of):
    """The first tree's leaf values on the card and on the CPU against the
    exact ones: -G / H of each leaf's rows in f64 from that device's own
    f32 gradients at the init score, shrunk, plus the init score. A leaf's
    G and H come out of the split scan's f32 sums over the bins of the
    nodes above it, so each error is counted in units of one f32 rounding
    of the root's sums carried into the leaf, lr * 2^-24 (sum|g| + |G / H|
    sum h) / H; per device the largest count and relative error, and
    whether every leaf lies within 64 units (the bins of one feature's
    scan)."""
    out = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        b = lgb.train(p, ds_of(y), num_boost_round=1,
                      device=device.type)
        gb = b._gbdt
        init = gb.objective.boost_from_score(0)
        g, h = (t.double().cpu().numpy() for t in gb.objective.get_gradients(
            torch.full((len(y),), init, dtype=torch.float32,
                       device=device)))
        leaf = gb.learner.last_leaf_id.cpu().numpy()
        tree = gb.models[0]
        nl = tree.num_leaves
        gs = np.bincount(leaf, weights=g, minlength=nl)
        hs = np.bincount(leaf, weights=h, minlength=nl)
        lr = p["learning_rate"]
        exact = -gs / hs * lr + init
        got = np.asarray(tree.leaf_value[:nl], dtype=np.float64)
        err = np.abs(got - exact)
        unit = lr * 2.0 ** -24 * (np.abs(g).sum()
                                  + np.abs(gs / hs) * h.sum()) / hs
        units = float(np.max(err / unit))
        out[name] = {"max_err_in_root_f32_units": units,
                     "max_rel_err": float(np.max(
                         err / np.maximum(np.abs(exact), 1e-30))),
                     "within": units <= 64.0}
    return out


def multiclass_witness(torch, dev, lgb, p, y, card_b, _quant_prepare,
                       prng_key, ds_of, rounds=OBJ_REF_ROUNDS):
    """From the CPU run's scores after each iteration before the last of
    `rounds`, the rows whose stored (qg|qh) integers differ when the
    card's and the CPU's gradients (softmax, or any one-class objective's)
    are quantized as each class's tree quantizes them (key
    prng_key(iteration * K + class))."""
    cpu_b = lgb.train(p, ds_of(y), num_boost_round=1, device="cpu")
    lr = card_b._gbdt.learner
    k_cls = cpu_b._gbdt.num_tree_per_iteration
    differ = 0
    for it in range(1, rounds):
        sc = cpu_b._gbdt.score_updater.score.clone()
        if k_cls == 1:
            gc, hc = (t[None] for t in
                      cpu_b._gbdt.objective.get_gradients(sc[0]))
            gd, hd = (t[None] for t in
                      card_b._gbdt.objective.get_gradients(sc[0].to(dev)))
        else:
            gc, hc = cpu_b._gbdt.objective.get_gradients(sc)
            gd, hd = card_b._gbdt.objective.get_gradients(sc.to(dev))
        for c in range(k_cls):
            key = prng_key(it * k_cls + c)
            pc = _quant_prepare(gc[c], hc[c], key, quant_bits=lr.quant_bits,
                                quant_renew=lr.quant_renew)[0]
            pd = _quant_prepare(gd[c], hd[c], key, quant_bits=lr.quant_bits,
                                quant_renew=lr.quant_renew)[0].cpu()
            differ += int((pd != pc).sum())
        cpu_b.update()
    return differ


def formerly_flaky_cases(torch, dev, lgb, k1, Config, DeviceTreeLearner,
                         record_cols, runs=3):
    """The two card-vs-plain float cases that failed now and then while
    the blocks' f32 partials met in atomic order, each run `runs` times:
    K1 over 100,003 rows of 11 int32 codes of 16 bins against its plain
    version (rtol = atol = 1e-4, counts equal; tests/test_torch_gpu.py
    test_k1_matches_plain[16-dtype3-11]), and the masked core's captured
    20,000-row tree against the same step on the CPU from the same
    gradients (leaf, feature and count columns and leaf ids equal;
    test_masked_captured_tree_matches_cpu[False]). Returns the count of
    runs that agree, per case."""
    _, R_FEAT, R_LCNT, R_LEAF, R_RCNT, _ = record_cols
    r = np.random.RandomState(16)
    p = 100_003
    codes = torch.from_numpy(r.randint(0, 16, size=(p, 11))).to(
        dev, torch.int32)
    gh = torch.from_numpy(np.stack([r.randn(p), r.rand(p), np.ones(p)], 1)
                          .astype(np.float32)).to(dev)
    gh[99_000:] = 0.0
    want = k1.build_histogram_plain(codes, gh, 16)
    agree = 0
    for _ in range(runs):
        got = k1.build_histogram(codes, gh, 16)
        agree += bool(torch.allclose(got, want, rtol=1e-4, atol=1e-4)
                      and torch.equal(got[..., 2], want[..., 2]))
    out = [{"case": "K1 (100,003 x 11) int32 codes, 16 bins vs plain",
            "runs": runs, "agree": agree}]
    # the card test's learner: 20,000 rows of 12 features, NaNs in one,
    # fixed gradients with signal
    r = np.random.RandomState(9)
    n = 20_000
    x = r.randn(n, 12)
    x[r.rand(n) < 0.03, 2] = np.nan
    mp = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
          "min_data_in_leaf": 20, "min_gain_to_split": 1e-3,
          "verbosity": -1}
    inner = lgb.Dataset(x, (x[:, 0] > 0).astype(float), params=mp) \
        .construct()._inner
    g = (x[:, 0] > 0.3) - 0.5 + 0.3 * r.randn(n) \
        + 0.2 * np.nan_to_num(x[:, 2])
    h = 0.1 + r.rand(n)
    gt, ht = (torch.from_numpy(a.astype(np.float32)) for a in (g, h))
    cpu = DeviceTreeLearner(Config(mp), inner, strategy="masked",
                            device="cpu")
    want = [cpu.grow(gt, ht, iter_seed=s) for s in (0, 1)]
    card = DeviceTreeLearner(Config(mp), inner, strategy="masked",
                             device=dev)
    ints = [R_LEAF, R_FEAT, R_LCNT, R_RCNT]
    agree = 0
    for _ in range(runs):
        ok = True
        for s, (crec, cleaf, ck) in zip((0, 1), want):
            rec, leaf, k = card.grow(gt.to(dev), ht.to(dev), iter_seed=s)
            ok = ok and k == ck and np.array_equal(rec[:, ints],
                                                   crec[:, ints]) \
                and torch.equal(leaf.cpu(), cleaf)
        agree += bool(ok)
    out.append({"case": "masked captured 20,000-row tree vs the CPU",
                "runs": runs, "agree": agree})
    return out


def valid_reference_rows(lgb, sp, xs, ys, w_small, shape_of, ds_of):
    """The reference phase's validation-set runs, card against CPU on the
    20,000-row task: early stopping with a 5,000-row validation set on
    each strategy, a lambda_l2 reset at iteration 2 on each strategy, and a
    3-fold cv of 3 rounds. Each row carries "ok"."""
    xv, yv, _ = make_higgs_like(5_000, xs.shape[1], seed=100, w=w_small)
    rows = []

    def leaves(b, x):
        return np.array([[t.predict_leaf_row(r) for t in b._gbdt.models]
                         for r in x])

    # early stopping: learning_rate 0.5 overfits the 31-leaf trees within
    # the 40 rounds
    es = dict(sp, learning_rate=0.5, metric=["binary_logloss", "auc"])
    for strategy in ("compact", "masked"):
        os.environ["LGBM_TPU_STRATEGY"] = strategy
        runs = []
        for device in (None, "cpu"):
            dtr = ds_of(ys)
            ev = {}
            b = lgb.train(es, dtr, 40, valid_sets=[dtr.create_valid(xv, yv)],
                          valid_names=["valid"], early_stopping_rounds=5,
                          evals_result=ev, verbose_eval=False, device=device)
            runs.append((b, ev))
        (card, cev), (cpu, pev) = runs
        diffs = {m: float(np.max(np.abs(np.array(cev["valid"][m])
                                        - np.array(pev["valid"][m]))))
                 for m in pev["valid"]}
        row = {"case": "early stopping", "strategy": strategy,
               "best_iteration": [card.best_iteration, cpu.best_iteration],
               "history_len": len(cev["valid"]["auc"]),
               "valid_history_max_abs_diff": diffs,
               "training_history_max_abs_diff": float(np.max(np.abs(
                   np.array(cev["training"]["binary_logloss"])
                   - np.array(pev["training"]["binary_logloss"])))),
               "host_syncs_per_tree": card._gbdt.learner.stats.host_syncs
               / max(card._gbdt.learner.stats.trees, 1)}
        ok = (card.best_iteration == cpu.best_iteration > 0
              and card.best_iteration < 35
              and row["training_history_max_abs_diff"] <= 1e-4
              and row["host_syncs_per_tree"] == 1)
        if max(diffs.values()) > 1e-4 and shape_of(card) == shape_of(cpu):
            # validation rows that reach another leaf on the two devices
            # (tied thresholds, see the bagged rows above): the metrics
            # on the others, every iteration
            sep = (leaves(card, xv) != leaves(cpu, xv)).any(axis=1)
            row["tie_separated_rows"] = int(sep.sum())
            other = 0.0
            for it in range(1, row["history_len"] + 1):
                a, c = (auc(yv[~sep], b.predict(xv[~sep], raw_score=True,
                                                 num_iteration=it))
                        for b in (card, cpu))
                other = max(other, abs(a - c))
            row["valid_auc_max_abs_diff_other_rows"] = other
            ok = ok and sep.mean() <= 0.02 and other <= 1e-4
        elif max(diffs.values()) > 1e-4:
            ok = False
        row["ok"] = bool(ok)
        rows.append(row)

    # a lambda_l2 reset at iteration 2: one more capture, the CPU's trees
    l2 = [0.0, 0.0, 50.0, 50.0, 50.0]
    rp = dict(sp, lambda_l2=0.0)
    for strategy in ("compact", "masked"):
        os.environ["LGBM_TPU_STRATEGY"] = strategy
        runs = []
        for device in (None, "cpu"):
            caps = []
            b = lgb.train(rp, ds_of(ys), 5, device=device,
                          verbose_eval=False, callbacks=[
                              lgb.reset_parameter(lambda_l2=l2),
                              lambda env: caps.append(
                                  env.model._gbdt.learner.stats.captures)])
            runs.append((b, caps))
        (card, ccaps), (cpu, _) = runs
        diff = float(np.max(np.abs(card.predict(xs, raw_score=True)
                                   - cpu.predict(xs, raw_score=True))))
        row = {"case": "reset lambda_l2 at iteration 2",
               "strategy": strategy, "captures_after_each_iteration": ccaps,
               "graph_captured": card._gbdt.learner._loop.graph is not None,
               "same_trees": shape_of(card) == shape_of(cpu),
               "max_abs_raw_diff": diff}
        row["ok"] = bool(ccaps == [1, 1, 2, 2, 2] and row["same_trees"]
                         and row["graph_captured"] and diff <= 1e-4)
        rows.append(row)

    # cv: three learners capture their loops in turn
    os.environ.pop("LGBM_TPU_STRATEGY", None)
    cp = dict(sp, metric=["binary_logloss", "auc"])
    card = lgb.cv(cp, ds_of(ys), 3, nfold=3)
    cpu = lgb.cv(cp, ds_of(ys), 3, nfold=3, device="cpu")
    diffs = {k: float(np.max(np.abs(np.array(card[k]) - np.array(cpu[k]))))
             for k in cpu}
    rows.append({"case": "cv 3-fold, 3 rounds", "keys": sorted(card),
                 "max_abs_diff": diffs,
                 "ok": bool(sorted(card) == sorted(cpu)
                            and max(diffs.values()) <= 1e-4)})
    return rows


# rounds of the dp phase's two-rank run (gloo, on one card) and its
# collective timing repeats
DP_GLOO_ROUNDS = 5
DP_COLL_REPS = 200

_DP_CHILD = r"""
import json, os, sys, time
import numpy as np
sys.path.insert(0, sys.argv[1])
os.environ["LGBM_TPU_DP_REDUCE"] = "psum"
import torch
import chip_smoke
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.distributed import bootstrap
from lightgbm_tpu_torch.parallel import network
rank, port, rows, rounds, out = (int(sys.argv[2]), sys.argv[3],
                                 int(sys.argv[4]), int(sys.argv[5]),
                                 sys.argv[6])
params = json.loads(sys.argv[7])
bootstrap.initialize("127.0.0.1:" + port, 2, rank)
x, y, _ = chip_smoke.make_higgs_like(rows, 28)
ds = lgb.Dataset(x, y, params=params)
ds.construct()
bootstrap.barrier("data")
torch.cuda.synchronize()
t0 = time.time()
b = lgb.train(dict(params, tree_learner="data"), ds, rounds)
torch.cuda.synchronize()
secs = time.time() - t0
lr = b._gbdt.learner
coll = network.collectives
# the collective of the split step: one all-reduce of a (C, B, 3) f32
# histogram over gloo, timed between syncs
h = torch.zeros((lr.c_cols, lr.col_device_bins, 3), device=lr.device)
for _ in range(3):
    network.all_reduce(h)
torch.cuda.synchronize()
t1 = time.time()
for _ in range(50):
    network.all_reduce(h)
torch.cuda.synchronize()
coll_ms = (time.time() - t1) / 50 * 1e3
with open(out, "w") as f:
    f.write(b.model_to_string())
# the split gains at f32 precision (the text keeps 6 digits)
with open(out + ".gains.json", "w") as f:
    json.dump([t.split_gain[:t.num_leaves - 1].tolist()
               for t in b._gbdt.models], f)
print(json.dumps({"rank": rank, "rows": list(lr.row_block),
                  "train_s": secs, "trees": lr.stats.trees,
                  "host_syncs": lr.stats.host_syncs,
                  "captured": lr._loop.graph is not None,
                  "collectives": coll, "collective_ms": coll_ms,
                  "backend": bootstrap.cuda_backend()}), flush=True)
bootstrap.shutdown()
"""


def capi_phase(torch, lgb, params, x, y, xv, yv, rounds, reset_counts,
               read_counts):
    """The C ABI on the card: the higgs-1m rows trained through
    lib_lightgbm_tpu_torch.so by ctypes in this process (DatasetCreateFromMat
    -> SetField -> BoosterCreate -> UpdateOneIter x rounds -> GetEval ->
    PredictForMat on the held-out rows -> SaveModelToString), held against
    engine.train with the same params in this call: byte-equal model text,
    predictions within 1e-6. Returns (row, problems, the launches of K1's
    and K4's window entries and the split key in the ABI's run, the
    reference booster with its dataset and s per iteration)."""
    from lightgbm_tpu_torch.ops.kernels import build
    problems = []
    t0 = time.time()
    lib = ctypes.CDLL(build.capi_library())
    build_s = time.time() - t0
    lib.LGBM_GetLastError.restype = ctypes.c_char_p

    def check(rc, what):
        if rc != 0:
            fail("capi: %s: %s" % (what, lib.LGBM_GetLastError().decode()))
    pstr = " ".join("%s=%s" % kv for kv in params.items()).encode()
    xf = np.ascontiguousarray(x, dtype=np.float64)
    n, f = xf.shape
    ds, bst = ctypes.c_void_p(), ctypes.c_void_p()
    t0 = time.time()
    check(lib.LGBM_DatasetCreateFromMat(
        xf.ctypes.data_as(ctypes.c_void_p), 1, n, f, 1, pstr, None,
        ctypes.byref(ds)), "DatasetCreateFromMat")
    yl = np.ascontiguousarray(y, dtype=np.float32)
    check(lib.LGBM_DatasetSetField(ds, b"label", yl.ctypes.data_as(
        ctypes.c_void_p), n, 0), "SetField")
    data_s = time.time() - t0
    del xf
    check(lib.LGBM_BoosterCreate(ds, pstr, ctypes.byref(bst)),
          "BoosterCreate")
    reset_counts()
    fin = ctypes.c_int()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(rounds):
        check(lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)),
              "UpdateOneIter")
    torch.cuda.synchronize()
    train_s = time.time() - t0
    counts = read_counts()
    cnt = ctypes.c_int()
    check(lib.LGBM_BoosterGetEvalCounts(bst, ctypes.byref(cnt)),
          "GetEvalCounts")
    ev = (ctypes.c_double * max(cnt.value, 1))()
    out_len = ctypes.c_int()
    check(lib.LGBM_BoosterGetEval(bst, 0, ctypes.byref(out_len), ev),
          "GetEval")
    xvf = np.ascontiguousarray(xv, dtype=np.float64)
    pred = np.zeros(xv.shape[0])
    olen = ctypes.c_int64()
    check(lib.LGBM_BoosterPredictForMat(
        bst, xvf.ctypes.data_as(ctypes.c_void_p), 1, xv.shape[0], f, 1, 0,
        -1, b"", ctypes.byref(olen),
        pred.ctypes.data_as(ctypes.POINTER(ctypes.c_double))),
        "PredictForMat")
    check(lib.LGBM_BoosterSaveModelToString(bst, 0, -1, 0,
                                            ctypes.byref(olen), None),
          "SaveModelToString")
    buf = ctypes.create_string_buffer(olen.value)
    check(lib.LGBM_BoosterSaveModelToString(bst, 0, -1, olen.value,
                                            ctypes.byref(olen), buf),
          "SaveModelToString")
    text = buf.value.decode()
    check(lib.LGBM_BoosterFree(bst), "BoosterFree")
    check(lib.LGBM_DatasetFree(ds), "DatasetFree")

    # engine.train with the same params, in this call
    ref_ds = lgb.Dataset(x, y, params=dict(params))
    ref_ds.construct()
    torch.cuda.synchronize()
    t0 = time.time()
    ref = lgb.train(dict(params), ref_ds, rounds)
    torch.cuda.synchronize()
    ref_s = (time.time() - t0) / rounds
    want = ref.predict(xv)
    err = float(np.abs(pred - want).max())
    equal = text == ref.model_to_string()
    if not equal:
        problems.append("the C ABI's model text differs from engine.train's")
    if not err <= 1e-6:
        problems.append("C ABI predictions off Booster.predict by %g" % err)
    if ref._gbdt.device.type != "cuda":
        problems.append("engine.train did not run on the card")
    launched = {k: counts[k] for k in ("k1_win", "k4_win", "split_key")}
    if not all(launched.values()):
        problems.append("the C ABI's run launched no %s" % [
            k for k, v in launched.items() if not v])
    want_eval = [v for _, _, v, _ in ref.eval_train()]
    row = {"phase": "capi", "rows": n, "rounds": rounds,
           "capi_build_s": build_s, "capi_data_s": data_s,
           "capi_s_per_iter": train_s / rounds,
           "engine_s_per_iter": ref_s, "model_text_equal": equal,
           "model_bytes": len(text),
           "eval": list(ev[:out_len.value]), "engine_eval": want_eval,
           "predict_max_abs_err": err, "held_out_auc": auc(yv, pred),
           "capi_launches": launched}
    return row, problems, launched, (ref, ref_ds, ref_s)


def _strip_learner(text):
    """Model text without its [tree_learner: ...] parameter line."""
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("[tree_learner"))


def _structural_diff(a, b, n_trees, band=1e-4, tie_band=2e-5):
    """(first difference, largest relative gain gap, nodes whose bin
    thresholds differ) between the first n_trees trees of two GBDTs, as
    tests/test_parallel.py's assert_trees_structurally_equal holds them:
    the same split feature and counts at every node, gains within `band`
    relative (histograms summed in another order round apart), and a node
    whose threshold differs only on a tie, its gains within `tie_band`
    (ROADMAP.md section 3). The first difference is None when equal."""
    worst, moved, first = 0.0, 0, None
    for ti in range(n_trees):
        ta, tb = a.models[ti], b.models[ti]
        if ta.num_leaves != tb.num_leaves:
            return ("tree %d: %d vs %d leaves" % (ti, ta.num_leaves,
                                                  tb.num_leaves),
                    worst, moved)
        for i in range(ta.num_leaves - 1):
            if int(ta.split_feature[i]) != int(tb.split_feature[i]) or \
                    int(ta.internal_count[i]) != int(tb.internal_count[i]):
                return ("tree %d node %d: feature / count" % (ti, i),
                        worst, moved)
            ga, gb = float(ta.split_gain[i]), float(tb.split_gain[i])
            rel = abs(ga - gb) / max(1.0, abs(ga))
            worst = max(worst, rel)
            tie = float(ta.threshold[i]) != float(tb.threshold[i])
            moved += tie
            if first is None and rel > (tie_band if tie else band):
                first = "tree %d node %d: gain %r vs %r%s" % (
                    ti, i, ga, gb, " (threshold differs)" if tie else "")
    return first, worst, moved


def _f64_gains(gbdt, inner, label, n_trees, l2=0.0, min_gain=0.0):
    """The split gains of a binary model's first n_trees trees summed in
    f64: each tree's partition of the training rows (routed on their bin
    codes), gradients from f64 scores (the init score, then the model's
    own leaf values, the first tree's holding the init score). Per tree,
    (f64 gains, f64 counts) by node; the counts hold the routing to the
    model's own."""
    from lightgbm_tpu_torch.models.tree import (K_CATEGORICAL_MASK,
                                                K_DEFAULT_LEFT_MASK,
                                                MISSING_NAN, MISSING_ZERO)
    codes = inner.binned
    n = codes.shape[0]
    mappers = [inner.bin_mappers[f] for f in inner.used_features]
    last_bin = np.array([m.num_bin - 1 for m in mappers])
    default_bin = np.array([m.default_bin for m in mappers])
    sign = np.where(label > 0, 1.0, -1.0)
    p = float(np.mean(label > 0))
    score = np.full(n, np.log(p / (1.0 - p)))
    out = []
    for t in gbdt.models[:n_trees]:
        r = -sign / (1.0 + np.exp(sign * score))
        g, h = r, np.abs(r) * (1.0 - np.abs(r))
        dt = t.decision_type.astype(np.int64)
        if np.any(dt[:t.num_leaves - 1] & K_CATEGORICAL_MASK):
            raise ValueError("_f64_gains routes numerical splits only")
        node = np.zeros(n, dtype=np.int64)     # >= 0 internal, < 0 ~leaf
        live = np.arange(n)
        while live.size:
            nd = node[live]
            f = t.split_feature_inner[nd]
            c = codes[live, f].astype(np.int64)
            mt = (dt[nd] >> 2) & 3
            missing = ((mt == MISSING_NAN) & (c == last_bin[f])) \
                | ((mt == MISSING_ZERO) & (c == default_bin[f]))
            left = np.where(missing, (dt[nd] & K_DEFAULT_LEFT_MASK) > 0,
                            c <= t.threshold_in_bin[nd])
            nxt = np.where(left, t.left_child[nd], t.right_child[nd])
            node[live] = nxt
            live = live[nxt >= 0]
        leaf = ~node
        k = t.num_leaves
        sums = {~j: (s_g, s_h, s_c) for j, (s_g, s_h, s_c) in enumerate(zip(
            np.bincount(leaf, g, k), np.bincount(leaf, h, k),
            np.bincount(leaf, minlength=k)))}
        gains, counts = np.zeros(k - 1), np.zeros(k - 1, dtype=np.int64)
        for i in range(k - 2, -1, -1):   # children after their parent
            gl, hl, cl = sums[t.left_child[i]]
            gr, hr, cr = sums[t.right_child[i]]
            sums[i] = (gl + gr, hl + hr, cl + cr)
            gains[i] = (gl * gl / (hl + l2) + gr * gr / (hr + l2)
                        - (gl + gr) ** 2 / (hl + hr + l2) - min_gain)
            counts[i] = cl + cr
        out.append((gains, counts))
        # the first tree's leaf values carry the init score
        score = t.leaf_value[leaf] + (score if out[1:] else 0.0)
    return out


def _f64_witness(ser, dp, inner, label, n_trees, cfg):
    """Where the f32 split gains of two models of the same partitions
    part: each model's gains summed in f64 (_f64_gains), the largest
    relative gap between the two models' f64 gains, each model's largest
    f32 gap to its own f64 gains, and, at the node where the f32 gains
    part most, the four gains."""
    both = [_f64_gains(m, inner, label, n_trees, cfg.lambda_l2,
                       cfg.min_gain_to_split) for m in (ser, dp)]
    rel = lambda a, b: abs(a - b) / max(1.0, abs(b))    # noqa: E731
    row = {"f64_gap": 0.0, "serial_f32_vs_f64": 0.0, "dp_f32_vs_f64": 0.0,
           "routing_counts_equal": True, "at_widest_f32_gap": None}
    widest = -1.0
    for ti in range(n_trees):
        ts, td = ser.models[ti], dp.models[ti]
        (es, cs), (ed, cd) = both[0][ti], both[1][ti]
        row["routing_counts_equal"] &= bool(
            np.array_equal(cs, ts.internal_count[:len(cs)])
            and np.array_equal(cd, td.internal_count[:len(cd)]))
        for i in range(len(es)):
            fs, fd = float(ts.split_gain[i]), float(td.split_gain[i])
            row["f64_gap"] = max(row["f64_gap"], rel(ed[i], es[i]))
            row["serial_f32_vs_f64"] = max(row["serial_f32_vs_f64"],
                                           rel(fs, es[i]))
            row["dp_f32_vs_f64"] = max(row["dp_f32_vs_f64"], rel(fd, ed[i]))
            if rel(fd, fs) > widest:
                widest = rel(fd, fs)
                row["at_widest_f32_gap"] = {
                    "tree": ti, "node": i, "f32_gap": widest,
                    "serial_f32": fs, "serial_f64": float(es[i]),
                    "dp_f32": fd, "dp_f64": float(ed[i])}
    return row


def dp_phase(torch, lgb, params, rows, xv, yv, rounds, serial,
             reset_counts, read_counts):
    """tree_learner=data on the card: (a) world size 1 under NCCL in this
    process (a TCP store on localhost) on the capi phase's dataset,
    byte-equal to the serial compact run of the same call (`serial`:
    booster, dataset, s per iteration) at one host sync per tree, the
    split step captured with its collective inside; (b) two ranks as
    subprocesses under gloo on CUDA tensors, psum mode, DP_GLOO_ROUNDS
    rounds on `rows` rows (each rank half), byte-equal between the ranks,
    structurally equal to the serial run's first trees, held-out AUC > 0.7
    and within 0.001 of the serial run's. Returns (row, problems, the
    launches of K1's and K4's window entries and the split key in (a))."""
    import socket
    from lightgbm_tpu_torch.distributed import bootstrap
    from lightgbm_tpu_torch.parallel import network
    problems = []
    ser, ser_ds, ser_s = serial

    def free_port():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    # ---- (a) world size 1, NCCL, captured ---------------------------------
    bootstrap.initialize("127.0.0.1:%d" % free_port(), 1, 0)
    backend = bootstrap.cuda_backend()
    reset_counts()
    network.collectives = network.collective_bytes = 0
    torch.cuda.synchronize()
    t0 = time.time()
    b = lgb.train(dict(params, tree_learner="data"), ser_ds, rounds)
    torch.cuda.synchronize()
    dp_s = (time.time() - t0) / rounds
    counts = read_counts()
    equal = _strip_learner(b.model_to_string()) \
        == _strip_learner(ser.model_to_string())
    lr = b._gbdt.learner
    trees = max(lr.stats.trees, 1)
    syncs_per_tree = lr.stats.host_syncs / trees
    coll_per_tree = network.collectives / trees
    bytes_per_tree = network.collective_bytes / trees
    step = {k.rsplit(".", 1)[-1]: v
            for k, v in (lr._loop.launches_per_step or {}).items()}
    h = torch.zeros((lr.c_cols, lr.col_device_bins, 3), device=lr.device)
    coll_ms = time_ms(torch, lambda: network.all_reduce(h), DP_COLL_REPS)
    coll_dev_ms = time_ms(torch, lambda: network.all_reduce(h),
                          DP_COLL_REPS, hold=True)
    # steady iterations, the serial and the data-parallel booster in turn
    steady = {"serial": [], "dp": []}
    for _ in range(3):
        for name, bb in (("serial", ser), ("dp", b)):
            torch.cuda.synchronize()
            t1 = time.time()
            bb.update()
            torch.cuda.synchronize()
            steady[name].append(time.time() - t1)
    if backend != "nccl":
        problems.append("world size 1 ran on %s, not NCCL" % backend)
    if not equal:
        problems.append("world-size-1 data-parallel model text differs "
                        "from the serial compact run's")
    if syncs_per_tree != 1:
        problems.append("%g host syncs per tree" % syncs_per_tree)
    if lr._loop.graph is None or step.get("collectives", 0) < 1:
        problems.append("the split step was not captured with its "
                        "collective inside (%s)" % step)
    launched = {k: counts[k] for k in ("k1_win", "k4_win", "split_key")}
    if not all(launched.values()):
        problems.append("the data-parallel run launched no %s" % [
            k for k, v in launched.items() if not v])
    bootstrap.shutdown()
    a_row = {"backend": backend, "s_per_iter": dp_s,
             "serial_s_per_iter": ser_s, "model_text_equal": equal,
             "host_syncs_per_tree": syncs_per_tree, "captured_step": step,
             "collectives_per_tree": coll_per_tree,
             "collective_bytes_per_tree": bytes_per_tree,
             "steady_s_per_iter": float(np.median(steady["dp"])),
             "serial_steady_s_per_iter": float(np.median(steady["serial"])),
             "collective_ms": coll_ms, "collective_device_ms": coll_dev_ms,
             "collective_device_ms_per_tree": coll_dev_ms * coll_per_tree,
             "dp_launches": launched}

    # ---- (b) two ranks on the one card, gloo, uncaptured ------------------
    tmp = tempfile.mkdtemp(prefix="dp_phase_")
    port = str(free_port())
    here = os.path.dirname(os.path.abspath(__file__))
    outs = [os.path.join(tmp, "model%d.txt" % r) for r in range(2)]
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DP_CHILD, here, str(r), port, str(rows),
         str(DP_GLOO_ROUNDS), outs[r], json.dumps(params)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            if p.returncode != 0:
                fail("dp: a gloo rank exited %d:\n%s" % (p.returncode,
                                                          err[-3000:]))
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.time() - t0
    texts = [open(o).read() for o in outs]
    with open(outs[0] + ".gains.json") as f:
        gains = json.load(f)
    shutil.rmtree(tmp, ignore_errors=True)
    gb = lgb.Booster(model_str=texts[0])
    for t, gt in zip(gb._gbdt.models, gains):
        t.split_gain[:len(gt)] = gt
        t.rebin_inner(ser_ds._inner)
    g_auc = auc(yv, gb.predict(xv))
    s_auc = auc(yv, ser.predict(xv, num_iteration=DP_GLOO_ROUNDS))
    diff, gain_rel, moved = _structural_diff(ser._gbdt, gb._gbdt,
                                             DP_GLOO_ROUNDS)
    # the witness of the f32 gains' gap: the same partitions summed in f64
    t0 = time.time()
    witness = None
    if diff is None:
        witness = _f64_witness(ser._gbdt, gb._gbdt, ser_ds._inner,
                               np.asarray(ser_ds._inner.metadata.label),
                               DP_GLOO_ROUNDS, ser._gbdt.config)
        witness["s"] = time.time() - t0
        if not witness["routing_counts_equal"]:
            problems.append("the f64 witness routed other counts than the "
                            "models record")
        if not witness["f64_gap"] <= 2e-5:
            problems.append("gloo and serial gains part by %g in f64"
                            % witness["f64_gap"])
    if texts[0] != texts[1]:
        problems.append("the two gloo ranks wrote different model text")
    if diff is not None:
        problems.append("gloo trees differ from serial: %s" % diff)
    if not (g_auc > 0.7 and abs(g_auc - s_auc) <= 1e-3):
        problems.append("gloo AUC %.6f vs serial %.6f" % (g_auc, s_auc))
    if any(r["captured"] for r in results) or \
            any(r["backend"] != "gloo" for r in results):
        problems.append("a gloo rank captured its step or ran on %s"
                        % [r["backend"] for r in results])
    r0 = results[0]
    b_row = {"ranks": [r["rows"] for r in results],
             "s_per_iter": [r["train_s"] / DP_GLOO_ROUNDS for r in results],
             "host_syncs_per_tree": r0["host_syncs"] / max(r0["trees"], 1),
             "collectives_per_tree": r0["collectives"] / max(r0["trees"], 1),
             "collective_ms": [r["collective_ms"] for r in results],
             "collective_ms_per_tree": r0["collective_ms"]
             * r0["collectives"] / max(r0["trees"], 1),
             "model_text_equal": texts[0] == texts[1],
             "structural_diff_from_serial": diff,
             "max_gain_rel_diff_from_serial": gain_rel,
             "nodes_with_other_threshold": moved, "f64_witness": witness,
             "held_out_auc": g_auc,
             "serial_held_out_auc": s_auc, "wall_s": wall}
    row = {"phase": "dp", "rows": rows, "rounds": rounds,
           "world_1_nccl": a_row, "two_ranks_gloo": b_row}
    return row, problems, launched


if __name__ == "__main__":
    sys.exit(main())
