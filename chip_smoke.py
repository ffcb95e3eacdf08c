#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`cometbft_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--seed N] [--parent-sha PATH]

Phases, each of which raises on failure (so the script exits non-zero
and never prints its last line):

1. the card: `nvidia-smi` name and power limit, torch and CUDA versions;
   no CUDA device is an error;
2. build every kernel from `cometbft_tpu_torch/csrc/` with nvcc (one
   process per source, all at once) and print the build seconds and the
   `ptxas -v` register and spill lines; a spill in the ladder or in
   `accum_weight` (four threads a lane both) is an error;
3. hold each kernel against its plain PyTorch version on the card at
   B = 10,240 (the ladder on a 1,027-lane sub-batch whose first lanes
   carry digit extremes and identity and 8-torsion A and R; `accum_weight`
   at WK = 19,968 bucket lanes on the gather table, weights and round
   count of one real 10,000-signature commit laid out with z from
   `--seed`; then the RLC tail on that commit: `region_sum` on its
   weighted lanes, `window_combine` on the 39 region sums, and the
   ladder at B = 1 with k = 0, A the identity and R = -msm, whose
   verdict must be true): exact agreement after `freeze`, zero
   mismatches allowed, outputs inside the loose limb invariant, and
   launches of 1, 3, 70 and 1,027 lanes equal to the same lanes of the
   full launch (ladder, decompress and `accum_weight`); time kernel and
   plain version with CUDA events, and the kernel alone in the profiler;
   for the one-lane chains, also the latency floor (dependent product
   stages times one product's latency, read off `decompress`'s time);
   then the device-SHA kernels at B = 10,240: `sha512_blocks` on the
   padded R||A||M of that commit's 10,000 vote-shaped lanes (two blocks)
   and 240 edge lanes (preimages of 0, 111, 112, 175 and 239 bytes,
   messages of 0, 111, 112 and 175 bytes behind R||A, one-block lanes, and
   one-block flags over a second block of junk), `reduce512` on those
   digests with the edge values 0, L - 1, L, 2L, 2^512 - 1 and values just
   under multiples of L in the first lanes: exact against the plain
   versions, the digests against `hashlib.sha512` and k against
   `int.from_bytes(digest, "little") % L` on every lane, launches of 1, 3,
   70 and 1,027 lanes equal to the full launch's; then `sha512_reduce`
   (the hash and the reduction in one launch, the routes' challenge) on
   the same 10,240 padded lanes: exact against its plain version and equal
   to `int.from_bytes(hashlib.sha512(m).digest(), "little") % L` on every
   lane, ragged launches of 1, 3, 70 and 1,027 lanes equal to the full
   launch's. With `--parent-sha PATH` (an earlier commit's
   `csrc/sha512_kernels.cu`, e.g. from `git show`), that file is built
   too, its `sha512_blocks` and `reduce512` must give the same outputs,
   and each is timed (events and alone) beside this checkout's kernels;
4. the main path, four routes, each with every launch count set to 0
   just before it and read right after; a kernel of the route that was
   never launched is an error:
   - the ladder route, pinned through the dispatch seam
     (`crypto.ed25519._rlc_beats_ladder` False): two vote-shaped
     10,000-signature commits
     generated on the card (`crypto.testgen`, through the field
     kernels), 16 of them verified through
     `crypto.batch.create_batch_verifier` -> `add_batch` -> `submit`
     with one `collect_pending` (twice: cold and warm pubkey cache),
     then one commit with fixed bad lanes whose bitmap must be exact and
     agree with the pure-Python oracle on a 256-lane sample;
   - the RLC/MSM route, pinned through the dispatch seam
     (`crypto.ed25519._rlc_beats_ladder`): the same 16 commits, cold and
     warm, all of which must verify, then the bad-lane commit, whose
     all-ok scalar must be false and whose blame rerun must give the
     exact bitmap (submitted again while the layout declines it, each
     declined submit's ladder bitmap checked the same way);
     `decompress`, `accum_weight`, `region_sum`, `window_combine` and
     `ladder_sub_mul8` must have launched on every commit the layout
     accepted, and `fe_mul` plus `fe_sq` at most twice a commit (the
     niels forms of A and R);
   - the device-SHA route (`Ed25519BatchVerifier(device_sha=True)`, the
     RLC seam pinned False): the same 16 commits, cold and warm, the
     bad-lane commit, and the bad-lane commit with two lanes whose
     R||A||M exceeds two SHA-512 blocks (a valid and a broken one), which
     go out dead and come back verified on the host; `sha512_reduce`
     exactly once a commit, `sha512_blocks` and `reduce512` never, and
     `decompress` and `ladder_sub_mul8` once or more a commit;
   - the structured-wire (delta) route, pinned through its seam
     (`crypto.ed25519._delta_beats_prehashed` True): the same 16 commits
     and the bad-lane commit; the same kernels, the same counts;
   - the challenge through the ops-level entry points of the hash and the
     reduction (`ops.sha512.sha512_digest`, then `ops.scalar.reduce512`)
     on one commit's packed words: k equal to `sha512_reduce`'s, one
     `sha512_blocks` and one `reduce512` launch.
   The ladder and RLC legs pin the delta seam False. Every commit of the
   phase has more than NATIVE_MAX signatures, so none takes the native
   route. A stage split of one warm commit of each route (host pack,
   H2D, device, D2H, wire bytes a lane) and a profile of its device
   kernels follow; the RLC commit must run fewer than 1,000 device
   kernels;
5. the native host engine (`crypto/native.py`, built with g++ from
   `cometbft_tpu_torch/csrc/host/`): its engine, the host's CPU model and
   core count and the RLC packer's workers; a library that did not build
   is an error. On a 10,000-signature commit, the native `pack_rsk` rows
   must equal the hashlib loop's and the native `prepare` layout the
   numpy packer's (z pinned from `--seed`), each timed beside its Python
   version; the first 150 lanes of the bad-lane commit must take the
   native route with the exact bitmap; the native route and the ladder
   route (through the NATIVE_MAX seam) are timed at 150, 1,024, 4,096
   and 10,000 signatures; the dispatch model is calibrated (link probe,
   the bucket's host packs and device halves on a throwaway batch) and
   its pick at 10,000 is logged beside the faster route of phase 4's
   pipelines, and its delta term's pick (delta or the prehashed ladder)
   beside the measured ladder and delta pipelines;
6. the commit-verify consumers (`types/validation.py`, `light/verifier.py`,
   `crypto/sched.py`) through their entry points, on data made on the
   card by `utils/factories.py` from `--seed` (its fixed-base ladder must
   launch `fe_mul` and `fe_sq`), each leg with the launch counts set to 0
   just before it and read right after:
   - `verify_commit` on a 10,000-validator commit of equal powers, default
     dispatch: the valid commit returns, one with a bit flipped at index
     BAD_INDEX raises ErrInvalidSignature naming it, one with more than a
     third of the power absent raises ErrNotEnoughVotingPower; the route
     (from the path counters) is logged, and `decompress` and
     `ladder_sub_mul8` (or `accum_weight` if the dispatch took RLC) must
     have launched; the bad commit again with the RLC seam pinned
     (resubmitted while the layout declines it), whose blame rerun must
     name the same index;
   - `verify_commit_light` and `verify_commit_light_trusting` (trust 1/3)
     on the same three commits, stopping at their threshold and with
     `verify_all_signatures`: each outcome as `expected_outcome` says
     (a light function that stops before BAD_INDEX accepts the bad
     commit, as the reference does);
   - `verify_commit` on a 150-validator commit: the native route, the same
     three outcomes;
   - `Commit.decode` of the 10,000-signature commit's encoding through the
     native `commit_parse`: it re-encodes to the same bytes, and
     `vote_sign_bytes_blob` equals `vote_sign_bytes` on every index;
   - `light.verifier.verify_stream` over 64 headers signed by one
     150-validator set (9,600 lanes, one batch): it passes, and with one
     signature flipped it names the stream lane;
   - the shared scheduler: two tenants' 5,000-signature verifiers
     coalesce into one dispatch (one `ladder_sub_mul8` launch for the
     valid pair), each tenant's bitmap equal to its own verifier's, a bad
     lane failing only its tenant; then the same through `verify_commit`
     under `verify_context` from two threads;
   - timings: `verify_commit` at 150 and 10,000 (median of ROUTE_REPS,
     warm, the commit's sign-bytes memos dropped before each), and the
     same steps by hand split into sign bytes, adds, submit (with the
     all-ok prefetch) and result; `Commit.decode` at 10,000; and
     `verify_stream`'s headers/s and sigs/s; `results.json` key
     `consumers`;
7. block-sync replay (`blocksync/replay.py`, `state/execution.py`,
   `storage/`, `abci/`) through its entry points, each leg with the
   launch counts set to 0 just before it and read right after:
   `utils/factories.py::make_chain` makes a 256-block chain of 1,000
   validators on the card from `--seed` (nonces from one `RPool`; its
   fixed-base ladders must launch `fe_mul` and `fe_sq`), and
   `ReplayEngine(store, BlockExecutor(AppConns(KVStoreApp())))` replays it
   with fresh apps: batched (window 64, pipeline depth 2) with the default
   dispatch, a warm pass then a timed one, then with the ladder and the
   RLC seams pinned, then full mode (one height at a time, the native
   route). Every pass must apply the 256 blocks to `make_chain`'s final
   state (the same state bytes, app hash, validators hash and last block
   id); each batched pass must verify 259,000 signatures in four windows
   of 64,000 and 65,000 lanes at bucket 65,536, each window launching the
   ladder (the whole batch, or RLC's B = 1 tail) and each RLC window
   `accum_weight`, `region_sum` and `window_combine` (the RLC seam's layout
   declines are counted). Logged: blocks/s and sigs/s of each pass, the
   batched / full ratio, the timed passes' split per block (load and
   decode; window queue: columns, sign-bytes blob, `add_batch`; submit;
   resolve wait; apply), and a profile of one warm window (device
   kernels, busy ms, window ms). Then a 6-block chain whose height-2
   commit has index 777 broken: batched replay must raise
   ErrInvalidSignature naming window lane 1,777 with no block applied, on
   the default dispatch, the ladder seam and the RLC seam (resubmitted
   while the layout declines, its blame rerun naming the lane); full mode
   must raise as `expected_replay_outcome` says (the light check of
   height 2 stops before index 777; block 3's validation names it).
   `results.json` key `replay`;
8. the mempool, evidence and the light client (`mempool/`,
   `evidence/`, `types/evidence.py`, `light/client.py`) through their
   entry points at the reference's MempoolConfig (size 5,000, cache
   10,000, window 256, 2 ms, signatures verified) and SchedConfig
   (16,384 signatures, 2 ms), each leg with the launch counts set to 0
   just before it and read right after; signed STX txs of 1,000 senders
   made on the card (`utils/factories.py::signed_txs`: `fe_mul`,
   `fe_sq`), and every tx's outcome (admitted, or the class and
   message) equal to `expected_ingest_outcome` (held against the
   reference on the CPU):
   - (a) one node, one `AdmissionPipeline` on the shared scheduler: 4,096
     txs with a broken signature, a signed payload the app rejects, an
     envelope cut short, a duplicate, an oversize tx and a second write of
     one key planted, then 1,000 more past the pool's 5,000
     (ErrMempoolFull); the windows' routes and the `mempool.admit_window`
     spans' sizes and stage milliseconds are logged;
   - (b) sixteen tenants (chain ids, apps, mempools, pipelines) on one
     scheduler, a producer thread each, 8,192 txs a tenant in two rounds
     with a reap and update between, one broken signature a tenant that
     must come back to that tenant alone; the leg counts once a coalesced
     dispatch took the ladder or RLC (run again up to 3 times); logged,
     from the trace's `crypto.sched_coalesce` and `crypto.batch_verify`
     spans: the coalesced batch sizes, routes, dispatches per 1,000
     signatures, dispatch time by route; and admitted txs/s per tenant and
     in all (tracing and the tx-lifecycle sampler on);
   - (c) one node at `admission_window` 4,096 (and a 1 s delay, so one
     producer fills it). First the kernels at one admission window's
     shapes, laid out by a pipeline (`admission_window_check`, as phase
     7's window check: 4,096 lanes at bucket 4,096, `accum_weight` at the
     window's S, the window through RLC all-ok with no blame rerun, a
     tampered lane named by the blame). Then 16,384 txs in four full
     windows, each of which must take the ladder or RLC and launch
     `decompress` and the ladder (and RLC's kernels on RLC): the first
     window clean, one dispatch; each later one with one broken signature
     named exactly (on RLC, the blame rerun);
   - (d) 8 blocks of a 150-validator chain from (a)'s mempool (block
     max_bytes 88,000, so that the pool drains over the 8 blocks): reaped
     under the state's consensus parameters, proposed by
     `create_proposal_block` with the `EvidencePool`'s pending evidence,
     committed by `make_commit` on the card and applied by `apply_block`
     with the mempool and the pool attached; a DuplicateVoteEvidence from
     two precommits reported after block 3 is proposed in block 5 alone,
     the app sees the misbehavior, the pool has nothing pending after;
     committed txs left the pool and are refused again, the recheck drops
     the second write of a committed key, the evidence block round-trips
     through `BlockStore`, and the final state bytes equal
     `expected_blocks_state` (the same bytes re-applied on the host, held
     against the reference on the CPU);
   - (e) `LightClient` on phase 7's chain (its stores, not made again)
     behind a `StoreProvider`: `initialize(1)` and a skip to 256 with an
     agreeing witness (heights {1, 256}); then a witness on a 16-block
     fork (`make_chain`, the same seed, three txs a block): verifying to
     12 raises ErrConflictingHeaders, whose LightClientAttackEvidence
     names all 1,000 signers, round-trips, and reaches the witness with
     the primary-direction evidence, as `expected_light_outcome` says;
     each verify's routes are logged;
   `results.json` key `ingest`;
9. in-process consensus (`consensus/`, `privval/`, `types/vote_set.py`,
   `types/proposal.py`) through its entry points, each leg with the launch
   counts set to 0 just before it and read right after:
   - (a) the reference's harness at the calibrated dispatch:
     `InProcessNetwork(4, device="cuda")` with FAST_TIMEOUTS, its threads,
     timers and speculation; 256 kvstore txs into node 0's mempool
     (gossip carries them), run until height 6 is committed: every node
     decided the same block id at every height and has the same app hash
     at the lowest common height, every tx is in a block and readable from
     every node's app, no node stopped; logged: the routes (native at 4
     signatures), the rounds gauge, the mean block interval and the mean
     ms of each step;
   - (b) `lockstep_consensus`: 150 validators (`BASELINE.json`'s Cosmos
     Hub set), one thread, no timers (ManualTickers, `now_ns` from the
     node's height and round, no speculation, a fixed delivery order,
     timeouts fired only when every inbox is empty), 256 kvstore txs of
     100 B a height, heights 1-3, with `E.NATIVE_MAX` at 0 so that every
     last-commit check runs on the device; at (3, 0) the proposer's block
     reaches the others with its last commit's signature 77 flipped (the
     proposal re-signed): every non-proposer must prevote nil, height 3
     must be decided at round 1, the tampered block validated directly
     must raise "invalid last commit: invalid signature at index 77", the
     block hashes, seen commits, app hashes, state bytes and WAL records
     must equal `expected_consensus_outcome` (the same run on the host,
     in a second process once the card's is over, held against the
     reference on the CPU), and `ladder_sub_mul8` must launch once per
     last-commit check and `decompress` once per check plus once per
     signer column; the first full last commit's verifier, kept as the
     path queued it (150 lanes, bucket 256), then goes through
     `batch_window_check`: `decompress` and `ladder_sub_mul8` bit for bit
     against their plain versions on every lane of the bucket, ragged
     launches, and through `submit()` on the ladder every lane true and
     lane 77 broken and named alone; logged: blocks/s, the ms a height split into vote handling,
     proposals, checks, apply, signing, WAL and the rest, and the routes;
   `results.json` key `consensus`;
10. the verify mesh and block sync over p2p (`parallel/mesh.py`,
   `p2p/`, `blocksync/{pool,reactor}.py`), each leg with the launch counts
   set to 0 just before it and read right after:
   - (a) the mesh over every visible GPU when there are several, else over
     2 and over 4 logical shards of the one card (which run one after
     another on its stream: their times say nothing of scaling). All-ok
     and bitmap bit for bit the single device's prehashed ladder on the
     same padded arrays: a 10,000-signature commit at
     `pad_to_shards(10_000, d, 10_240)`, valid and with lanes MESH_BAD
     broken (three shards, the last live lane among them); 13 lanes over 8
     shards, 97 lanes, d - 1 lanes (an all-dead shard) and none, each with
     its last lane broken; the device-SHA form against `verify_batch`; the
     2 x 2 (host, sig) grid against the 1-D mesh. Then the engine
     installed (`parallel.mesh.set_engine`) and the pick forced: `submit()`
     of the broken commit takes path "mesh" with exactly d `decompress`
     and d `ladder_sub_mul8` launches and names the broken lanes; 16
     streamed commits on the ladder go round robin (`mesh_batches_total`
     by device), each all true; replay of phase 7's chain at depth 1 + d
     through the mesh reaches phase 7's final state bytes;
     `dispatch_terms()` calibrated; logged: the terms and a sharded
     10,000-signature verify's ms beside one device's; and
     `graft_entry.dryrun_multichip(d)`;
   - (b) block sync over TCP on 127.0.0.1 between `Switch`es (each with
     its `Transport` and a `SecretConnection` a peer), the syncing
     `BlockSyncReactor` on the card: (b1) phase 7's chain seen up to
     height 65, at the reference's 512,000 B/s each way: the node syncs to
     64, its state bytes equal a host run over the same blocks (native
     checks) and its last app hash block 65's header's; (b2)
     `make_chain(9, n_validators=10_000)` with the rate limits off: 8
     blocks synced, every light check on the card (ladder or RLC, as the
     calibrated dispatch picks), the state bytes the host's, then the same
     checks and applies with no wire beside them (timed, the same state);
     (b3) a liar
     serving (b2)'s chain with signature 4,321 of block 6's last commit
     flipped: synced from it alone the node stops at height 4, counts a
     bad block, bans and disconnects the liar, and its refusal is the
     host's CommitError (class and message); once an honest peer joins, the sync ends at (b2)'s state
     with every stored block the honest one. Logged per leg: blocks/s,
     the median `verify_ms` and `apply_ms` of the `blocksync.block`
     spans, bytes sealed and the sealing and opening ms, routes and
     launches; `results.json` keys `mesh` and `blocksync`;
11. the network reactors and state sync (`consensus/reactor.py`,
   `mempool/reactor.py`, `evidence/reactor.py`, `p2p/{addrbook,pex}.py`,
   `statesync/`), over TCP on 127.0.0.1, each leg with the launch counts
   set to 0 just before it and read right after:
   - (a) 4 validators, each a `ConsensusState` (executor on the card) with
     its own `Transport`, `Switch` and the consensus, mempool, evidence and
     PEX reactors, tests/test_node.py's timeouts; nodes 1-3 know only node
     0's address and PEX meshes them (every node connected to the other
     three, each in its address book); 64 kvstore txs submitted at node 3
     and a prevote of validator 1 for another block than its own, sent to
     node 0's consensus (as tests/test_evidence_reactor.py:45 sends it)
     once node 0 holds validator 1's own prevote, until node 0's evidence
     pool holds the DuplicateVoteEvidence; run until height 6, every tx and
     the evidence are committed: every node's block hash and app hash equal
     at each height, every tx in a block and read back from every app, the
     evidence in one block on every node, no node stopped; then again with
     the NATIVE_MAX seam at 0 to height 3, every last commit on the ladder,
     and the first last commit's verifier through `batch_window_check` at
     its bucket; logged: PEX's time to the mesh, blocks/s, the block
     interval, the routes;
   - (b) a raw peer sends phase 8 (a)'s first 4,096 signed txs (its planted
     classes) to node B in mempool frames of 256; B admits through an
     `AdmissionPipeline` at window 4,096 on the card and gossips what it
     admitted to node C (the same config): every outcome at B equal to
     `expected_ingest_outcome`'s, C's pool equal to B's, no refused tx
     received by C; logged: admitted txs/s at B, window sizes, routes,
     frames and bytes gossiped;
   - (c) state sync: a source serves snapshots (its app the host's replay
     into `KVStoreApp(snapshot_interval=...)`), chunks, light blocks and
     blocks; a fresh node restores through `StateSyncReactor`, `Syncer`,
     `LightStateProvider` and `LightClient(device="cuda")` over
     `P2PLightProvider` (trusting block 1's hash), then block-syncs to the
     tip through `BlockSyncReactor`: (c1) phase 7's chain served to 65
     (snapshots at 40 and 60) with the NATIVE_MAX seam at 0 and the delta
     route off, every check on the ladder, its first light check held
     against the plain versions at bucket 1,024 with one lane broken; (c2) phase 10
     (b2)'s 10,000-validator chain (a snapshot at 5); (c3) (c1) with a liar
     advertising a snapshot at 62 of another state, which must be refused
     with the reference's error before 60 is restored. Each: the restored
     app's height and the verified header's app hash, at the tip the app's
     state bytes and the node's state (but for the heights of the last
     validator and params change, which a restore sets) the source's, a
     light check on the card in (c1) and (c2); logged: seconds by stage
     (discovery, light checks and ms a light block, of which the fetch,
     chunks, block sync),
     routes and launches; `results.json` key `network`;
12. the node through the entry points an operator uses (`cli`, `Node`,
   the RPC), each leg with the launch counts set to 0 just before it and
   read right after:
   - (a) one node from `cli init`'s defaults (cuda, sqlite, admission
     window 256, the shared scheduler) in this process: NODE_TXS kvstore
     txs by HTTP `broadcast_tx_commit`, each read back by `abci_query` and
     by `tx` with its proof against the block's data hash, one websocket
     NewBlock event a height; then a new `Node` on the same home (the
     handshake replays every stored block) commits NODE_RESTART_HEIGHTS
     more; logged: blocks/s, the commit latency's p50 and p99;
   - (b) `cli testnet --v 4`, each node its own `python3 -m
     cometbft_tpu_torch.cli start` process on the card, to height
     NODE_PROC_HEIGHT: every node's `/block` hash and app hash equal at
     every height and its `/status` app hash equal, NODE_PROC_TXS txs by
     `broadcast_tx_sync` at node 3 each found by `tx` on node 0, every
     process exiting 0 on SIGTERM; logged: the first block's time, the
     block interval;
   - (c) a source `cli start` process holding the first NODE_SOURCE_TOP
     heights of phase 10 (b2)'s 10,000-validator chain; a fresh `Node`
     here catches up through `Node.start()`'s block-sync hand-off: its
     state the host's, its `/commit` of the tip with every signature,
     `decompress` and the ladder or `accum_weight` launched; logged:
     boot and catch-up seconds, blocks/s, routes and launches;
   `results.json` key `node`;
13. one JSON line `{"kernels": [...]}` with each kernel's launches,
   mismatches, time, plain time and bound (field products: multiplies at
   100 and squarings at 55 wide integer multiplies; `sha512_blocks`:
   SHA_INT_OPS_PER_BLOCK 32-bit integer instructions a block this run's
   lanes hash; `reduce512`: REDUCE_WIDE_MULS wide multiplies a lane;
   `sha512_reduce`: both, at the same rate);
14. the card's name and power limit, then the last line
   `{"ok": true, "device": {...}}`.

Longer output (the full ptxas report and every number) goes to
`chiprun_out/chip_smoke/`. The script imports torch, numpy and the port,
never JAX and never `cometbft_tpu`.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out" / "chip_smoke"

B = 10_240  # the 10k-validator commit's bucket
LADDER_CHECK_LANES = 1_027  # not a whole number of 16-lane blocks
RAGGED_LANES = (1, 3, 70, LADDER_CHECK_LANES)
COMMIT_SIGS = 10_000
PIPELINE_DEPTH = 16
ORACLE_SAMPLE = 256
NATIVE_SIGS = 150  # a commit the native route takes (NATIVE_MAX is 1,024)
ROUTE_SIGS = (NATIVE_SIGS, 1_024, 4_096, COMMIT_SIGS)  # native against ladder
ROUTE_REPS = 5
# 32-bit integer multiplies per SM per clock on compute capability 9.0
# (CUDA C++ Programming Guide, "Arithmetic Instructions" throughput table)
INT32_MUL_PER_SM_CLK = 64
# wide (32x32->64) multiplies per field product in the kernels' radix
# 2^25.5 (csrc/field25519.cuh): the 10x10 schoolbook of fe_mul, and fe_sq,
# which takes each cross term once
MULS_PER_MUL = 100
MULS_PER_SQ = 55
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# 32-bit integer instructions of one SHA-512 block in csrc/sha512_kernels.cu,
# each 64-bit word as two 32-bit halves: a round's Sigma0 and Sigma1 (3
# rotations of 2 funnel shifts, then one 3-input XOR a half: 8 each), Ch
# and Maj (one 3-input logic op a half: 2 each), t1 (five 64-bit terms: 2
# three-input adds a half: 4), t2, e and a (2 each): 30; the schedule of
# rounds 16-79 (sigma0 and sigma1, 8 each, and a four-term add, 4): 20.
# 80 rounds and the 8 additions to the state (16): 30 x 80 + 20 x 64 + 16.
# Each at 64 a clock an SM (CUDA C++ Programming Guide, cc 9.0: 32-bit
# integer add, bitwise and shift).
SHA_INT_OPS_PER_BLOCK = 30 * 80 + 20 * 64 + 16
INT32_OPS_PER_SM_CLK = 64
# wide (32x32->64) multiplies of reduce512 a lane: the 9 x 9 words of
# q1 * mu and the 44 of q3 * L mod b^9
REDUCE_WIDE_MULS = 9 * 9 + sum(min(8, 9 - i) for i in range(9))

SOURCES = {
    "fe_mul": ("cometbft_tpu_torch/csrc/field_kernels.cu", "cometbft_tpu/ops/field.py:229"),
    "fe_sq": ("cometbft_tpu_torch/csrc/field_kernels.cu", "cometbft_tpu/ops/field.py:233"),
    "decompress": ("cometbft_tpu_torch/csrc/curve_kernels.cu", "cometbft_tpu/ops/curve.py:172"),
    "ladder_sub_mul8": ("cometbft_tpu_torch/csrc/curve_kernels.cu",
                        "cometbft_tpu/ops/curve.py:379"),
    "accum_weight": ("cometbft_tpu_torch/csrc/msm_kernels.cu", "cometbft_tpu/ops/msm.py:68"),
    "region_sum": ("cometbft_tpu_torch/csrc/msm_kernels.cu",
                   "cometbft_tpu/ops/field.py:229, launched from cometbft_tpu/ops/msm.py:206"),
    "window_combine": ("cometbft_tpu_torch/csrc/msm_kernels.cu",
                       "cometbft_tpu/ops/field.py:229 and :233, launched from "
                       "cometbft_tpu/ops/msm.py:322"),
    "sha512_blocks": ("cometbft_tpu_torch/csrc/sha512_kernels.cu",
                      "cometbft_tpu/ops/sha512.py:131 (plain XLA)"),
    "reduce512": ("cometbft_tpu_torch/csrc/sha512_kernels.cu",
                  "cometbft_tpu/ops/scalar.py:131 (plain XLA)"),
    "sha512_reduce": ("cometbft_tpu_torch/csrc/sha512_kernels.cu",
                      "cometbft_tpu/ops/sha512.py:131 and cometbft_tpu/ops/scalar.py:131 "
                      "(plain XLA), fused"),
}
# the kernels the device-SHA and delta routes launch, and the standalone
# challenge kernels they must not launch
SHA_KERNELS = ("sha512_reduce", "decompress", "ladder_sub_mul8")
SHA_STANDALONE = ("sha512_blocks", "reduce512")
# Dependent field-product stages of the one-lane chains: a region's tree is
# 9 additions of 3 products in a row (a, b, then c = (T1 2d) T2, then the
# four outputs); with four threads a lane, a doubling and an addition are
# 2 stages each (csrc/edwards25519.cuh), and the ladder at B = 1 runs its
# lane table (1 + 7 x 3), 64 windows of 12, the addition of -R (2) and
# three doublings.
REGION_SUM_STAGES = 9 * 3
LADDER_STAGES = 1 + 7 * 3 + 64 * 12 + 2 + 3 * 2
RLC_MAX_DEVICE_KERNELS = 1_000


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi(query: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn() on the current stream (CUDA
    events around `reps` calls, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, kernel: str, reps: int, attempts: int = 3) -> float:
    """Mean device time of one launch of `kernel` alone, from a profiler
    trace of `reps` calls of fn() (the host's launch path excluded): the
    mean over the launches the trace holds. The profiler loses launches
    now and then (H100 runs saw 151 of 200 `fe_sq` launches, 12 of 20
    `accum_weight`, three traces in a row of 199 of 200 `region_sum`, and
    42, 47 and 48 of 50 of the ladder at B = 1); a trace that holds fewer
    than nine in ten of the launches is taken again, up to `attempts`
    times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and f"{kernel}_kernel" in e.name]
        if len(ev) != reps:
            log(f"profiler trace {attempt + 1} of {kernel}: {len(ev)} of {reps} launches seen")
        if 10 * len(ev) >= 9 * reps:
            return sum(e.device_time_total for e in ev) / len(ev) / 1e3
    raise AssertionError(f"profiler saw {len(ev)} launches of {kernel}, expected {reps}")


def profile_commit(fn, out_name: str, kernels=SOURCES):
    """The device kernels of one warm call of fn(), from a profiler trace of
    two calls whose first is the profiler's warm-up step: a trace of one
    call dropped the kernels at the start of its window (on an H100, the
    device-SHA commit's first two, `sha512_blocks` and `reduce512`).
    Writes the kernel table to OUT_DIR / out_name; returns (device
    kernels, busy ms, launches of each of `kernels`, table)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()  # the active step: its events stay in prof when the trace ends
        fn()
        torch.cuda.synchronize()
    # the step's own span on the device timeline is an annotation, not a kernel
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not e.name.startswith("ProfilerStep")]
    by_kernel = {name: sum(1 for e in dev_events if f"{name}_kernel" in e.name)
                 for name in kernels}
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=12)
    (OUT_DIR / out_name).write_text(table)
    return len(dev_events), sum(e.device_time_total for e in dev_events) / 1e3, by_kernel, table


def loose_limbs(rng, n: int):
    """(22, n) int32 limbs spread over the loose invariant, with lanes at
    its edges: all zero, every limb at its maximum, p itself, and limb 0
    at its maximum over canonical high limbs."""
    from cometbft_tpu_torch.ops import field as F

    a = np.empty((F.NLIMBS, n), np.int32)
    a[0] = rng.integers(0, 13824, n)
    a[1:] = rng.integers(0, 4300, (F.NLIMBS - 1, n))
    a[:, 0:8] = 0
    a[0, 8:16] = 13823
    a[1:, 8:16] = 4299
    a[:, 16:24] = F.P_LIMBS[:, None]
    a[0, 24:32] = 13823
    a[1:, 24:32] = 4095
    return a


def frozen_diff(F, got, want) -> tuple[int, int]:
    """(lanes that differ, max |difference| of a limb) after freeze, for
    (22, B) elements or (k, 22, B) stacks of them."""
    got = got.reshape(-1, F.NLIMBS, got.shape[-1])
    want = want.reshape(-1, F.NLIMBS, want.shape[-1])
    d = torch.stack([(F.freeze(g).long() - F.freeze(w).long()).abs() for g, w in zip(got, want)])
    d = d.amax(dim=(0, 1))
    return int((d > 0).sum()), int(d.max())


def check_loose(name: str, t) -> None:
    """Kernel outputs must satisfy the loose invariant the plain field
    code assumes: limb 0 in [0, 13824), limbs 1.. in [0, 4300)."""
    t = t.reshape(-1, 22, t.shape[-1])
    ok = (t.min() >= 0) and (t[:, 0].max() < 13824) and (t[:, 1:].max() < 4300)
    if not bool(ok):
        raise AssertionError(f"{name}: output outside the loose limb invariant")


def torsion_point(ref):
    """A nontrivial 8-torsion point: [L]P for some P outside the prime-order
    subgroup."""
    for y in range(2, 50):
        aff = ref._decode_point(y.to_bytes(32, "little"), zip215=True)
        if aff is None:
            continue
        t = ref._ext_scalar_mul(ref.L, ref._to_ext(aff))
        if not ref._ext_is_identity(t):
            return t
    raise AssertionError("no torsion point found")


def torsion_signed(ref, a: int, r: int, msg: bytes, shift_a: bool, t8):
    """(pub, sig) valid only under the cofactored (ZIP-215) equation: A or R
    carries an 8-torsion component."""
    A = ref._ext_scalar_mul(a, ref.B_POINT)
    R = ref._ext_scalar_mul(r, ref.B_POINT)
    if shift_a:
        A = ref._ext_add(A, t8)
    else:
        R = ref._ext_add(R, t8)
    a_enc = ref._encode_point(*ref._ext_to_affine(A))
    r_enc = ref._encode_point(*ref._ext_to_affine(R))
    k = int.from_bytes(hashlib.sha512(r_enc + a_enc + msg).digest(), "little") % ref.L
    return a_enc, r_enc + ((r + k * a) % ref.L).to_bytes(32, "little")


def to_columns(items):
    """List of (pub, msg, sig) -> the add_batch columns."""
    pubs = np.frombuffer(b"".join(p for p, _, _ in items), np.uint8).reshape(-1, 32)
    sigs = np.frombuffer(b"".join(s for _, _, s in items), np.uint8).reshape(-1, 64)
    lens = np.array([len(m) for _, m, _ in items], np.int64)
    return pubs.copy(), sigs.copy(), b"".join(m for _, m, _ in items), lens


def submit_commit(cols, device, device_sha=False):
    """One commit through the consumer entry point (`create_batch_verifier`),
    or through `Ed25519BatchVerifier(device_sha=True)`."""
    from cometbft_tpu_torch.crypto.batch import create_batch_verifier
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519BatchVerifier, Ed25519PubKey

    pubs, sigs, blob, lens = cols
    if device_sha:
        bv = Ed25519BatchVerifier(device=device, device_sha=True)
    else:
        bv = create_batch_verifier(Ed25519PubKey(pubs[0].tobytes()), device=device)
    bv.add_batch(pubs, sigs, blob, lens)
    return bv.submit()


def submit_through_rlc(cols, device, on_decline, tries: int = 5):
    """Submit a commit with the RLC route pinned until its layout accepts
    it. The layout draws z afresh on each submit and declines about one
    10,000-signature commit in sixteen (PERF.md, section 6); the ladder
    then verifies it, and `on_decline` gets that pending result. Returns
    the RLC pending result and the number of submits it took."""
    from cometbft_tpu_torch.crypto.ed25519 import PendingRLC

    for submits in range(1, tries + 1):
        pending = submit_commit(cols, device)
        if isinstance(pending, PendingRLC):
            return pending, submits
        on_decline(pending)
    raise AssertionError(f"the RLC layout declined the commit {tries} times in a row")


def sha_phase(dev, seed, items, record, kern, mul_rate, int_rate, parent_sha=None) -> None:
    """Phase 3's device-SHA kernels at B = 10,240: `sha512_blocks` on the
    padded R||A||M of the commit's lanes and 240 edge lanes, `reduce512` on
    those digests with edge values in the first lanes, `sha512_reduce` on
    the padded lanes; each exact against its plain version, the digests
    against hashlib and k against Python integers on every lane, ragged
    launches equal to the full launch's. `parent_sha`: an earlier
    `sha512_kernels.cu`, built and timed beside these (`parent_kernels`)."""
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.ops import kernels as K
    from cometbft_tpu_torch.ops import scalar as SC
    from cometbft_tpu_torch.ops import sha512 as H

    rng = np.random.default_rng(seed + 7)
    pre = [sig[:32] + pub + msg for pub, msg, sig in items]
    head = pre[0][:64]  # a real R||A
    edge = [rng.bytes(n) for n in (0, 111, 112, 175, 239)]
    edge += [head + rng.bytes(n) for n in (0, 111, 112, 175)]
    edge += [head + rng.bytes(40) for _ in range(B - len(pre) - len(edge))]  # one block
    pre += edge
    words_np, two_np = H.pad_messages(pre)
    words_np[B - 8 :, 32:] = rng.integers(0, 2**32, (8, 32), dtype=np.uint32)  # junk block 2
    if two_np[B - 8 :].any() or not two_np[: len(items)].all():
        raise AssertionError("the SHA check's lanes are not laid out as intended")
    words = torch.from_numpy(words_np.view(np.int32)).to(dev)
    two = torch.from_numpy(two_np).to(dev)
    digest = K.sha512_blocks(words, two)
    want = H.sha512_digest_plain(words, two)
    mism = int((digest != want).any(dim=1).sum())
    err = int((digest.int() - want.int()).abs().max())
    host = digest.cpu().numpy()
    wrong = [i for i, m in enumerate(pre) if host[i].tobytes() != hashlib.sha512(m).digest()]
    if wrong:
        raise AssertionError(f"sha512_blocks: {len(wrong)} digests differ from hashlib, "
                             f"lanes {wrong[:10]}")
    for n in RAGGED_LANES:
        if not torch.equal(K.sha512_blocks(words[:n].contiguous(), two[:n].contiguous()),
                           digest[:n]):
            raise AssertionError(f"sha512_blocks: lanes differ between B={n} and B={B} launches")
    blocks = B + int(two_np.sum())
    log(f"sha512_blocks: {len(items)} vote-shaped R||A||M and {len(edge)} edge lanes, "
        f"{int(two_np.sum())} of two blocks, every digest equal to hashlib's; ragged launches "
        f"{RAGGED_LANES} equal to the B={B} launch")
    record("sha512_blocks", mism, err, lambda: K.sha512_blocks(words, two),
           lambda: H.sha512_digest_plain(words, two), 50, B, (256 + 1 + 64) * B,
           ops_s=blocks * SHA_INT_OPS_PER_BLOCK / int_rate)
    kern["sha512_blocks"].update(blocks_hashed=blocks, int_ops_per_block=SHA_INT_OPS_PER_BLOCK)

    L, top = ref.L, (1 << 512) - 1
    edges = [0, 1, L - 1, L, L + 1, 2 * L - 1, 2 * L, 3 * L - 1, top, top - 1, top // L * L,
             top // L * L - 1, (1 << 252) - 1, (1 << 256) - 1]
    edges += [q * L - d for q in (2**200, 2**259 + 3, top // L) for d in (1, 2)]
    red_in = digest.clone()
    red_in[: len(edges)] = torch.from_numpy(np.stack(
        [np.frombuffer(v.to_bytes(64, "little"), np.uint8) for v in edges])).to(dev)
    k = K.reduce512(red_in)
    want = SC.reduce512_plain(red_in)
    mism = int((k != want).any(dim=0).sum())
    err = int((k - want).abs().max())
    k_host, in_host = k.cpu().numpy().astype(object), red_in.cpu().numpy()
    got = (k_host * np.array([1 << (12 * j) for j in range(22)], dtype=object)[:, None]).sum(0)
    wrong = [i for i in range(B)
             if got[i] != int.from_bytes(in_host[i].tobytes(), "little") % L]
    if wrong:
        raise AssertionError(f"reduce512: {len(wrong)} lanes differ from Python's mod L, "
                             f"lanes {wrong[:10]}")
    for n in RAGGED_LANES:
        if not torch.equal(K.reduce512(red_in[:n].contiguous()), k[:, :n]):
            raise AssertionError(f"reduce512: lanes differ between B={n} and B={B} launches")
    log(f"reduce512: {len(edges)} edge values (0, L - 1, L, 2L, 2^512 - 1, just under multiples "
        f"of L) and {B - len(edges)} digests, every k equal to int.from_bytes(d, 'little') % L; "
        f"ragged launches {RAGGED_LANES} equal to the B={B} launch")
    record("reduce512", mism, err, lambda: K.reduce512(red_in), lambda: SC.reduce512_plain(red_in),
           100, B, (64 + 88) * B, ops_s=REDUCE_WIDE_MULS * B / mul_rate)
    kern["reduce512"]["wide_muls_per_lane"] = REDUCE_WIDE_MULS

    # the fused challenge: k = SHA-512(R||A||M) mod L in one launch
    red_out = k
    k = K.sha512_reduce(words, two)
    want = SC.sha512_reduce_plain(words, two)
    mism = int((k != want).any(dim=0).sum())
    err = int((k - want).abs().max())
    k_host = k.cpu().numpy().astype(object)
    got = (k_host * np.array([1 << (12 * j) for j in range(22)], dtype=object)[:, None]).sum(0)
    wrong = [i for i, m in enumerate(pre)
             if got[i] != int.from_bytes(hashlib.sha512(m).digest(), "little") % L]
    if wrong:
        raise AssertionError(f"sha512_reduce: {len(wrong)} lanes differ from hashlib's digest "
                             f"mod L, lanes {wrong[:10]}")
    for n in RAGGED_LANES:
        if not torch.equal(K.sha512_reduce(words[:n].contiguous(), two[:n].contiguous()),
                           k[:, :n]):
            raise AssertionError(f"sha512_reduce: lanes differ between B={n} and B={B} launches")
    log(f"sha512_reduce: the same {B} lanes, every k equal to int.from_bytes(hashlib.sha512(m)"
        f".digest(), 'little') % L; ragged launches {RAGGED_LANES} equal to the B={B} launch")
    record("sha512_reduce", mism, err, lambda: K.sha512_reduce(words, two),
           lambda: SC.sha512_reduce_plain(words, two), 50, B, (256 + 1 + 88) * B,
           ops_s=(blocks * SHA_INT_OPS_PER_BLOCK + B * REDUCE_WIDE_MULS) / int_rate)
    kern["sha512_reduce"].update(blocks_hashed=blocks, int_ops_per_block=SHA_INT_OPS_PER_BLOCK,
                                 wide_muls_per_lane=REDUCE_WIDE_MULS)
    if parent_sha is not None:
        parent_kernels(parent_sha, words, two, digest, red_in, red_out, kern)
    else:
        log("no --parent-sha: an earlier commit's challenge kernels not timed")


def parent_kernels(path, words, two, digest, red_in, limbs, kern) -> None:
    """Build `path` (an earlier `sha512_kernels.cu`, same launch signatures)
    into build/, check its `sha512_blocks` and `reduce512` give this
    checkout's outputs, and time each (events and alone) beside them:
    kern[name]["parent"]. Events time both builds through their bare ctypes
    launchers (`this_ms`), without the package wrapper's checks."""
    import ctypes

    from cometbft_tpu_torch.ops import kernels as K

    text = Path(path).read_bytes()
    out_dir = K.BUILD_ROOT / "parent" / hashlib.sha256(text).hexdigest()[:16]
    K.compile_sources({"sha512_parent": Path(path).resolve()}, out_dir)
    lib = ctypes.CDLL(str(out_dir / "sha512_parent.so"))
    log_text = (out_dir / "sha512_parent.ptxas.txt").read_text()
    stream = torch.cuda.current_stream().cuda_stream
    batch = words.shape[0]
    for name, args, want in (("sha512_blocks", (words, two), digest),
                             ("reduce512", (red_in,), limbs)):
        bare = {}
        for who, f in (("parent", getattr(lib, f"{name}_launch")),
                       ("this", K._fn("sha512_kernels", f"{name}_launch"))):
            f.argtypes = K._SIGNATURES["sha512_kernels"][f"{name}_launch"]
            f.restype = ctypes.c_int
            out = torch.empty_like(want)

            def go(f=f, args=args, out=out, who=who):
                rc = f(*(a.data_ptr() for a in args), out.data_ptr(), batch, stream)
                if rc != 0:
                    raise RuntimeError(f"{who} {name} launch failed: cudaError {rc}")

            go()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"the {who} build's {name} disagrees with the wrapper's")
            bare[who] = go
        reps = 50 if name == "sha512_blocks" else 100
        kern[name]["parent"] = {"source": str(path), "ms": cuda_ms(bare["parent"], reps),
                                "this_ms": cuda_ms(bare["this"], reps),
                                "device_only_ms": kernel_device_ms(bare["parent"], name, reps),
                                **K.ptxas_usage(log_text, f"{name}_kernel")}
        par = kern[name]["parent"]
        log(f"parent {name} ({path}): bare launches {par['ms']:.4f} ms against this checkout's "
            f"{par['this_ms']:.4f} by events; device alone {par['device_only_ms']:.4f} against "
            f"{kern[name]['device_only_ms']:.4f} ms; same outputs")


def check_challenge_launches(route: str, counts: dict, commits: int) -> None:
    """The device-SHA and delta routes take each commit's challenge through
    one `sha512_reduce` launch and never launch the standalone kernels."""
    if counts["sha512_reduce"] != commits or any(counts[n] for n in SHA_STANDALONE):
        raise AssertionError(f"{route}: {commits} commits, so {commits} sha512_reduce launches "
                             f"and no {' or '.join(SHA_STANDALONE)}: {counts}")


def ops_challenge_leg(dev, cols) -> dict:
    """Phase 4 (e): one commit's challenge through the ops-level entry
    points of the hash and the reduction (`ops.sha512.sha512_digest`, the
    reference's `sha512_two_blocks` boundary in hashlib byte order, then
    `ops.scalar.reduce512`), on the device-SHA route's packed words; k must
    equal `sha512_reduce`'s, from one `sha512_blocks` and one `reduce512`
    launch. Returns the launch counts of the leg."""
    from cometbft_tpu_torch.crypto import ed25519 as E
    from cometbft_tpu_torch.ops import kernels as K
    from cometbft_tpu_torch.ops import scalar as SC
    from cometbft_tpu_torch.ops import sha512 as H

    bv = E.Ed25519BatchVerifier(dev, device_sha=True)
    bv.add_batch(*cols)
    n = bv.count()
    buf, fields, _ = bv._pack_device_sha(n, E._bucket(n))
    t = E.unpack_fields(buf.to(dev), fields)
    want = SC.sha512_reduce(t["words"], t["two"])
    K.reset_launches()
    k = SC.reduce512(H.sha512_digest(t["words"], t["two"]))
    counts = dict(K.launches)
    log(f"ops-level challenge launches: {counts}")
    if not torch.equal(k, want):
        raise AssertionError("reduce512(sha512_digest(...)) differs from sha512_reduce")
    if counts["sha512_blocks"] != 1 or counts["reduce512"] != 1 or counts["sha512_reduce"]:
        raise AssertionError(f"ops-level challenge: one launch each of {SHA_STANDALONE} "
                             f"expected, got {counts}")
    return counts


def ptxas_per_kernel(K, report: dict) -> dict:
    """Registers and spill-store bytes of each kernel, from `ptxas -v`."""
    out = {n: u for txt in report.values() for n in SOURCES
           if (u := K.ptxas_usage(txt, f"{n}_kernel"))}
    missing = [n for n in SOURCES if set(out.get(n, {})) != {"spill_bytes", "registers"}]
    if missing:
        raise AssertionError(f"ptxas report lacks registers or spills of {missing}")
    return out


def products_per_lane(s_rounds: int):
    """Field products per lane of each kernel, (multiplies, squarings),
    counted by running its plain version on one CPU lane through counting
    routes (each call counts its lanes); `accum_weight` at `s_rounds`
    rounds; `region_sum` per region and `window_combine` per run, whose
    one lane is the MSM's total."""
    from cometbft_tpu_torch.ops import curve as C
    from cometbft_tpu_torch.ops import field as F
    from cometbft_tpu_torch.ops import msm as M

    count = [0, 0]

    def mul(a, b):
        count[0] += max(a.shape[-1], b.shape[-1])
        return F.mul_plain(a, b)

    def sq(a):
        count[1] += a.shape[-1]
        return F.sq_plain(a)

    ops = C.PointOps(mul, sq)
    y = torch.from_numpy(F.from_int(9, 1))
    ops.decompress_value(y, torch.zeros(1, dtype=torch.int32))
    n_dec = tuple(count)
    count[:] = [0, 0]
    pt = C.identity(1, "cpu")
    digits = torch.zeros((64, 1), dtype=torch.int32)
    ops.ladder_sub_mul8_value(digits, digits, pt, pt)
    n_ladder = tuple(count)
    count[:] = [0, 0]
    niels = M._identity_niels(1, "cpu")
    idx = torch.zeros((s_rounds, 1), dtype=torch.int32)
    acc = M._accumulate(niels, idx, idx != 0, ops=ops)
    M._weight_step(ops, acc, torch.zeros(1, dtype=torch.int32))
    n_accum = tuple(count)
    count[:] = [0, 0]
    M.region_tree_sum_plain(torch.stack(C.identity(M.K_BUCKETS, "cpu")), ops=ops)
    n_region = tuple(count)
    count[:] = [0, 0]
    M.window_combine_plain(torch.stack(C.identity(M.N_REGIONS, "cpu")), ops=ops)
    return {"fe_mul": (1, 0), "fe_sq": (0, 1), "decompress": n_dec, "ladder_sub_mul8": n_ladder,
            "accum_weight": n_accum, "region_sum": n_region, "window_combine": tuple(count)}


def wide_muls(products) -> int:
    """32x32->64-bit multiplies of (multiplies, squarings) field products."""
    return MULS_PER_MUL * products[0] + MULS_PER_SQ * products[1]


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo", encoding="utf-8", errors="replace") as f:
            for ln in f:
                if ln.startswith("model name"):
                    return ln.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def median_ms(fn, reps: int) -> float:
    """Median wall milliseconds of one fn() call over `reps` calls, after
    one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def same_layout(a, b) -> bool:
    if a is None or b is None:
        return a is b
    return a["s_rounds"] == b["s_rounds"] and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        for k in ("stream", "stream_neg", "counts", "weights", "c_digits"))


def host_engine_phase(dev, card, seed, commit, bad_items, expect, pipeline_sigs_per_s) -> dict:
    """Phase 5: the native host engine against the Python packers on one
    10,000-signature commit, the native route on a 150-signature commit,
    native against ladder by commit size, and the calibrated dispatch."""
    from cometbft_tpu_torch.crypto import ed25519 as E
    from cometbft_tpu_torch.crypto import native, rlc

    tune = [ln.split()[1].strip("_")[len("tune_"):] for ln in native._native_target().splitlines()
            if ln.startswith("#define __tune_")]
    out = {"engine": native.engine(), "cpu": cpu_model(), "march_native_tune": tune,
           "nproc": os.cpu_count(), "rlc_packer_threads": native.rlc_packer_threads()}
    log(f"native host engine: {out['engine']}; rlc_packer_threads {out['rlc_packer_threads']}; "
        f"host CPU {out['cpu']} (g++ -march=native tunes for {tune}), nproc {out['nproc']}")
    if not native.available():
        raise AssertionError(f"the native host library did not build: {native.build_log}")
    used = {"pack_rsk": 0, "rlc_pack": 0, "batch_verify": 0}
    real = {name: getattr(native, name) for name in (*used, "rlc_available")}

    def counted(name):
        def call(*args, **kwargs):
            used[name] += 1
            return real[name](*args, **kwargs)
        return call

    for name in used:
        setattr(native, name, counted(name))
    try:
        n, b = len(commit), E._bucket(len(commit))
        bv = E.Ed25519BatchVerifier(dev)
        bv.add_batch(*to_columns(commit))

        # the ladder's rows: native against the hashlib loop
        rsk_native = bv._pack_rsk(n, b).numpy().copy()
        pack_native_ms = median_ms(lambda: bv._pack_rsk(n, b), ROUTE_REPS)
        native.pack_rsk = lambda *args: False  # the Python path
        rsk_python = bv._pack_rsk(n, b).numpy().copy()
        pack_python_ms = median_ms(lambda: bv._pack_rsk(n, b), ROUTE_REPS)
        native.pack_rsk = counted("pack_rsk")
        if not np.array_equal(rsk_native, rsk_python):
            raise AssertionError("native pack_rsk rows differ from the hashlib loop's")
        if not used["pack_rsk"]:
            raise AssertionError("the ladder's pack did not use the native library")

        # the RLC layout: native against numpy, z pinned from --seed
        skip = np.zeros(n, bool)
        blobs = (bv._pub_buf, bv._sig_buf, bv._msg_buf, np.asarray(bv._msg_lens, np.uint64))
        for attempt in range(5):  # a pinned z that the layout declines tells little
            z16 = np.random.default_rng(seed + 1 + attempt).integers(0, 256, (n, 16),
                                                                     dtype=np.uint8)
            prep = rlc.prepare(None, skip, b, z16, blobs=blobs)
            if not same_layout(prep, rlc.prepare_numpy(commit, skip, b, z16)):
                raise AssertionError("native prepare differs from prepare_numpy")
            if prep is not None:
                break
        else:
            raise AssertionError("the RLC layout declined the commit under 5 pinned z")
        if not used["rlc_pack"]:
            raise AssertionError("prepare did not use the native packer")
        prepare_native_ms = median_ms(lambda: bv._pack_rlc(z16), ROUTE_REPS)
        native.rlc_available = lambda: False  # the numpy path
        prepare_python_ms = median_ms(lambda: bv._pack_rlc(z16), 2)
        native.rlc_available = real["rlc_available"]
        out.update(host_pack_hash_ms={"native": pack_native_ms, "python": pack_python_ms},
                   host_prepare_ms={"native": prepare_native_ms, "python": prepare_python_ms},
                   layout_submits=attempt + 1)
        log(f"host pack, one {n}-signature commit (median of {ROUTE_REPS}): host_pack_hash_ms "
            f"native {pack_native_ms:.3f}, python {pack_python_ms:.3f}; host_prepare_ms native "
            f"{prepare_native_ms:.3f}, python {prepare_python_ms:.3f} (median of 2); rows and "
            f"layout byte-identical [{card}; {out['cpu']}, nproc {out['nproc']}]")

        # a commit of NATIVE_SIGS signatures, with the bad lanes: the native route
        small = E.Ed25519BatchVerifier(dev)
        small.add_batch(*to_columns(bad_items[:NATIVE_SIGS]))
        pending = small.submit()
        if not isinstance(pending, E.DonePending) or pending._path != "native":
            raise AssertionError(f"the {NATIVE_SIGS}-signature commit did not take the native "
                                 "route")
        ok, bits = pending.result()
        if ok or bits != expect[:NATIVE_SIGS]:
            wrong = [i for i, (g, w) in enumerate(zip(bits, expect)) if g != w]
            raise AssertionError(f"native route: bitmap wrong at lanes {wrong[:20]}")
        if not used["batch_verify"]:
            raise AssertionError("the native route did not use the native library")
        log(f"native route, {NATIVE_SIGS}-signature bad-lane commit: bitmap exact (lanes 0-2 "
            "rejected, torsion lanes 3-4 accepted)")

        # the native route against the ladder, by commit size (one commit,
        # submit to result, the ladder's pubkeys cached)
        routes = {}
        saved = E.NATIVE_MAX, E._rlc_beats_ladder, E._delta_beats_prehashed
        E._rlc_beats_ladder = lambda n, b, device: False
        E._delta_beats_prehashed = lambda n, b, device: False
        try:
            for m in ROUTE_SIGS:
                cols_m = to_columns(commit[:m])

                def run(path):
                    pending = submit_commit(cols_m, dev)
                    if pending._path != path or not pending.result()[0]:
                        raise AssertionError(f"{m} signatures: route {pending._path}, not {path},"
                                             " or a valid commit failed")

                E.NATIVE_MAX = m + 1
                native_ms = median_ms(lambda: run("native"), ROUTE_REPS)
                E.NATIVE_MAX = 0
                ladder_ms = median_ms(lambda: run("ladder"), ROUTE_REPS)
                routes[m] = {"native_ms": native_ms, "ladder_ms": ladder_ms}
                log(f"{m} signatures, one commit (median of {ROUTE_REPS}): native {native_ms:.3f} "
                    f"ms, ladder {ladder_ms:.3f} ms [{card}; {out['engine']}]")
        finally:
            E.NATIVE_MAX, E._rlc_beats_ladder, E._delta_beats_prehashed = saved
        out["route_ms"] = routes
    finally:
        for name, fn in real.items():
            setattr(native, name, fn)

    # the dispatch model, calibrated here (link, and the bucket's host
    # packs and device halves), and its pick at 10,000
    t0 = time.perf_counter()
    model = E.dispatch_model(COMMIT_SIGS, B, dev)
    calibration_s = time.perf_counter() - t0
    pick = "rlc" if E._rlc_beats_ladder(COMMIT_SIGS, B, dev) else "ladder"
    if pick != ("rlc" if model["t_rlc"] < model["t_ladder"] else "ladder"):
        raise AssertionError("_rlc_beats_ladder disagrees with dispatch_model")
    faster = max(("ladder", "rlc"), key=pipeline_sigs_per_s.get)
    measured_ms = {r: 1e3 * COMMIT_SIGS / v for r, v in pipeline_sigs_per_s.items()}
    delta_pick = "delta" if E._delta_beats_prehashed(COMMIT_SIGS, B, dev) else "ladder"
    if delta_pick != ("delta" if model["t_delta"] < model["t_ladder"] else "ladder"):
        raise AssertionError("_delta_beats_prehashed disagrees with dispatch_model")
    delta_faster = max(("ladder", "delta"), key=pipeline_sigs_per_s.get)
    out["dispatch"] = {"model": model, "calibration_s": calibration_s, "pick": pick,
                       "faster_measured": faster, "pick_matches_measured": pick == faster,
                       "delta_pick": delta_pick, "delta_faster_measured": delta_faster,
                       "delta_pick_matches_measured": delta_pick == delta_faster,
                       "pipeline_ms_per_commit": measured_ms}
    log(f"dispatch model at {COMMIT_SIGS} signatures, bucket {B} (calibrated in "
        f"{calibration_s:.3f} s): link {model['link_mbps']:.0f} MB/s; terms {model['terms']}")
    for route in ("ladder", "rlc", "delta"):
        st = model[route]
        log(f"  {route}: host {st['host'] * 1e3:.3f} ms, wire {st['wire'] * 1e3:.3f} ms, device "
            f"{st['device'] * 1e3:.3f} ms -> modeled {model['t_' + route] * 1e3:.3f} ms a commit; "
            f"measured {measured_ms[route]:.3f} ms a commit in phase 4's pipeline")
    log(f"dispatch pick at {COMMIT_SIGS}: {pick}; faster in phase 4's pipelines: {faster} "
        f"({'matches' if pick == faster else 'does not match'}) [{card}]")
    log(f"delta term's pick at {COMMIT_SIGS} (delta against the prehashed ladder): {delta_pick}; "
        f"faster in phase 4's pipelines: {delta_faster} "
        f"({'matches' if delta_pick == delta_faster else 'does not match'}; ladder "
        f"{measured_ms['ladder']:.3f}, delta {measured_ms['delta']:.3f} ms a commit) [{card}]")
    return out


# ---- phase 6: the commit-verify consumers

CONSUMER_CHAIN = "smoke-chain"
CONSUMER_HEIGHT = 12
CONSUMER_POWER = 10
BAD_INDEX = 7_777  # the flipped signature of the 10,000-validator commit
SMALL_BAD_INDEX = 77  # and of the 150-validator commit
STREAM_HEADERS = 64  # headers of the light-client stream, each signed by NATIVE_SIGS
STREAM_BAD = (39, 17)  # (stream header, commit slot) of the stream's flipped signature
TENANT_SIGS = 5_000  # each of the scheduler leg's two tenants
TENANT_BAD_LANE = 4_321
TRUST_PERIOD_S = 14 * 24 * 3600
CONSUMER_FUNCS = ("verify_commit", "verify_commit_light", "verify_commit_light_trusting")


def expected_outcome(fn: str, n: int, power: int, bad=None, absent: int = 0,
                     trust=(1, 3), all_sigs: bool = False):
    """What `fn` (a `types.validation` function) gives on an n-validator
    commit of equal powers whose first `absent` slots are absent, every
    other slot a COMMIT vote, and the signature at commit index `bad` (if
    any) broken: None, or (exception class name, message), by the
    reference's rules. verify_commit checks every signature; the light
    functions stop once the signatures taken pass their threshold (2/3,
    or `trust` of the same set) unless `all_sigs`. An invalid signature
    is named by its index among the signatures taken, and raises before
    the tally is compared."""
    total = n * power
    if fn == "verify_commit":
        th, stop = total * 2 // 3, n
    else:
        num, den = (2, 3) if fn == "verify_commit_light" else trust
        th = total * num // den
        stop = n if all_sigs else min(n, absent + th // power + 1)
    if bad is not None and absent <= bad < stop:
        return ("ErrInvalidSignature", f"invalid signature at index {bad - absent}")
    tally = (stop - absent) * power
    if tally <= th:
        return ("ErrNotEnoughVotingPower", f"tallied {tally} <= threshold {th}")
    return None


def outcome_of(call):
    """None if call() returns, else (exception class name, message)."""
    try:
        call()
    except Exception as e:  # noqa: BLE001 — the caller compares class and message
        return type(e).__name__, str(e)
    return None


def check_outcome(what: str, call, want):
    got = outcome_of(call)
    if got != want:
        raise AssertionError(f"{what}: got {got}, want {want}")
    return got


def stage_split_ms(stages, reps: int, prepare=None) -> dict:
    """Median milliseconds of each stage of a chain of calls: `stages` is a
    list of (name, fn), each fn taking the previous one's result (the first
    gets None); `prepare()` runs untimed before each rep. One warm-up rep,
    then `reps` timed ones. Returns {name: median ms, ..., "sum": median of
    the reps' sums}."""
    def one():
        if prepare is not None:
            prepare()
        x, times = None, {}
        for name, fn in stages:
            t0 = time.perf_counter()
            x = fn(x)
            times[name] = (time.perf_counter() - t0) * 1e3
        return times

    one()
    runs = [one() for _ in range(reps)]
    out = {name: float(np.median([r[name] for r in runs])) for name, _ in stages}
    out["sum"] = float(np.median([sum(r.values()) for r in runs]))
    return out


def verify_stages(chain_id, vals, commit, device):
    """verify_commit's steps, by hand, as stages for `stage_split_ms`:
    the sign bytes, the adds into the consumers' verifier, submit (with
    the prefetch of the all-ok scalar) and result."""
    from cometbft_tpu_torch.crypto.batch import create_batch_verifier

    def sign_bytes(_):
        return [(vals.get_by_index(i).pub_key, commit.vote_sign_bytes(chain_id, i), cs.signature)
                for i, cs in enumerate(commit.signatures) if not cs.is_absent()]

    def adds(items):
        bv = create_batch_verifier(items[0][0], device=device)
        for pub, msg, sig in items:
            bv.add(pub, msg, sig)
        return bv

    def submit(bv):
        pending = bv.submit()
        pending.prefetch()
        return pending

    def result(pending):
        ok, _ = pending.result()
        if not ok:
            raise AssertionError("a valid commit did not verify in the stage split")
        return pending

    return [("sign_bytes", sign_bytes), ("adds", adds), ("submit", submit), ("result", result)]


def build_header_stream(chain_id: str, signers, n_headers: int, t0_s: int, device, seed: int = 1):
    """A trusted light block and `n_headers` consecutive ones after it, all
    signed by one validator set made of `signers` (equal powers): heights
    1..n_headers + 1, one second apart from t0_s, each header's
    last_block_id the previous header's block id, every validator's COMMIT
    vote one second after its header, the signatures of all headers made
    in one `utils.factories.batch_sign` call on `device`. Returns (trusted,
    stream)."""
    from cometbft_tpu_torch.light import LightBlock, SignedHeader
    from cometbft_tpu_torch.types import (BlockID, BlockIDFlag, Commit, CommitSig, Header,
                                          PartSetHeader, Timestamp)
    from cometbft_tpu_torch.utils import factories as fx

    vals = fx.make_validator_set(signers, [CONSUMER_POWER] * len(signers))
    by_addr = {s.address(): s for s in signers}
    vh = vals.hash()
    prev, headers, commits = BlockID(), [], []
    for k in range(n_headers + 1):
        hdr = Header(chain_id=chain_id, height=k + 1, time=Timestamp(t0_s + k, 0),
                     last_block_id=prev, validators_hash=vh, next_validators_hash=vh,
                     proposer_address=vals.validators[k % len(vals)].address)
        bid = BlockID(hdr.hash(), PartSetHeader(1, hashlib.sha256(b"parts %d" % k).digest()))
        commits.append(Commit(k + 1, 0, bid, [
            CommitSig(BlockIDFlag.COMMIT, v.address, Timestamp(t0_s + k + 1, i), b"")
            for i, v in enumerate(vals.validators)]))
        headers.append(hdr)
        prev = bid
    slots = [(c, i) for c in commits for i in range(len(vals))]
    sigs = fx.batch_sign([by_addr[c.signatures[i].validator_address] for c, i in slots],
                         [c.vote_sign_bytes(chain_id, i) for c, i in slots], seed=seed,
                         device=device)
    for (c, i), sig in zip(slots, sigs):
        c.signatures[i].signature = sig
    for c in commits:
        c.invalidate_memos()
    blocks = [LightBlock(SignedHeader(h, c), vals) for h, c in zip(headers, commits)]
    return blocks[0], blocks[1:]


def with_flipped_signature(commit, idx: int):
    """A copy of `commit` whose signature at idx has its first bit flipped
    (the other slots shared)."""
    from cometbft_tpu_torch.types import Commit, CommitSig

    sigs = list(commit.signatures)
    cs = sigs[idx]
    sigs[idx] = CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp,
                          bytes([cs.signature[0] ^ 1]) + cs.signature[1:])
    return Commit(commit.height, commit.round, commit.block_id, sigs)


def with_absent_prefix(commit, absent: int):
    """A copy of `commit` whose first `absent` slots are absent."""
    from cometbft_tpu_torch.types import Commit, CommitSig

    sigs = [CommitSig.absent() for _ in range(absent)] + list(commit.signatures[absent:])
    return Commit(commit.height, commit.round, commit.block_id, sigs)


def consumers_phase(dev, card, seed: int, kern: dict) -> dict:
    """Phase 6: the commit-verify consumers on the card, through their
    entry points, on data made by the port's `utils/factories.py` from
    `seed`. Returns the `consumers` results (launch counts by leg under
    "counts")."""
    from cometbft_tpu_torch.crypto import ed25519 as E
    from cometbft_tpu_torch.crypto import sched as S
    from cometbft_tpu_torch.crypto.batch import create_batch_verifier
    from cometbft_tpu_torch.light import verifier as LV
    from cometbft_tpu_torch.types import Commit, Timestamp
    from cometbft_tpu_torch.types import validation as V
    from cometbft_tpu_torch.utils import factories as fx

    out, counts = {"card": card}, {}
    chain, height, p = CONSUMER_CHAIN, CONSUMER_HEIGHT, CONSUMER_POWER

    def counted(leg, fn, need=()):
        return counted_leg(counts, "consumers", leg, fn, need)

    # the data, made by the factories on `dev` (the fixed-base ladder twin:
    # fe_mul and fe_sq launches)
    def make():
        signers = fx.make_signers(COMMIT_SIGS, seed=seed, device=dev)
        vals = fx.make_validator_set(signers, [p] * COMMIT_SIGS)
        commit = fx.make_commit(chain, height, 0, bid, vals, {s.address(): s for s in signers},
                                device=dev)
        return signers, vals, commit

    bid = fx.make_block_id(b"smoke block")
    t0 = time.perf_counter()
    (signers, vals, commit), _ = counted("factories", make, need=("fe_mul", "fe_sq"))
    out["factories_10000_s"] = time.perf_counter() - t0
    log(f"consumers: {COMMIT_SIGS} signers, validator set and commit made on {dev} in "
        f"{out['factories_10000_s']:.2f} s")
    bad = with_flipped_signature(commit, BAD_INDEX)
    absent = COMMIT_SIGS // 3 + 1  # more than a third of the power absent
    thin = with_absent_prefix(commit, absent)
    # the dispatch model's terms for the buckets the legs use (10,240 was
    # calibrated in phase 5), timed here so that no leg's counts hold them
    for bucket in sorted({E._bucket(n) for n in (COMMIT_SIGS, COMMIT_SIGS // 3 + 1)}):
        E.dispatch_model(bucket, bucket, dev)

    def run(fn_name, c, **kw):
        fn = getattr(V, fn_name)
        if fn_name == "verify_commit_light_trusting":
            return lambda: fn(chain, vals, c, device=dev, **kw)
        return lambda: fn(chain, vals, bid, height, c, device=dev, **kw)

    # 1. verify_commit at 10,000, default dispatch: valid, one bad bit, too few votes
    def leg1():
        for what, c, kw in (("valid", commit, {}), ("bad", bad, {"bad": BAD_INDEX}),
                            ("absent", thin, {"absent": absent})):
            check_outcome(f"verify_commit, {COMMIT_SIGS} validators, {what} commit",
                          run("verify_commit", c),
                          expected_outcome("verify_commit", COMMIT_SIGS, p, **kw))

    _, routes = counted("verify_commit_10000", leg1)
    need = ("accum_weight",) if "rlc" in routes else ("decompress", "ladder_sub_mul8")
    for name in need:
        if not counts["verify_commit_10000"][name]:
            raise AssertionError(f"verify_commit at {COMMIT_SIGS}: {name} never launched "
                                 f"(routes {routes})")
    out["verify_commit_10000_routes"] = routes
    log(f"verify_commit, {COMMIT_SIGS} validators: valid commit returns, bit flipped at "
        f"{BAD_INDEX} named, {absent} absent -> not enough power [{card}]")

    # the bad commit again with the RLC seam pinned: the blame rerun names it
    seam = E._rlc_beats_ladder
    E._rlc_beats_ladder = lambda n, b, device: True
    try:
        for attempt in range(1, 6):
            _, routes = counted("verify_commit_rlc", lambda: check_outcome(
                "verify_commit, RLC pinned, bad commit", run("verify_commit", bad),
                expected_outcome("verify_commit", COMMIT_SIGS, p, bad=BAD_INDEX)))
            if counts["verify_commit_rlc"]["accum_weight"]:
                break
            log(f"consumers: the RLC layout declined the bad commit (submit {attempt}); "
                "the ladder named the index")
        else:
            raise AssertionError("the RLC layout declined the bad commit 5 times in a row")
    finally:
        E._rlc_beats_ladder = seam
    if counts["verify_commit_rlc"]["ladder_sub_mul8"] < 2:
        raise AssertionError("RLC pinned: no blame rerun on the ladder after the tail")
    out["rlc_submits"] = attempt
    log(f"verify_commit, RLC pinned: all-ok false, the blame rerun names index {BAD_INDEX} "
        f"({attempt} submit(s)) [{card}]")

    # 2. the light functions on the same commits
    def leg2():
        for fn_name in CONSUMER_FUNCS[1:]:
            for all_sigs in (False, True):
                for what, c, kw in (("valid", commit, {}), ("bad", bad, {"bad": BAD_INDEX}),
                                    ("absent", thin, {"absent": absent})):
                    extra = {"verify_all_signatures": True} if all_sigs else {}
                    got = check_outcome(
                        f"{fn_name} ({'all signatures' if all_sigs else 'stops at threshold'}),"
                        f" {what} commit", run(fn_name, c, **extra),
                        expected_outcome(fn_name, COMMIT_SIGS, p, all_sigs=all_sigs, **kw))
                    log(f"  {fn_name}, all_sigs={all_sigs}, {what}: {got}")

    counted("verify_commit_light", leg2, need=("decompress", "ladder_sub_mul8"))

    # 3. a 150-validator commit: the native route
    small_signers = fx.make_signers(NATIVE_SIGS, seed=seed + 1, device=dev)
    small_vals = fx.make_validator_set(small_signers, [p] * NATIVE_SIGS)
    small = fx.make_commit(chain, height, 0, bid, small_vals,
                           {s.address(): s for s in small_signers}, device=dev)
    small_absent = NATIVE_SIGS // 3 + 1

    def leg3():
        for what, c, kw in (("valid", small, {}),
                            ("bad", with_flipped_signature(small, SMALL_BAD_INDEX),
                             {"bad": SMALL_BAD_INDEX}),
                            ("absent", with_absent_prefix(small, small_absent),
                             {"absent": small_absent})):
            check_outcome(f"verify_commit, {NATIVE_SIGS} validators, {what} commit",
                          lambda: V.verify_commit(chain, small_vals, bid, height, c, device=dev),
                          expected_outcome("verify_commit", NATIVE_SIGS, p, **kw))

    _, routes = counted("verify_commit_150", leg3)
    if set(routes) != {"native", "batch"}:
        raise AssertionError(f"the {NATIVE_SIGS}-validator commit took {routes}, not native")
    log(f"verify_commit, {NATIVE_SIGS} validators: native route; valid, index "
        f"{SMALL_BAD_INDEX} named, too few votes refused [{card}]")

    # 4. Commit.decode of the 10,000-signature commit through commit_parse
    enc = commit.encode()
    dec = Commit.decode(enc)
    if "_cols" not in dec.__dict__:
        raise AssertionError("Commit.decode did not take the native commit_parse")
    blob, lens = dec.vote_sign_bytes_blob(chain)
    off = 0
    for i in range(COMMIT_SIGS):
        ln = int(lens[i])
        if blob[off:off + ln] != dec.vote_sign_bytes(chain, i):
            raise AssertionError(f"vote_sign_bytes_blob differs from vote_sign_bytes at {i}")
        off += ln
    if dec.encode() != enc or Commit.decode(enc).hash() != commit.hash():
        raise AssertionError("the decoded commit does not re-encode to the same bytes")
    out["decode_10000_ms"] = median_ms(lambda: Commit.decode(enc), ROUTE_REPS)
    out["sign_bytes_blob_10000_ms"] = median_ms(
        lambda: Commit.decode(enc).vote_sign_bytes_blob(chain), ROUTE_REPS)
    log(f"Commit.decode, {COMMIT_SIGS} signatures ({len(enc)} bytes): native commit_parse, "
        f"re-encodes byte-identical, blob equals vote_sign_bytes on every index; decode "
        f"{out['decode_10000_ms']:.3f} ms, decode + sign-bytes blob "
        f"{out['sign_bytes_blob_10000_ms']:.3f} ms (median of {ROUTE_REPS}) [{card}]")

    # 5. the light client's header stream: one mega-batch
    t0_s = 1_700_000_000
    trusted, stream = build_header_stream(chain, small_signers, STREAM_HEADERS, t0_s, dev,
                                          seed=seed + 2)
    now = Timestamp(t0_s + STREAM_HEADERS + 5, 0)
    lanes = STREAM_HEADERS * NATIVE_SIGS
    k, slot = STREAM_BAD
    broken = list(stream)
    lb = stream[k]
    broken[k] = type(lb)(type(lb.signed_header)(
        lb.signed_header.header, with_flipped_signature(lb.signed_header.commit, slot)),
        lb.validators)

    def leg5():
        check_outcome(f"verify_stream, {STREAM_HEADERS} headers",
                      lambda: LV.verify_stream(chain, trusted, stream, TRUST_PERIOD_S, now,
                                               device=dev), None)
        check_outcome(f"verify_stream, signature {slot} of header {k} flipped",
                      lambda: LV.verify_stream(chain, trusted, broken, TRUST_PERIOD_S, now,
                                               device=dev),
                      ("ErrInvalidSignature",
                       f"invalid signature in stream lane {k * NATIVE_SIGS + slot}"))

    _, routes = counted("verify_stream", leg5)
    if not counts["verify_stream"]["ladder_sub_mul8"]:
        raise AssertionError("verify_stream: the ladder never launched")
    out["stream_routes"] = routes
    log(f"verify_stream: {STREAM_HEADERS} headers x {NATIVE_SIGS} = {lanes} lanes in one "
        f"batch pass; lane {k * NATIVE_SIGS + slot} named when broken [{card}]")

    # 6. the scheduler: two tenants coalesce into one dispatch
    halves = {}
    for t, lo in (("tenant-a", 0), ("tenant-b", TENANT_SIGS)):
        t_signers = signers[lo:lo + TENANT_SIGS]
        t_vals = fx.make_validator_set(t_signers, [p] * TENANT_SIGS)
        t_bid = fx.make_block_id(t.encode())
        t_commit = fx.make_commit(t, height, 0, t_bid, t_vals,
                                  {s.address(): s for s in t_signers}, device=dev)
        halves[t] = (t_vals, t_bid, t_commit)

    def filled(t, c):
        t_vals = halves[t][0]
        bv = create_batch_verifier(t_vals.validators[0].pub_key, device=dev)
        for i, cs in enumerate(c.signatures):
            bv.add(t_vals.get_by_index(i).pub_key, c.vote_sign_bytes(t, i), cs.signature)
        return bv

    sched_out = {}
    for case in ("valid", "tenant-b bad lane"):
        commits = {t: h[2] for t, h in halves.items()}
        if case != "valid":
            commits["tenant-b"] = with_flipped_signature(commits["tenant-b"], TENANT_BAD_LANE)
        own = {t: filled(t, c).verify() for t, c in commits.items()}
        sched = S.VerifyScheduler(device=dev, manual=True)
        try:
            handles = {t: sched.submit(filled(t, c), tenant=t, source="consensus")
                       for t, c in commits.items()}
            n_done, _ = counted(f"sched_{case}", sched.drain_once,
                                need=("decompress", "ladder_sub_mul8"))
            got = {t: h.result(timeout=120) for t, h in handles.items()}
        finally:
            sched.close()
        if n_done != 2 or sched.stats["coalesced_requests"] != 2 or \
                sched.stats["dispatches"] != 1:
            raise AssertionError(f"scheduler, {case}: not one coalesced dispatch: {sched.stats}")
        c = counts[f"sched_{case}"]
        if case == "valid" and c["ladder_sub_mul8"] != 1:
            raise AssertionError(f"scheduler: {c['ladder_sub_mul8']} ladder launches, not 1")
        if got != own:
            raise AssertionError(f"scheduler, {case}: a tenant's bitmap differs from its own "
                                 "verifier's")
        want_b = [i != TENANT_BAD_LANE for i in range(TENANT_SIGS)] if case != "valid" else \
            [True] * TENANT_SIGS
        if got["tenant-a"] != (True, [True] * TENANT_SIGS) or \
                got["tenant-b"] != (all(want_b), want_b):
            raise AssertionError(f"scheduler, {case}: verdicts wrong")
        sched_out[case] = {"stats": dict(sched.stats), "ladder_launches": c["ladder_sub_mul8"]}
        log(f"scheduler, {case}: 2 x {TENANT_SIGS} signatures in one dispatch, each tenant's "
            f"bitmap equal to its own verifier's [{card}]")

    # the same through verify_commit under verify_context, from two threads
    import threading

    commits = {t: h[2] for t, h in halves.items()}
    commits["tenant-b"] = with_flipped_signature(commits["tenant-b"], TENANT_BAD_LANE)
    sched = S.VerifyScheduler(device=dev, manual=True)
    results = {}

    def tenant(t):
        t_vals, t_bid, _ = halves[t]
        with S.verify_context(sched, t, "consensus"):
            results[t] = outcome_of(lambda: V.verify_commit(t, t_vals, t_bid, height,
                                                            commits[t], device=dev))

    threads = [threading.Thread(target=tenant, args=(t,), daemon=True) for t in halves]
    try:
        for th in threads:
            th.start()
        deadline = time.monotonic() + 120
        while sched._n_queued < 2:
            if time.monotonic() > deadline or not all(th.is_alive() for th in threads):
                raise AssertionError(f"the tenants never both queued: {results}")
            time.sleep(0.005)
        counted("sched_verify_context", sched.drain_once)
        for th in threads:
            th.join(120)
    finally:
        sched.close()
    want = {"tenant-a": None, "tenant-b": ("ErrInvalidSignature",
                                           f"invalid signature at index {TENANT_BAD_LANE}")}
    if results != want or sched.stats["coalesced_requests"] != 2:
        raise AssertionError(f"verify_context: {results}, {sched.stats}")
    sched_out["verify_context"] = {"stats": dict(sched.stats), "outcomes": results}
    out["scheduler"] = sched_out
    log(f"verify_commit under verify_context, two tenants from two threads: one coalesced "
        f"dispatch; tenant-a verifies, tenant-b fails naming index {TENANT_BAD_LANE} [{card}]")

    # 7. timings, warm, median of ROUTE_REPS (not counted: the counts were read above)
    timing = {}
    for n, t_vals, t_commit in ((NATIVE_SIGS, small_vals, small), (COMMIT_SIGS, vals, commit)):
        check_outcome("warm-up", lambda: V.verify_commit(chain, t_vals, bid, height, t_commit,
                                                         device=dev), None)
        walls = []
        for _ in range(ROUTE_REPS):
            t_commit.invalidate_memos()  # a fresh commit's sign bytes, as a node decodes one
            t1 = time.perf_counter()
            V.verify_commit(chain, t_vals, bid, height, t_commit, device=dev)
            walls.append((time.perf_counter() - t1) * 1e3)
        split = stage_split_ms(verify_stages(chain, t_vals, t_commit, dev), ROUTE_REPS,
                               prepare=t_commit.invalidate_memos)
        pending = verify_stages(chain, t_vals, t_commit, dev)
        x = None
        for _, fn in pending[:3]:
            x = fn(x)
        prefetched = x._ready is not None if hasattr(x, "_ready") else False
        x.result()
        if n == COMMIT_SIGS and dev.type == "cuda" and not prefetched:
            raise AssertionError(f"the {n}-signature commit's handle {type(x).__name__} did not "
                                 "prefetch its all-ok scalar")
        timing[n] = {"verify_commit_ms": float(np.median(walls)), "split_ms": split,
                     "handle": type(x).__name__, "prefetched": prefetched}
        log(f"verify_commit, {n} validators, warm (median of {ROUTE_REPS}): "
            f"{timing[n]['verify_commit_ms']:.3f} ms; by hand: " + ", ".join(
                f"{k} {v:.3f}" for k, v in split.items()) + f" ms ({type(x).__name__}) [{card}]")
    walls = []
    for _ in range(ROUTE_REPS + 1):
        for lb in (trusted, *stream):
            lb.signed_header.commit.invalidate_memos()
        t1 = time.perf_counter()
        LV.verify_stream(chain, trusted, stream, TRUST_PERIOD_S, now, device=dev)
        walls.append(time.perf_counter() - t1)
    stream_s = float(np.median(walls[1:]))
    timing["stream"] = {"headers": STREAM_HEADERS, "lanes": lanes, "ms": stream_s * 1e3,
                        "headers_per_s": STREAM_HEADERS / stream_s, "sigs_per_s": lanes / stream_s}
    log(f"verify_stream, {STREAM_HEADERS} headers x {NATIVE_SIGS} validators, warm (median of "
        f"{ROUTE_REPS}): {stream_s * 1e3:.3f} ms -> {STREAM_HEADERS / stream_s:.1f} headers/s, "
        f"{lanes / stream_s:.0f} sigs/s [{card}]")
    out["timing"] = timing
    out["counts"] = counts
    for name in SOURCES:
        kern[name]["launches_by_route"]["consumers"] = sum(c[name] for c in counts.values())
        kern[name]["launches"] += kern[name]["launches_by_route"]["consumers"]
    return out

# ---- phase 7: block-sync replay

REPLAY_CHAIN = "replay-bench"
REPLAY_BLOCKS = 256  # the north star's 50,000 blocks cut to four windows
REPLAY_VALIDATORS = 1_000
REPLAY_WINDOW = 64  # the reference's default
REPLAY_POWER = 10  # make_validator_set's default power
REPLAY_BAD = (2, 777)  # (height, commit index) of the bad chain's flipped signature
REPLAY_BAD_BLOCKS = 6
REPLAY_STAGES = ("load", "queue", "submit", "resolve", "apply")
REPLAY_CHECK_BAD_LANE = 64_777  # the tampered lane of the checked window (its tip commit)
REPLAY_RLC_TRIES = 5  # passes of the RLC-pinned leg until the layout accepts a window


def replay_window_lanes(n_blocks: int, n_vals: int, window: int) -> list[int]:
    """Lanes of each batched-replay window over a chain of `n_blocks` blocks
    from height 1, one validator set of `n_vals`, every vote a COMMIT: each
    block's embedded last commit (none in block 1) and the tip commit."""
    return [(min(lo + window - 1, n_blocks) - lo + 1 - (lo == 1) + 1) * n_vals
            for lo in range(1, n_blocks + 1, window)]


def replay_bad_lane(height: int, idx: int, n_vals: int, window: int) -> int:
    """The window lane of commit index `idx` of height `height`'s commit, in
    the first window that verifies it: block height + 1's embedded last
    commit, or the tip commit of the window that ends at `height`."""
    lo = (height - 1) // window * window + 1  # first block of height's window
    before = (height - lo + 1 - (lo == 1)) * n_vals  # last commits of lo..height
    return before + idx


def expected_replay_outcome(mode: str, n_blocks: int, n_vals: int, power: int,
                            bad_height: int, bad_idx: int, window: int):
    """(exception class name, message, blocks applied first) of replaying a
    make_chain chain whose commit of `bad_height` has the signature at
    `bad_idx` broken, by the reference's rules. Batched: the window that
    first verifies the commit fails naming its lane, before any of its
    blocks applies. Full: at each height the light check of its commit
    (which stops at 2/3, `expected_outcome`), then the block's validation,
    whose full check of its last commit wraps the error."""
    if mode == "batched":
        lo = (bad_height - 1) // window * window + 1
        return ("ErrInvalidSignature",
                f"invalid signature in window lane "
                f"{replay_bad_lane(bad_height, bad_idx, n_vals, window)}", lo - 1)
    for h in range(1, n_blocks + 1):
        if h == bad_height:
            got = expected_outcome("verify_commit_light", n_vals, power, bad=bad_idx)
            if got is not None:
                return (*got, h - 1)
        if h - 1 == bad_height:
            got = expected_outcome("verify_commit", n_vals, power, bad=bad_idx)
            if got is not None:
                return ("BlockValidationError", f"invalid last commit: {got[1]}", h - 1)
    return None


def counted_leg(counts: dict, phase: str, leg: str, fn, need=()):
    """fn() with every launch count set to 0 just before and read just after
    (into counts[leg]); a kernel of `need` never launched is an error.
    Returns (fn's result, the routes the crypto path counters saw)."""
    from cometbft_tpu_torch.ops import kernels as K
    from cometbft_tpu_torch.utils.metrics import crypto_metrics

    torch.cuda.synchronize()
    K.reset_launches()
    before = crypto_metrics().path_selected_total.values()
    res = fn()
    torch.cuda.synchronize()
    c = dict(K.launches)
    counts[leg] = c
    now = crypto_metrics().path_selected_total.values()
    routes = {k[0]: v - before.get(k, 0.0) for k, v in now.items()
              if k[1] == "ed25519" and v != before.get(k, 0.0)}
    log(f"{phase}, {leg}: routes {routes}; launches {({k: v for k, v in c.items() if v})}")
    for name in need:
        if not c[name]:
            raise AssertionError(f"{phase}, {leg}: kernel {name} was never launched")
    return res, routes


class SubmitTimer:
    """The replay engine's verify-scheduler seam (`sched=`), used to time
    each window's submit: it submits the batch itself, as the engine does
    when it has no scheduler, and adds up the seconds. With `keep`, it
    keeps the window's batch verifier and verifies nothing instead."""

    def __init__(self, keep: bool = False):
        self.seconds, self.keep, self.kept = 0.0, keep, None

    def submit(self, bv, tenant: str = "", source: str = ""):
        from cometbft_tpu_torch.crypto import ed25519 as E

        if self.keep:
            self.kept = bv
            return E.DonePending(True, [])
        t = time.perf_counter()
        try:
            return bv.submit()
        finally:
            self.seconds += time.perf_counter() - t


def replay_window_check(dev, card, store, state, window: int, mul_rate: float) -> dict:
    """`batch_window_check` on one replay window: the second window of
    make_chain's chain (64 embedded last commits and the tip commit, 65,000
    lanes, bucket 65,536), queued by the engine itself, with lane 64,777
    (in its tip commit) the tampered one."""
    from cometbft_tpu_torch.abci import AppConns, KVStoreApp
    from cometbft_tpu_torch.blocksync import ReplayEngine
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.types.block import block_id_for

    keep = SubmitTimer(keep=True)
    eng = ReplayEngine(store, BlockExecutor(AppConns(KVStoreApp()), device=dev), window=window,
                       device=dev, sched=keep)
    blocks = [store.load_block(h) for h in range(window + 1, 2 * window + 1)]
    eng._queue_window(state.chain_id, state.validators, state.validators,
                      block_id_for(store.load_block(window)), state.initial_height, blocks)
    want_n = replay_window_lanes(2 * window, len(state.validators), window)[1]
    if keep.kept.count() != want_n:
        raise AssertionError(f"replay window check: {keep.kept.count()} lanes queued, want {want_n}")
    return batch_window_check(dev, card, keep.kept, "replay window", REPLAY_CHECK_BAD_LANE, mul_rate)


def pinned_rlc_submit(bv, what: str):
    """`bv.submit()` with the RLC route pinned, again until the layout
    accepts the batch (it draws z afresh on each submit). Returns the RLC
    pending result and the number of submits it took."""
    from cometbft_tpu_torch.crypto import ed25519 as E

    prev = E._rlc_beats_ladder
    E._rlc_beats_ladder = lambda n_, b_, device: True
    try:
        for submits in range(1, REPLAY_RLC_TRIES + 1):
            pending = bv.submit()
            if pending._path == "rlc":
                return pending, submits
    finally:
        E._rlc_beats_ladder = prev
    raise AssertionError(f"the RLC layout declined {what} {REPLAY_RLC_TRIES} times")


def batch_window_check(dev, card, bv, what: str, bad_lane: int, mul_rate: float) -> dict:
    """The verify path's kernels held against their plain versions at the
    shapes one queued window `bv` (an Ed25519BatchVerifier of n lanes,
    bucket b) gives them:

    - `decompress` and `ladder_sub_mul8` over the whole bucket, as the
      ladder route launches them, against their plain versions on 1,027
      lanes spread over it (first and last included), or on every lane of
      a smaller bucket, bit for bit after freeze; ragged launches of the
      live lanes equal to the bucket's; and every live lane's [8](...) the
      identity;
    - the window's RLC layout (`slot_depth` rounds, padded to S):
      `accum_weight` against its plain version bit for bit after freeze,
      ragged launches equal to the full one; `region_sum`,
      `window_combine` and the B = 1 ladder tail on its output, each
      against its plain version, and the window's verdict true;
    - a copy of the window through `submit()` with the RLC seam pinned:
      the all-ok scalar true, so no blame rerun, and every lane verified;
    - a copy with lane `bad_lane`'s signature broken, the same way: the
      RLC verdict false, and the blame rerun on the ladder names that
      lane and no other.

    A batch below RLC_MIN never takes that route, so for it the RLC items
    give way to the batch's own route: a copy through
    `submit()` with the NATIVE_MAX seam at 0 takes the ladder and verifies
    every lane, and a copy with lane `bad_lane` broken names it alone.
    """
    from cometbft_tpu_torch.crypto import ed25519 as E
    from cometbft_tpu_torch.ops import curve as C
    from cometbft_tpu_torch.ops import field as F
    from cometbft_tpu_torch.ops import kernels as K
    from cometbft_tpu_torch.ops import msm as M
    from cometbft_tpu_torch.ops import scalar as SC

    n = bv.count()
    b = E._bucket(n)
    per_lane = products_per_lane(8)
    out = {"lanes": n, "bucket": b}

    def bound_ms(name, batch, nbytes, products=None):
        ops_s = wide_muls(products or per_lane[name]) * batch / mul_rate
        return max(ops_s, nbytes / HBM_BYTES_PER_S) * 1e3

    # the ladder route's inputs: R || S || k packed on the host, A's column
    rsk = bv._pack_rsk(n, b).to(dev)
    ok_a, neg_a = bv._decompress_pubkeys(n, b)
    s_dig = SC.digits_from_bytes(rsk[:, 32:64]).contiguous()
    k_dig = SC.digits_from_bytes(rsk[:, 64:]).contiguous()
    sign, y = C._split_encoding(rsk[:, :32])
    sign_row = sign[None, :].contiguous()
    n_check = min(LADDER_CHECK_LANES, b)
    lanes = torch.linspace(0, b - 1, n_check, device=dev).round().long()
    if len(set(lanes.tolist())) != n_check:
        raise AssertionError(f"{what} check: the sampled lanes repeat")

    valid, x, t = K.decompress(y, sign_row)
    pv, px, pt = C.decompress_plain(y[:, lanes], sign[lanes])
    mx, ex = frozen_diff(F, x[:, lanes], px)
    mt, et = frozen_diff(F, t[:, lanes], pt)
    mism = int(((valid[0, lanes] != 0) != pv).sum()) + mx + mt
    part = K.decompress(y[:, :n].contiguous(), sign_row[:, :n].contiguous())
    if not all(torch.equal(g, f[:, :n]) for g, f in zip(part, (valid, x, t))):
        raise AssertionError(f"decompress: lanes differ between B={n} and B={b} launches")
    if mism or not bool((valid[0, :n] != 0).all()) or not bool(ok_a[:n].all()):
        raise AssertionError(f"decompress at B={b}: {mism} of {n_check} sampled lanes "
                             "disagree with the plain version, or a live R or A is invalid")
    out["decompress"] = {"batch": b, "mismatches": mism, "max_abs_err": max(ex, et),
                         "ms": cuda_ms(lambda: K.decompress(y, sign_row), 10),
                         "bound_ms": bound_ms("decompress", b, (88 + 4) * b + (4 + 2 * 88) * b)}

    one = F.const(1, dev).expand_as(y)
    r_pt = (x, y, one, t)
    a4, r4 = torch.stack(neg_a[:4]), torch.stack(r_pt)
    base = C.base_niels(dev)
    sub = K.ladder_sub_mul8(a4, r4, s_dig, k_dig, base)
    want = C.ladder_sub_mul8_plain(s_dig[:, lanes], k_dig[:, lanes],
                                   tuple(c[:, lanes] for c in neg_a), tuple(c[:, lanes] for c in r_pt))
    mism, err = frozen_diff(F, sub[..., lanes], torch.stack(want))
    part = K.ladder_sub_mul8(a4[..., :n].contiguous(), r4[..., :n].contiguous(),
                             s_dig[:, :n].contiguous(), k_dig[:, :n].contiguous(), base)
    if not torch.equal(part, sub[..., :n]):
        raise AssertionError(f"ladder_sub_mul8: lanes differ between B={n} and B={b} launches")
    ident = F.is_zero(sub[0, :, :n]) & F.eq(sub[1, :, :n], sub[2, :, :n])
    if mism or not bool(ident.all()):
        raise AssertionError(f"ladder_sub_mul8 at B={b}: {mism} of {n_check} sampled "
                             f"lanes disagree with the plain version; {int((~ident).sum())} live "
                             "lanes do not verify")
    out["ladder_sub_mul8"] = {
        "batch": b, "mismatches": mism, "max_abs_err": err,
        "ms": cuda_ms(lambda: K.ladder_sub_mul8(a4, r4, s_dig, k_dig, base), 5),
        "bound_ms": bound_ms("ladder_sub_mul8", b, (8 * 88 + 2 * 256 + 264) * b
                             + base.numel() * 4)}
    del rsk, s_dig, k_dig, y, x, t, valid, a4, r4, sub, part, one, r_pt, neg_a, ok_a
    if n < E.RLC_MIN:
        saved = E.NATIVE_MAX
        E.NATIVE_MAX = 0
        try:
            for lane in (None, bad_lane):
                copy = E.Ed25519BatchVerifier(dev)
                copy.absorb(bv)
                if lane is not None:
                    copy._sig_buf[64 * lane] ^= 1
                pending = copy.submit()
                ok, bits = pending.result()
                wrong = [i for i, v in enumerate(bits) if not v]
                if (pending._path != "ladder" or len(bits) != n or ok != (lane is None)
                        or wrong != ([] if lane is None else [lane])):
                    raise AssertionError(f"{what} through submit(): route {pending._path}, "
                                         f"verdict {ok}, false lanes {wrong[:20]}, want "
                                         f"{[] if lane is None else [lane]}")
        finally:
            E.NATIVE_MAX = saved
        out["tampered"] = {"lane": bad_lane, "route": "ladder"}
        log(f"{what} check, {n} lanes at bucket {b}: decompress and ladder_sub_mul8 exact on "
            f"all {n_check} lanes against the plain versions, ragged B={n} launches equal, "
            f"every live lane verifies; through submit() on the ladder every lane true, lane "
            f"{bad_lane} broken named alone. Times ms (bound): " + ", ".join(
                f"{k} {out[k]['ms']:.4f} ({out[k]['bound_ms']:.4f})"
                for k in ("decompress", "ladder_sub_mul8")) + f" [{card}]")
        return out

    # the RLC route's inputs: the window's layout, as `_launch_rlc` packs it
    for tries in range(1, REPLAY_RLC_TRIES + 1):
        packed = bv._pack_rlc()
        if packed is not None:
            break
    else:
        raise AssertionError(f"the RLC layout declined the checked {what} {REPLAY_RLC_TRIES} times")
    buf, fields, s_pad = packed
    f = E.unpack_fields(buf.to(dev), fields)
    gather_idx, gather_neg = M.expand_stream(f["stream"], f["stream_neg"], f["counts"], s_pad)
    gather_idx = gather_idx.contiguous()
    neg32 = gather_neg.to(torch.int32).contiguous()
    _, a_pt = C.decompress(f["a"])
    _, r_pt = C.decompress(f["r"])
    niels = tuple(torch.cat([r_c, a_c, i_c], dim=1).contiguous() for r_c, a_c, i_c in zip(
        C.to_niels(r_pt)[:3], C.to_niels(a_pt)[:3], M._identity_niels(1, dev)))
    weights = f["weights"].reshape(-1).to(torch.int32).contiguous()
    got = K.accum_weight(niels, gather_idx, neg32, weights)
    mism, err = frozen_diff(F, got, M.accumulate_weighted_plain(niels, gather_idx, gather_neg,
                                                                weights))
    for m in RAGGED_LANES:
        part = K.accum_weight(niels, gather_idx[:, :m].contiguous(), neg32[:, :m].contiguous(),
                              weights[:m].contiguous())
        if not torch.equal(part, got[..., :m]):
            raise AssertionError(f"accum_weight at S={s_pad}: lanes differ between WK={m} and "
                                 f"WK={M.WK} launches")
    if mism:
        raise AssertionError(f"accum_weight at S={s_pad}: {mism} lanes disagree with the plain "
                             "version")
    n_pts = niels[0].shape[1]
    out["accum_weight"] = {
        "batch": M.WK, "s_pad": s_pad, "points": n_pts, "layout_tries": tries,
        "mismatches": mism, "max_abs_err": err,
        "ms": cuda_ms(lambda: K.accum_weight(niels, gather_idx, neg32, weights), 10),
        "bound_ms": bound_ms("accum_weight", M.WK, 3 * 88 * n_pts + 2 * 4 * s_pad * M.WK
                             + 4 * M.WK + 4 * 88 * M.WK,
                             products_per_lane(s_pad)["accum_weight"])}
    sums = K.region_sum(got)
    m_sum, _ = frozen_diff(F, sums, M.region_tree_sum_plain(got))
    msm = K.window_combine(sums.contiguous())
    m_msm, _ = frozen_diff(F, msm, M.window_combine_plain(sums))
    c_dig = f["c_digits"].contiguous()
    tail_args = (c_dig, torch.zeros_like(c_dig), C.identity(1, dev), C.neg(msm))
    tail = torch.stack(C.ladder_sub_mul8(*tail_args))
    m_tail, _ = frozen_diff(F, tail, torch.stack(C.ladder_sub_mul8_plain(*tail_args)))
    if m_sum or m_msm or m_tail:
        raise AssertionError(f"the RLC tail of the checked {what} disagrees with the plain "
                             f"versions: region_sum {m_sum}, window_combine {m_msm}, ladder at "
                             f"B = 1 {m_tail}")
    if not bool(F.is_zero(tail[0])[0] & F.eq(tail[1], tail[2])[0]):
        raise AssertionError(f"the checked {what}'s [8](msm + [c]B) is not the identity")
    del f, buf, gather_idx, gather_neg, neg32, niels, weights, got, sums, msm, tail

    # the window through submit() with RLC pinned: all-ok, no blame rerun
    clean = E.Ed25519BatchVerifier(dev)
    clean.absorb(bv)
    pending, clean_submits = pinned_rlc_submit(clean, f"the checked {what}")
    all_ok = bool(pending._all_ok.item())
    ok, bits = pending.result()
    if not all_ok or not ok or len(bits) != n or not all(bits):
        raise AssertionError(f"the clean {what} on RLC: all-ok {all_ok}, verdict {ok}, "
                             f"{sum(not v for v in bits)} of {len(bits)} lanes false")
    out["clean_rlc"] = {"all_ok": all_ok, "submits": clean_submits}

    # the tampered copy: the RLC verdict false, the blame names the lane
    bad = E.Ed25519BatchVerifier(dev)
    bad.absorb(bv)
    bad._sig_buf[64 * bad_lane] ^= 1
    pending, submits = pinned_rlc_submit(bad, f"the tampered {what}")
    if bool(pending._all_ok.item()):
        raise AssertionError(f"the tampered {what}: the RLC all-ok scalar is not false")
    ok, bits = pending.result()
    wrong = [i for i, v in enumerate(bits) if not v]
    if ok or wrong != [bad_lane] or len(bits) != n:
        raise AssertionError(f"the tampered {what}: blame names lanes {wrong[:20]}, want "
                             f"[{bad_lane}]")
    out["tampered"] = {"lane": bad_lane, "submits": submits}
    log(f"{what} check, {n} lanes at bucket {b}: decompress and ladder_sub_mul8 exact on "
        f"{n_check} lanes against the plain versions, ragged B={n} launches equal, "
        f"every live lane verifies; accum_weight at S={s_pad} ({n_pts} points, layout accepted "
        f"on try {tries}) exact, ragged {RAGGED_LANES} equal; region_sum, window_combine and "
        f"the B = 1 tail exact, verdict true; through submit() on RLC: all-ok true with no "
        f"blame rerun; lane {bad_lane} broken: RLC false, blame names it alone. Times ms "
        f"(bound): " + ", ".join(
            f"{k} {out[k]['ms']:.4f} ({out[k]['bound_ms']:.4f})"
            for k in ("decompress", "ladder_sub_mul8", "accum_weight")) + f" [{card}]")
    return out


def replay_phase(dev, card, seed: int, kern: dict, mul_rate: float) -> dict:
    """Phase 7: block-sync replay on the card through its entry points:
    `utils/factories.py::make_chain` makes a signed chain, and
    `blocksync.ReplayEngine(store, BlockExecutor(AppConns(KVStoreApp())))`
    replays it. Returns the `replay` results (launch counts by leg under
    "counts")."""
    from cometbft_tpu_torch.abci import AppConns, KVStoreApp
    from cometbft_tpu_torch.blocksync import ReplayEngine
    from cometbft_tpu_torch.crypto import ed25519 as E
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.utils import factories as fx

    out, counts = {"card": card}, {}
    n, window, power = REPLAY_VALIDATORS, REPLAY_WINDOW, REPLAY_POWER

    # the chain, made on the card (the fixed-base ladder: fe_mul, fe_sq)
    t0 = time.perf_counter()
    (store, final, genesis, _), _ = counted_leg(counts, "replay", "generate", lambda: fx.make_chain(
        REPLAY_BLOCKS, n_validators=n, chain_id=REPLAY_CHAIN, txs_per_block=1, seed=seed,
        device=dev, r_pool=fx.RPool(n, device=dev)), need=("fe_mul", "fe_sq"))
    out["generate_s"] = time.perf_counter() - t0
    log(f"replay: make_chain {REPLAY_BLOCKS} blocks x {n} validators on {dev} in "
        f"{out['generate_s']:.2f} s ({counts['generate']['fe_mul']} fe_mul, "
        f"{counts['generate']['fe_sq']} fe_sq launches) [{card}]")
    want_lanes = replay_window_lanes(REPLAY_BLOCKS, n, window)
    want_sigs = sum(want_lanes)

    # the kernels at one window's shapes, against their plain versions
    t0 = time.perf_counter()
    out["window_check"] = replay_window_check(dev, card, store, genesis, window, mul_rate)
    out["window_check"]["seconds"] = time.perf_counter() - t0
    log(f"replay window check: {out['window_check']['seconds']:.2f} s")

    class Timed(ReplayEngine):
        """The engine with its stages timed and each window's lanes, route
        and bucket recorded (nothing of the engine changed)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.t = dict.fromkeys(REPLAY_STAGES, 0.0)
            self.windows = []

        def _load_window(self, *a):
            t = time.perf_counter()
            try:
                return super()._load_window(*a)
            finally:
                self.t["load"] += time.perf_counter() - t

        def _queue_window(self, *a):
            t, s = time.perf_counter(), self.sched.seconds
            handle = super()._queue_window(*a)
            sub = self.sched.seconds - s
            self.t["submit"] += sub
            self.t["queue"] += time.perf_counter() - t - sub
            self.windows.append((handle[2], getattr(handle[0], "_path", "none"),
                                 E._bucket(handle[2])))
            return handle

        def _resolve_window(self, handle):
            t = time.perf_counter()
            try:
                return super()._resolve_window(handle)
            finally:
                self.t["resolve"] += time.perf_counter() - t

    class TimedExecutor(BlockExecutor):
        def apply_block_preverified(self, *a):
            t = time.perf_counter()
            try:
                return super().apply_block_preverified(*a)
            finally:
                self.t_apply += time.perf_counter() - t

    def engine(store_, mode):
        ex = TimedExecutor(AppConns(KVStoreApp()), device=dev)
        ex.t_apply = 0.0
        return Timed(store_, ex, verify_mode=mode, window=window, device=dev, sched=SubmitTimer())

    def replay(mode, store_=None, state0=None):
        eng = engine(store_ or store, mode)
        t = time.perf_counter()
        state, stats = eng.run((state0 or genesis).copy())
        torch.cuda.synchronize()
        return eng, state, stats, time.perf_counter() - t

    def check_final(what, state, stats, sigs):
        if stats.blocks != REPLAY_BLOCKS or stats.sigs_verified != sigs:
            raise AssertionError(f"replay, {what}: {stats.blocks} blocks, {stats.sigs_verified} "
                                 f"signatures; want {REPLAY_BLOCKS}, {sigs}")
        if (state.app_hash, state.validators.hash(), state.last_block_id) != \
                (final.app_hash, final.validators.hash(), final.last_block_id) or \
                state.encode() != final.encode():
            raise AssertionError(f"replay, {what}: the final state is not make_chain's")

    def batched(what, seam=None, need=()):
        prev = E._rlc_beats_ladder
        if seam is not None:
            E._rlc_beats_ladder = lambda n_, b, device: seam
        try:
            (eng, state, stats, wall), routes = counted_leg(
                counts, "replay", what, lambda: replay("batched"), need=need)
        finally:
            E._rlc_beats_ladder = prev
        check_final(what, state, stats, want_sigs)
        lanes = [w[0] for w in eng.windows]
        if lanes != want_lanes or {w[2] for w in eng.windows} != {E._bucket(max(want_lanes))}:
            raise AssertionError(f"replay, {what}: windows {eng.windows}, want lanes {want_lanes}")
        stage = {k: v * 1e3 / REPLAY_BLOCKS for k, v in eng.t.items()}
        stage["apply"] = eng.executor.t_apply * 1e3 / REPLAY_BLOCKS
        res = {"wall_s": wall, "blocks_per_s": REPLAY_BLOCKS / wall,
               "sigs_per_s": stats.sigs_verified / wall, "windows": eng.windows,
               "routes": routes, "stage_ms_per_block": stage}
        log(f"replay, batched {what}: {REPLAY_BLOCKS} blocks in {wall:.3f} s -> "
            f"{res['blocks_per_s']:.1f} blocks/s, {res['sigs_per_s']:.0f} sigs/s; windows "
            f"(lanes, route, bucket) {eng.windows}; per block ms: " + ", ".join(
                f"{k} {v:.3f}" for k, v in stage.items()) + f" [{card}]")
        return res

    # batched, default dispatch: a warm pass (the dispatch model calibrates
    # bucket 65,536 at its first decision), then the timed pass
    out["default_warm"] = batched("default_warm")
    out["default"] = batched("default")
    # the calibrated model's pick for each window size (True: RLC); a
    # window it sent to RLC that shows the ladder was declined by the layout
    picks = {m: E._rlc_beats_ladder(m, E._bucket(m), dev) for m in sorted(set(want_lanes))}
    out["dispatch_picks"] = picks
    log(f"replay: the dispatch model's pick by window lanes at bucket "
        f"{E._bucket(max(want_lanes))} (True = RLC): {picks}; the timed pass's windows took "
        f"{[w[1] for w in out['default']['windows']]} [{card}]")
    nw = len(want_lanes)
    for what in ("default_warm", "default"):
        # every window launches the ladder (the whole batch, or RLC's B = 1
        # tail); the warm pass's counts also hold the dispatch model's
        # calibration launches at bucket 65,536
        c, paths = counts[what], [w[1] for w in out[what]["windows"]]
        exact = what == "default"
        if set(paths) - {"rlc", "ladder"} or \
                (c["accum_weight"] != paths.count("rlc") if exact else
                 c["accum_weight"] < paths.count("rlc")) or \
                (c["ladder_sub_mul8"] != nw if exact else c["ladder_sub_mul8"] < nw):
            raise AssertionError(f"replay, {what}: windows {paths}, launches {c}")
    out["ladder"] = batched("ladder", seam=False, need=("decompress", "ladder_sub_mul8"))
    c = counts["ladder"]
    if c["ladder_sub_mul8"] != nw or c["decompress"] < nw or \
            any(w[1] != "ladder" for w in out["ladder"]["windows"]):
        raise AssertionError(f"replay, ladder pinned: windows {out['ladder']['windows']}, "
                             f"launches {c}")
    # the RLC seam pinned: a pass counts once the layout took a window (a
    # declined window goes to the ladder); the pass is run again until then
    for passes in range(1, REPLAY_RLC_TRIES + 1):
        out["rlc"] = batched("rlc", seam=True)
        accepted = sum(1 for w in out["rlc"]["windows"] if w[1] == "rlc")
        if accepted:
            break
        log(f"replay, RLC pinned: the layout declined all {nw} windows (pass {passes})")
    else:
        raise AssertionError(f"replay, RLC pinned: the layout declined every window in "
                             f"{REPLAY_RLC_TRIES} passes")
    c = counts["rlc"]
    out["rlc_passes"] = passes
    out["rlc_declines"] = nw - accepted
    if not c["accum_weight"]:
        raise AssertionError("replay, RLC pinned: accum_weight was never launched")
    for name in ("accum_weight", "region_sum", "window_combine"):
        if c[name] != accepted:
            raise AssertionError(f"replay, RLC pinned: {accepted} windows took RLC, {name} "
                                 f"launched {c[name]} times")
    if c["ladder_sub_mul8"] != nw:  # a B = 1 tail a RLC window, a full ladder a declined one
        raise AssertionError(f"replay, RLC pinned: ladder launches {c['ladder_sub_mul8']}")
    log(f"replay, RLC pinned: {accepted} of {nw} windows took RLC, {nw - accepted} declined "
        f"by the layout (the ladder verified them) [{card}]")

    # full mode: the reference-faithful per-height path (native route a commit)
    (eng, state, stats, wall), routes = counted_leg(counts, "replay", "full",
                                                     lambda: replay("full"))
    check_final("full", state, stats, REPLAY_BLOCKS * n)
    out["full"] = {"wall_s": wall, "blocks_per_s": REPLAY_BLOCKS / wall,
                   "sigs_per_s": stats.sigs_verified / wall, "routes": routes}
    out["batched_over_full"] = out["default"]["blocks_per_s"] / out["full"]["blocks_per_s"]
    log(f"replay, full: {REPLAY_BLOCKS} blocks in {wall:.3f} s -> "
        f"{out['full']['blocks_per_s']:.1f} blocks/s, {out['full']['sigs_per_s']:.0f} sigs/s "
        f"(light checks; routes {routes}); batched default / full = "
        f"{out['batched_over_full']:.2f}x [{card}]")

    # one warm window, profiled: device kernels, busy ms, window ms
    first = [store.load_block(h) for h in range(1, window + 1)]
    eng = engine(store, "batched")
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        eng._light_check_window(genesis, first)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    n_kernels, busy_ms, by_kernel, _ = profile_commit(
        lambda: eng._light_check_window(genesis, first), "profile_replay_window.txt")
    out["window_profile"] = {"lanes": want_lanes[0], "window_ms": float(np.median(walls)),
                             "device_kernels": n_kernels, "busy_ms": busy_ms,
                             "kernels": by_kernel}
    log(f"profile, one warm {want_lanes[0]}-lane window (default dispatch): {n_kernels} device "
        f"kernels ({ {k: v for k, v in by_kernel.items() if v} }), {busy_ms:.3f} ms busy of a "
        f"{out['window_profile']['window_ms']:.3f} ms window (median of 3) [{card}]")

    # the bad chain: one broken signature in height 2's commit
    bad_store, _, bad_genesis, _ = fx.make_chain(
        REPLAY_BAD_BLOCKS, n_validators=n, seed=seed, corrupt_sig=REPLAY_BAD, device=dev)
    bad = {}
    for what, seam in (("default", None), ("ladder", False), ("rlc", True)):
        want = expected_replay_outcome("batched", REPLAY_BAD_BLOCKS, n, power, *REPLAY_BAD,
                                       window)
        prev = E._rlc_beats_ladder
        if seam is not None:
            E._rlc_beats_ladder = lambda n_, b, device: seam
        try:
            for attempt in range(1, 6):
                eng = engine(bad_store, "batched")
                got, _ = counted_leg(counts, "replay", f"bad_{what}", lambda: outcome_of(
                    lambda: eng.run(bad_genesis.copy())))
                applied = eng.executor.app.consensus._app.height
                if got != want[:2] or applied != want[2]:
                    raise AssertionError(f"replay of the bad chain, {what}: {got}, {applied} "
                                         f"blocks applied; want {want}")
                if seam is not True or counts[f"bad_{what}"]["accum_weight"]:
                    break
                log(f"replay, bad chain, RLC pinned: the layout declined (submit {attempt}); "
                    "the ladder named the lane")
            else:
                raise AssertionError("the RLC layout declined the bad window 5 times in a row")
        finally:
            E._rlc_beats_ladder = prev
        if seam is True and counts["bad_rlc"]["ladder_sub_mul8"] < 2:
            raise AssertionError("replay, bad chain, RLC pinned: no blame rerun on the ladder")
        bad[what] = {"outcome": got, "submits": attempt}
    want = expected_replay_outcome("full", REPLAY_BAD_BLOCKS, n, power, *REPLAY_BAD, window)
    eng = engine(bad_store, "full")
    got, _ = counted_leg(counts, "replay", "bad_full",
                         lambda: outcome_of(lambda: eng.run(bad_genesis.copy())))
    applied = eng.executor.app.consensus._app.height
    if got != want[:2] or applied != want[2]:
        raise AssertionError(f"replay of the bad chain, full: {got}, {applied} blocks applied; "
                             f"want {want}")
    bad["full"] = {"outcome": got, "applied": applied}
    out["bad_chain"] = bad
    log(f"replay, bad chain ({REPLAY_BAD_BLOCKS} blocks, height {REPLAY_BAD[0]} index "
        f"{REPLAY_BAD[1]} broken): batched (default, ladder, RLC) -> {bad['default']['outcome']},"
        f" no block applied; full -> {got} after {applied} blocks [{card}]")

    out["counts"] = counts
    out["chain"] = (store, final, genesis)  # phases 8 and 10 read it; not written out
    for name in SOURCES:
        kern[name]["launches_by_route"]["replay"] = sum(c[name] for c in counts.values())
        kern[name]["launches"] += kern[name]["launches_by_route"]["replay"]
    return out


# ---- phase 8: ingest, blocks with the mempool and evidence, the light client

INGEST_CHAIN = "ingest-chain"
INGEST_SENDERS = 1_000
INGEST_TXS = 4_096  # (a)'s signed stream, planted classes included
INGEST_FILL = 1_000  # more signed txs after it, past the mempool's size
MEMPOOL_SIZE = 5_000  # MempoolConfig (size, cache, tx bytes, window, delay)
MEMPOOL_CACHE = 10_000
MAX_TX_BYTES = 1_048_576
ADMISSION_WINDOW = 256
ADMISSION_DELAY_S = 0.002
SCHED_SIGS = 16_384  # SchedConfig (max_coalesce_sigs, max_coalesce_delay_ms)
SCHED_DELAY_MS = 2.0
# stream index of each planted class in (a): a broken signature, a signed
# payload the app rejects (no '=' anywhere in the envelope), an envelope cut
# short (a bare tx to the app, no '='), a copy of an admitted tx, a tx one
# byte over MAX_TX_BYTES, and a second write of tx CONFLICT[0]'s payload key
# (admitted; once a block commits the first, the recheck drops it)
INGEST_PLANTS = {"bad_sig": 777, "app_reject": 1_500, "malformed": 2_000,
                 "duplicate": (3_000, 100), "oversize": 3_500, "conflict": (10, 4_000)}
TENANTS = 16
TENANT_ROUNDS = 2  # of INGEST_TXS each; the mempool holds MEMPOOL_SIZE
TENANT_TRIES = 3  # runs of (b) until a coalesced dispatch takes a device route
BIG_WINDOW = 4_096  # (c): a node that raises admission_window
BIG_TXS = 16_384
BIG_DELAY_S = 1.0  # long enough for one producer to fill a 4,096 window
ADMISSION_CHECK_BAD_LANE = 4_000  # the tampered lane of the checked admission window
BLOCKS_VALIDATORS = 150  # BASELINE.json's Cosmos Hub set
BLOCKS = 8
BLOCK_MAX_BYTES = 88_000  # the 5,000 txs of (a) drain in 8 blocks
EVIDENCE_AT = (2, 5, 3)  # (vote height, validator index, reported after block)
LIGHT_FORK_BLOCKS = 16
LIGHT_FORK_TARGET = 12
LIGHT_NOW_S = 1_700_001_000  # after every header of phase 7's chain


def payload_key(tx: bytes, parse) -> bytes:
    """The key a tx's `key=value` payload writes (an STX envelope's
    payload as `parse` reads it, else the tx)."""
    parsed = parse(tx)
    return (parsed[2] if parsed is not None else tx).partition(b"=")[0]


def once_app(kvstore_cls, check_result_cls, parse=None):
    """A KVStore app whose CheckTx also refuses (code 2) a tx whose payload
    key a committed block already wrote, as an account's nonce would: the
    state a recheck runs against. It keeps the misbehavior FinalizeBlock
    hands it. `parse` reads an STX envelope (the port's
    `mempool.parse_signed_tx` unless given)."""
    if parse is None:
        from cometbft_tpu_torch.mempool import parse_signed_tx as parse

    class Once(kvstore_cls):
        def __init__(self):
            super().__init__()
            self.written: set[bytes] = set()
            self.staged: list[bytes] = []
            self.misbehavior: list = []

        def check_tx(self, tx):
            if payload_key(tx, parse) in self.written:
                return check_result_cls(code=2, log="key already written")
            return super().check_tx(tx)

        def finalize_block(self, req):
            self.staged = [payload_key(tx, parse) for tx in req.txs]
            self.misbehavior.extend(req.misbehavior)
            return super().finalize_block(req)

        def commit(self):
            self.written.update(self.staged)
            return super().commit()

    return Once()


def ingest_payload(tenant: int, sender: int, i: int) -> bytes:
    """A `key=value` payload of 40 B (140 B in its envelope)."""
    return b"t%02d-acct%04d-n%05d=%020x" % (tenant, sender, i, i * 2654435761 % (1 << 64))


def broken_signature(tx: bytes) -> bytes:
    """The STX tx with one bit of its signature's R flipped."""
    return tx[:4 + 32 + 5] + bytes([tx[4 + 32 + 5] ^ 0x01]) + tx[4 + 32 + 6:]


def ingest_stream(signers, tenant: int, n: int, plants: dict, seed: int, device):
    """n signed txs of `tenant`, tx i from signer i % len(signers), with the
    classes of `plants` (keys of INGEST_PLANTS, a subset) put at their
    indices. Returns (txs, the indices of broken signatures)."""
    from cometbft_tpu_torch.utils import factories as fx

    payloads = [ingest_payload(tenant, i % len(signers), i) for i in range(n)]
    if "conflict" in plants:
        first, second = plants["conflict"]
        payloads[second] = payloads[first].partition(b"=")[0] + b"=second-write"
    # candidates for a signed payload the app rejects, all signed in the same batch
    cands = [b"t%02d-noeq-%d" % (tenant, j) for j in range(16)]
    signed = fx.signed_txs([signers[i % len(signers)] for i in range(n)] + [signers[0]] * 16,
                           payloads + cands, seed=seed, device=device)
    txs, bad = signed[:n], set()
    if "bad_sig" in plants:
        i = plants["bad_sig"]
        txs[i] = broken_signature(txs[i])
        bad.add(i)
    if "app_reject" in plants:
        txs[plants["app_reject"]] = next(t for t in signed[n:] if b"=" not in t)
    if "malformed" in plants:
        txs[plants["malformed"]] = b"STX\x01" + b"cut-short-envelope-%d" % tenant
    if "duplicate" in plants:
        at, of = plants["duplicate"]
        txs[at] = txs[of]
    if "oversize" in plants:
        txs[plants["oversize"]] = b"x" * (MAX_TX_BYTES + 1)
    return txs, bad


def expected_ingest_outcome(txs, bad, max_txs: int, max_tx_bytes: int):
    """Each tx's admission outcome, in submit order, by the reference's
    rules with the KVStore app: None (admitted) or (exception class name,
    message). The checks run in the mempool's order: size, the LRU cache
    (a copy of a tx seen and not rejected), a full pool, the signature
    (`bad`: indices of broken STX signatures), the app (a `key=value`
    payload with a key), then the insert. A rejected tx leaves the cache."""
    out, cache, size = [], set(), 0
    for i, tx in enumerate(txs):
        if len(tx) > max_tx_bytes:
            out.append(("ErrTxTooLarge", f"tx {len(tx)}B > {max_tx_bytes}B"))
            continue
        key = hashlib.sha256(tx).digest()
        if key in cache:
            out.append(("ErrTxInCache", f"tx {key.hex()[:12]} already seen"))
            continue
        if size >= max_txs:
            out.append(("ErrMempoolFull", f"mempool full: {size} >= {max_txs}"))
            continue
        if i in bad:
            out.append(("ValueError", "tx rejected: invalid signature"))
            continue
        if b"=" not in tx or tx.startswith(b"="):
            out.append(("ValueError", "tx rejected by app: code 1"))
            continue
        cache.add(key)
        size += 1
        out.append(None)
    return out


def future_outcomes(futures, timeout: float = 600.0) -> list:
    """None for each future that resolved, else (exception class name,
    message)."""
    out = []
    for f in futures:
        exc = f.exception(timeout=timeout)
        out.append(None if exc is None else (type(exc).__name__, str(exc)))
    return out


def check_ingest(what: str, got: list, want: list) -> None:
    if got != want:
        diff = [(i, g, w) for i, (g, w) in enumerate(zip(got, want)) if g != w][:5]
        raise AssertionError(f"ingest, {what}: {sum(g != w for g, w in zip(got, want))} of "
                             f"{len(want)} outcomes differ, first {diff}")


class TraceTap:
    """The spans a leg wrote to the JSONL trace (utils/trace.py): `mark()`
    before the leg, `spans(name)` after it."""

    def __init__(self, path: Path):
        self.path, self.offset = path, 0

    def mark(self) -> None:
        self.offset = self.path.stat().st_size if self.path.exists() else 0

    def spans(self, *names: str) -> list:
        """The records of these names since `mark()`, in the order written."""
        with open(self.path, "rb") as fh:
            fh.seek(self.offset)
            recs = [json.loads(ln) for ln in fh.read().splitlines() if ln.strip()]
        return [r for r in recs if r["name"] in names]


def window_stats(spans) -> dict:
    """The admission windows' sizes and stage milliseconds (min, median,
    max) from `mempool.admit_window` spans."""
    out = {"windows": len(spans)}
    for k in ("n", "sig_ms", "app_ms", "insert_ms", "dur_ms"):
        v = [s[k] for s in spans]
        out[k] = [float(np.min(v)), float(np.median(v)), float(np.max(v))] if v else None
    return out


def dispatch_log(tap) -> list:
    """Each shared-scheduler dispatch since `tap.mark()`, from the trace, as
    (requests, signatures, route, ms): its `crypto.sched_coalesce` span and
    the `crypto.batch_verify` spans written before it (only the
    scheduler's drainer verifies while a leg runs). A RLC dispatch whose
    all-ok was false reruns on the ladder for the bitmap: "rlc+ladder"."""
    out, paths = [], []
    for r in tap.spans("crypto.batch_verify", "crypto.sched_coalesce"):
        if r["name"] == "crypto.batch_verify":
            paths.append(r["path"])
        else:
            out.append((r["n_requests"], r["sigs"], "+".join(paths) or "none", r["dur_ms"]))
            paths = []
    return out


def make_scheduler(dev):
    """The shared VerifyScheduler at SchedConfig's settings."""
    from cometbft_tpu_torch.crypto.sched import VerifyScheduler

    return VerifyScheduler(device=dev, max_coalesce_sigs=SCHED_SIGS,
                           max_coalesce_delay_ms=SCHED_DELAY_MS)


def ingest_node(app, dev, sched=None, tenant: str = INGEST_CHAIN, window=None, delay_s=None):
    """A CListMempool at MempoolConfig's settings with its AdmissionPipeline
    (window and delay ADMISSION_WINDOW and ADMISSION_DELAY_S unless given)."""
    from cometbft_tpu_torch.abci import AppConns
    from cometbft_tpu_torch.mempool import AdmissionPipeline, CListMempool

    window = ADMISSION_WINDOW if window is None else window
    delay_s = ADMISSION_DELAY_S if delay_s is None else delay_s

    mp = CListMempool(AppConns(app), max_txs=MEMPOOL_SIZE, max_tx_bytes=MAX_TX_BYTES,
                      cache_size=MEMPOOL_CACHE)
    mp.attach_pipeline(AdmissionPipeline(mp, window=window, max_delay_s=delay_s, device=dev,
                                         sched=sched, tenant=tenant))
    return mp


def reap_all(mp, height: int) -> list:
    """What a proposer would do between rounds: reap the pool and update
    it with those txs as committed (under the mempool's lock)."""
    mp.lock()
    try:
        txs = mp.reap_max_txs(-1)
        mp.update(height, txs)
    finally:
        mp.unlock()
    return txs


def blocks_leg(mp, signers, dev, kv_cls, check_result_cls, n_blocks: int, chain_id: str,
               block_max_bytes: int, evidence_at, r_pool=None):
    """Blocks from the mempool `mp` (whose app is the node's): each reaped
    with `reap_max_bytes_max_gas` under the state's consensus parameters,
    proposed by `create_proposal_block` with the pool's pending evidence,
    committed by every validator (`make_commit`) and applied by
    `apply_block` with the mempool and an `EvidencePool` attached. After
    block evidence_at[2], validator evidence_at[1] is reported to the pool
    for two signed precommits at height evidence_at[0]. Returns a dict:
    the genesis state, the (block bytes, commit bytes) of each height, the
    final state, the block store, the pool, the app, the evidence and the
    txs and evidence each block carried."""
    from cometbft_tpu_torch.evidence import EvidencePool
    from cometbft_tpu_torch.state.execution import BlockExecutor, make_genesis_state
    from cometbft_tpu_torch.state.types import BlockParams, ConsensusParams
    from cometbft_tpu_torch.storage import BlockStore, MemKV, StateStore
    from cometbft_tpu_torch.types import Commit, Timestamp, Vote
    from cometbft_tpu_torch.types.vote import SignedMsgType
    from cometbft_tpu_torch.utils import factories as fx

    vals = fx.make_validator_set(signers)
    by_addr = {s.address(): s for s in signers}
    genesis = make_genesis_state(chain_id, vals, consensus_params=ConsensusParams(
        block=BlockParams(max_bytes=block_max_bytes)))
    ss, bs = StateStore(MemKV()), BlockStore(MemKV())
    ss.save(genesis)
    pool = EvidencePool(state_store=ss, block_store=bs, chain_id=chain_id)
    ex = BlockExecutor(mp.app, state_store=ss, block_store=bs, device=dev, mempool=mp,
                       evidence_pool=pool)
    state, last_commit, recs, carried, ev = genesis.copy(), Commit(), [], [], None
    for h in range(1, n_blocks + 1):
        params = state.consensus_params.block
        txs = mp.reap_max_bytes_max_gas(params.max_bytes, params.max_gas)
        block = ex.create_proposal_block(h, state, last_commit,
                                         state.validators.get_proposer().address, txs,
                                         block_time=state.last_block_time)
        bid = fx.block_id_for(block)
        vals_h = state.validators
        state = ex.apply_block(state, bid, block)
        commit = fx.make_commit(chain_id, h, 0, bid, vals_h, by_addr,
                                time_ns=state.last_block_time.unix_ns() + 1_000_000_000,
                                device=dev, r_pool=r_pool)
        bs.save_block(block, commit)
        recs.append((block.encode(), commit.encode()))
        carried.append((len(block.data.txs), len(block.evidence)))
        last_commit = commit
        if h == evidence_at[2]:
            vh, vi, _ = evidence_at
            val = vals.validators[vi]
            votes = []
            for tag in (b"one", b"two"):
                v = Vote(type=SignedMsgType.PRECOMMIT, height=vh, round=0,
                         block_id=fx.make_block_id(tag), timestamp=Timestamp(9, 0),
                         validator_address=val.address, validator_index=vi)
                fx.sign_vote(by_addr[val.address], v, chain_id)
                votes.append(v)
            pool.report_conflicting_votes(*votes)
        if ev is None and block.evidence:
            ev = block.evidence[0]
    return {"genesis": genesis, "blocks": recs, "final": state, "store": bs, "pool": pool,
            "app": ex.app.consensus._app, "evidence": ev, "carried": carried}


def expected_blocks_state(genesis_bytes: bytes, blocks: list, app, chain_id: str) -> bytes:
    """The state bytes after applying the recorded (block bytes, commit
    bytes) from genesis through a fresh executor on the host (device
    "cpu": the native route, or the kernels' plain versions) with `app`
    and an evidence pool that checks each block's evidence."""
    from cometbft_tpu_torch.abci import AppConns
    from cometbft_tpu_torch.evidence import EvidencePool
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.state.types import State
    from cometbft_tpu_torch.storage import MemKV, StateStore
    from cometbft_tpu_torch.types import Block
    from cometbft_tpu_torch.utils import factories as fx

    state = State.decode(genesis_bytes)
    ss = StateStore(MemKV())
    ss.save(state)
    ex = BlockExecutor(AppConns(app), state_store=ss, device="cpu",
                       evidence_pool=EvidencePool(state_store=ss, chain_id=chain_id))
    for block_bytes, _ in blocks:
        block = Block.decode(block_bytes)
        state = ex.apply_block(state, fx.block_id_for(block), block)
    return state.encode()


def expected_light_outcome(target: int, fork_target: int, addresses: list, common: int = 1):
    """What phase 8's light-client leg sees, by the reference's rules, on a
    chain of one constant validator set: initialize at `common`, skip to
    `target` in one step (the whole trusted set signed it) and store
    {common, target}, the agreeing witness agrees. Against a witness
    whose fork the same validators signed: verifying to `fork_target`
    raises ErrConflictingHeaders from witness 0, with evidence rooted at
    `common` naming every validator, and the witness is handed evidence
    for its own block and for the primary's."""
    return {
        "heights": [common, target],
        "error": ("ErrConflictingHeaders",
                  f"witness 0 disagrees at height {fork_target} — light-client attack"),
        "common_height": common,
        "byzantine": sorted(addresses),
        "reported_heights": [fork_target, fork_target],
    }


def ingest_phase(dev, card, seed: int, kern: dict, chain, mul_rate: float) -> dict:
    """Phase 8: signed ingest through the mempool and the admission pipeline
    on the shared scheduler, blocks with the mempool and an evidence pool,
    and the light client on phase 7's chain. `chain` is phase 7's
    (store, final state). Returns the `ingest` results (launch counts by
    leg under "counts")."""
    from cometbft_tpu_torch.abci import KVStoreApp
    from cometbft_tpu_torch.abci.types import CheckTxResult
    from cometbft_tpu_torch.utils import factories as fx
    from cometbft_tpu_torch.utils import trace

    out, counts = {"card": card}, {}
    t_phase = time.perf_counter()
    tap = TraceTap(OUT_DIR / "trace_ingest.jsonl")
    if tap.path.exists():
        tap.path.unlink()
    trace.configure(str(tap.path))
    try:
        # the senders and (a)'s stream, signed on the card (fe_mul, fe_sq)
        def sign():
            s = fx.make_signers(INGEST_SENDERS, seed=seed + 7, device=dev)
            return s, ingest_stream(s, 0, INGEST_TXS + INGEST_FILL, INGEST_PLANTS, seed + 1, dev)

        t0 = time.perf_counter()
        (senders, (txs_a, bad_a)), _ = counted_leg(counts, "ingest", "sign", sign,
                                                   need=("fe_mul", "fe_sq"))
        out["sign_s"] = time.perf_counter() - t0
        log(f"ingest: {INGEST_SENDERS} senders and {len(txs_a)} signed txs made on {dev} in "
            f"{out['sign_s']:.2f} s [{card}]")

        # (a) one node at MempoolConfig's defaults, on the shared scheduler
        want = expected_ingest_outcome(txs_a, bad_a, MEMPOOL_SIZE, MAX_TX_BYTES)
        app_a = once_app(KVStoreApp, CheckTxResult)
        sched = make_scheduler(dev)
        mp = ingest_node(app_a, dev, sched=sched)
        tap.mark()

        def run_a():
            t = time.perf_counter()
            got = future_outcomes([mp.submit_tx(tx) for tx in txs_a])
            return got, time.perf_counter() - t

        (got, wall), routes = counted_leg(counts, "ingest", "one_node", run_a)
        check_ingest("one node", got, want)
        classes = {}
        for o in got:
            classes[o[0] if o else "admitted"] = classes.get(o[0] if o else "admitted", 0) + 1
        if mp.size() != MEMPOOL_SIZE or set(classes) != {
                "admitted", "ErrTxTooLarge", "ErrTxInCache", "ErrMempoolFull", "ValueError"}:
            raise AssertionError(f"ingest, one node: pool {mp.size()}, outcomes {classes}")
        out["one_node"] = {"txs": len(txs_a), "outcomes": classes, "wall_s": wall,
                           "admitted_per_s": classes["admitted"] / wall, "routes": routes,
                           "dispatches": dispatch_log(tap), "windows":
                           window_stats(tap.spans("mempool.admit_window"))}
        sched.close()
        log(f"ingest, (a) one node: {len(txs_a)} txs in {wall:.3f} s, outcomes {classes} (each "
            f"as expected_ingest_outcome), {out['one_node']['admitted_per_s']:.0f} admitted/s; "
            f"routes {routes}; windows {out['one_node']['windows']} [{card}]")

        # (b) sixteen tenants on one scheduler, two rounds each
        t0 = time.perf_counter()
        streams = []
        for t in range(TENANTS):
            txs_t, bad_t = ingest_stream(senders, t + 1, TENANT_ROUNDS * INGEST_TXS,
                                         {"bad_sig": (97 * t + 13) % INGEST_TXS}, seed + 2 + t,
                                         dev)
            streams.append([(txs_t[r * INGEST_TXS:(r + 1) * INGEST_TXS],
                             {i - r * INGEST_TXS for i in bad_t
                              if r * INGEST_TXS <= i < (r + 1) * INGEST_TXS})
                            for r in range(TENANT_ROUNDS)])
        log(f"ingest, (b): {TENANTS} x {TENANT_ROUNDS * INGEST_TXS} signed txs made in "
            f"{time.perf_counter() - t0:.2f} s")
        for attempt in range(1, TENANT_TRIES + 1):
            res = tenants_leg(dev, streams, counts, f"tenants_{attempt}", tap)
            device = [d for d in res["dispatches"]
                      if d[0] > 1 and d[2].split("+")[0] in ("ladder", "rlc")]
            if device:
                break
            log(f"ingest, (b) run {attempt}: no coalesced dispatch took a device route "
                f"(dispatches {res['dispatches'][:8]} ...); running it again")
        else:
            raise AssertionError(f"ingest, (b): no coalesced dispatch took a device route in "
                                 f"{TENANT_TRIES} runs")
        res["runs"] = attempt
        out["tenants"] = res
        log(f"ingest, (b) {TENANTS} tenants: {res['admitted']} admitted in {res['wall_s']:.3f} s "
            f"-> {res['admitted_per_s']:.0f} txs/s in total, per tenant "
            f"{[round(x) for x in res['tenant_admitted_per_s']]}; {res['n_dispatches']} "
            f"dispatches ({res['dispatches_per_1k_sigs']:.3f} per 1,000 signatures), coalesced "
            f"batch sigs {res['coalesced_sigs']}, routes {res['routes']}, {len(device)} "
            f"coalesced dispatches on a device route; dispatch time by route "
            f"{res['dispatch_by_route']}; windows {res['windows']} [{card}]")

        # (c) one node at admission_window 4,096: every full window on a device route
        out["big_window"] = big_window_leg(dev, senders, seed, counts, tap, card, mul_rate)

        # (d) blocks from (a)'s mempool with an evidence pool
        out["blocks"] = blocks_phase(mp, dev, seed, counts, card, txs_a)

        # (e) the light client on phase 7's chain
        out["light"] = light_phase(dev, seed, counts, card, chain)
        # (a)'s stream for phase 11's gossip leg (popped before results.json)
        out["stream"] = (txs_a[:INGEST_TXS], {i for i in bad_a if i < INGEST_TXS})
    finally:
        trace.disable()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"ingest: phase 8 took {out['seconds']:.1f} s [{card}]")
    out["counts"] = counts
    for name in SOURCES:
        kern[name]["launches_by_route"]["ingest"] = sum(c[name] for c in counts.values())
        kern[name]["launches"] += kern[name]["launches_by_route"]["ingest"]
    return out


def tenants_leg(dev, streams, counts, leg: str, tap) -> dict:
    """(b): one node a tenant (its own chain id, app, mempool and pipeline
    at window 256) on one shared scheduler, one producer thread each; each
    round's outcomes must be expected_ingest_outcome's (a tenant's broken
    signature comes back to that tenant only)."""
    import threading

    from cometbft_tpu_torch.abci import KVStoreApp
    from cometbft_tpu_torch.abci.types import CheckTxResult

    sched = make_scheduler(dev)
    nodes = [ingest_node(once_app(KVStoreApp, CheckTxResult), dev, sched=sched,
                         tenant=f"tenant-{t:02d}") for t in range(len(streams))]
    got = [[] for _ in streams]
    walls = [0.0] * len(streams)
    errors = []

    def producer(t):
        try:
            for r, (txs, _) in enumerate(streams[t]):
                t0 = time.perf_counter()
                got[t].append(future_outcomes([nodes[t].submit_tx(tx) for tx in txs]))
                walls[t] += time.perf_counter() - t0
                reap_all(nodes[t], r + 1)
        except Exception as e:  # noqa: BLE001 — raised by the leg below
            errors.append((t, e))

    def run():
        threads = [threading.Thread(target=producer, args=(t,)) for t in range(len(streams))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        return time.perf_counter() - t0

    tap.mark()
    try:
        wall, routes = counted_leg(counts, "ingest", leg, run)
    finally:
        sched.close()
        for m in nodes:
            m.close()
    if errors:
        raise AssertionError(f"ingest, (b): producer failures {errors[:3]}")
    admitted = []
    for t, rounds in enumerate(streams):
        n_ok = 0
        for r, (txs, bad) in enumerate(rounds):
            check_ingest(f"tenant {t} round {r}", got[t][r],
                         expected_ingest_outcome(txs, bad, MEMPOOL_SIZE, MAX_TX_BYTES))
            n_ok += sum(o is None for o in got[t][r])
        admitted.append(n_ok)
    disp = dispatch_log(tap)
    sigs = sum(d[1] for d in disp)
    by_route = {}
    for _, n, route, ms in disp:
        c = by_route.setdefault(route, {"dispatches": 0, "sigs": 0, "ms": 0.0})
        c["dispatches"], c["sigs"], c["ms"] = c["dispatches"] + 1, c["sigs"] + n, c["ms"] + ms
    return {"dispatch_by_route": by_route, "wall_s": wall, "admitted": sum(admitted), "admitted_per_s": sum(admitted) / wall,
            "tenant_admitted_per_s": [a / w for a, w in zip(admitted, walls)],
            "n_dispatches": len(disp), "dispatches_per_1k_sigs": len(disp) * 1e3 / sigs,
            "coalesced_sigs": sorted({d[1] for d in disp if d[0] > 1})[-8:],
            "coalesced_dispatches": sum(d[0] > 1 for d in disp),
            "routes": routes, "dispatches": disp,
            "windows": window_stats(tap.spans("mempool.admit_window"))}


def admission_window_check(dev, card, txs, mul_rate: float) -> dict:
    """`batch_window_check` on one admission window of BIG_WINDOW STX txs
    (bucket 4,096), laid out by an AdmissionPipeline itself: a node whose
    scheduler seam keeps the window's batch verifier and verifies
    nothing. Lane ADMISSION_CHECK_BAD_LANE is the tampered one."""
    from cometbft_tpu_torch.abci import KVStoreApp
    from cometbft_tpu_torch.abci.types import CheckTxResult

    keep = SubmitTimer(keep=True)
    mp = ingest_node(once_app(KVStoreApp, CheckTxResult), dev, sched=keep, window=BIG_WINDOW,
                     delay_s=BIG_DELAY_S)
    try:
        future_outcomes([mp.submit_tx(tx) for tx in txs])
    finally:
        mp.close()
    if keep.kept is None or keep.kept.count() != len(txs):
        raise AssertionError(f"admission window check: the window kept holds "
                             f"{keep.kept.count() if keep.kept else 0} lanes, want {len(txs)}")
    return batch_window_check(dev, card, keep.kept, "admission window",
                              ADMISSION_CHECK_BAD_LANE, mul_rate)


def big_window_leg(dev, senders, seed: int, counts, tap, card, mul_rate: float) -> dict:
    """(c): one node at admission_window 4,096 (no scheduler), BIG_TXS txs
    in rounds of 4,096 with a reap and update between them; each round is
    one full window, which must take a device route. Round 0 is clean: one
    dispatch, on the ladder or on RLC with its all-ok true. Each later
    round has one broken signature: on RLC, the all-ok is false and the
    window reruns on the ladder for the blame. First, the kernels at round
    0's window shapes (`admission_window_check`)."""
    from cometbft_tpu_torch.abci import KVStoreApp
    from cometbft_tpu_torch.abci.types import CheckTxResult

    rounds = BIG_TXS // BIG_WINDOW
    txs, _ = ingest_stream(senders, 99, BIG_TXS, {}, seed + 40, dev)
    t0 = time.perf_counter()
    check = admission_window_check(dev, card, txs[:BIG_WINDOW], mul_rate)
    check["seconds"] = time.perf_counter() - t0
    log(f"admission window check: {check['seconds']:.2f} s")
    mp = ingest_node(once_app(KVStoreApp, CheckTxResult), dev, window=BIG_WINDOW,
                     delay_s=BIG_DELAY_S)
    per_round, t_all = [], 0.0
    tap.mark()
    try:
        for r in range(rounds):
            part = txs[r * BIG_WINDOW:(r + 1) * BIG_WINDOW]
            bad_r = {(1_234 + 77 * r) % BIG_WINDOW} if r else set()
            for i in bad_r:
                part[i] = broken_signature(part[i])

            def run():
                t = time.perf_counter()
                res = future_outcomes([mp.submit_tx(tx) for tx in part])
                return res, time.perf_counter() - t

            (got, wall), routes = counted_leg(counts, "ingest", f"big_window_{r}", run,
                                              need=("decompress", "ladder_sub_mul8"))
            check_ingest(f"(c) round {r}", got,
                         expected_ingest_outcome(part, bad_r, MEMPOOL_SIZE, MAX_TX_BYTES))
            # a RLC window whose all-ok is false reruns on the ladder for its
            # bitmap (the blame), which counts as a ladder dispatch
            want = ({"ladder": 1.0}, {"rlc": 1.0, "ladder": 1.0}) if bad_r else (
                {"ladder": 1.0}, {"rlc": 1.0})
            if routes not in want:
                raise AssertionError(f"ingest, (c) round {r} ({len(bad_r)} broken signatures): "
                                     f"routes {routes}, want one of {want}")
            if "rlc" in routes and not all(counts[f"big_window_{r}"][k] for k in (
                    "accum_weight", "region_sum", "window_combine")):
                raise AssertionError(f"ingest, (c) round {r} on RLC: launches "
                                     f"{counts[f'big_window_{r}']}")
            per_round.append({"routes": routes, "wall_s": wall,
                              "admitted": sum(o is None for o in got)})
            t_all += wall
            reap_all(mp, r + 1)
    finally:
        mp.close()
    spans = tap.spans("mempool.admit_window")
    if [s["n"] for s in spans] != [BIG_WINDOW] * rounds:
        raise AssertionError(f"ingest, (c): windows {[s['n'] for s in spans]}, want {rounds} "
                             f"of {BIG_WINDOW}")
    res = {"window_check": check, "rounds": per_round,
           "admitted_per_s": sum(p["admitted"] for p in per_round) / t_all,
           "windows": window_stats(spans)}
    log(f"ingest, (c) window {BIG_WINDOW}: {BIG_TXS} txs in {rounds} full windows, routes "
        f"{[p['routes'] for p in per_round]} (round 0 clean), {res['admitted_per_s']:.0f} "
        f"admitted/s; windows "
        f"{res['windows']} [{card}]")
    return res


def blocks_phase(mp, dev, seed: int, counts, card, txs_a) -> dict:
    """(d): BLOCKS blocks of a 150-validator chain from (a)'s mempool with
    an evidence pool; the checks of the module docstring's phase 8 (d)."""
    from cometbft_tpu_torch.abci import KVStoreApp
    from cometbft_tpu_torch.abci.types import CheckTxResult
    from cometbft_tpu_torch.mempool.mempool import ErrTxInCache
    from cometbft_tpu_torch.types import Block
    from cometbft_tpu_torch.utils import factories as fx

    mp.pipeline.close()  # (a)'s scheduler is closed: the node admits directly from here on
    mp.attach_pipeline(None)
    pool_before = mp.reap_max_txs(-1)
    t0 = time.perf_counter()
    d, routes = counted_leg(counts, "ingest", "blocks", lambda: blocks_leg(
        mp, fx.make_signers(BLOCKS_VALIDATORS, seed=seed + 50, device=dev), dev, KVStoreApp,
        CheckTxResult, BLOCKS, INGEST_CHAIN, BLOCK_MAX_BYTES, EVIDENCE_AT,
        r_pool=fx.RPool(BLOCKS_VALIDATORS, BLOCKS, device=dev)), need=("fe_mul", "fe_sq"))
    wall = time.perf_counter() - t0
    committed = [tx for blk, _ in d["blocks"] for tx in Block.decode(blk).data.txs]
    second = INGEST_PLANTS["conflict"][1]
    dropped = [tx for tx in pool_before if tx not in set(committed) and tx not in
               set(mp.reap_max_txs(-1))]
    # the committed txs left the pool and stay in the cache
    again = outcome_of(lambda: mp.check_tx(committed[0]))
    checks = {
        "committed_left_pool": not set(committed) & set(mp.reap_max_txs(-1)),
        "readmit_refused": again is not None and again[0] == ErrTxInCache.__name__,
        "recheck_dropped_second_write": dropped == [txs_a[second]],
        "evidence_carried": [e for _, e in d["carried"]] == [
            1 if h == EVIDENCE_AT[2] + 2 else 0 for h in range(1, BLOCKS + 1)],
        "evidence_pending_after": d["pool"].size() == 0 and not d["pool"].pending_evidence(),
        "app_saw_misbehavior": [(m.type, m.validator_address, m.height)
                                for m in d["app"].misbehavior] == [
            (1, d["evidence"].address(), EVIDENCE_AT[0])] if d["evidence"] else False,
    }
    h_ev = EVIDENCE_AT[2] + 2
    stored = d["store"].load_block(h_ev)
    checks["evidence_block_round_trips"] = (
        stored is not None and stored.encode() == d["blocks"][h_ev - 1][0]
        and stored.hash() == Block.decode(d["blocks"][h_ev - 1][0]).hash()
        and [e.hash() for e in stored.evidence] == [d["evidence"].hash()])
    t1 = time.perf_counter()
    want_state = expected_blocks_state(d["genesis"].encode(), d["blocks"],
                                       once_app(KVStoreApp, CheckTxResult), INGEST_CHAIN)
    checks["final_state_bytes"] = d["final"].encode() == want_state
    expect_s = time.perf_counter() - t1
    if not all(checks.values()):
        raise AssertionError(f"ingest, (d) blocks: checks {checks}; carried {d['carried']}")
    res = {"wall_s": wall, "carried": d["carried"], "routes": routes, "checks": checks,
           "expected_state_s": expect_s, "pool_after": mp.size()}
    log(f"ingest, (d) {BLOCKS} blocks x {BLOCKS_VALIDATORS} validators from (a)'s pool in "
        f"{wall:.3f} s: (txs, evidence) a block {d['carried']}, routes {routes}; checks "
        f"{sorted(checks)} all hold; the host re-application took {expect_s:.3f} s [{card}]")
    return res


def light_phase(dev, seed: int, counts, card, chain) -> dict:
    """(e): LightClient on phase 7's chain behind a StoreProvider; skip to
    its tip with an agreeing witness, then against a witness on a forked
    chain (the same seed, other txs) raise ErrConflictingHeaders with the
    attack evidence."""
    from cometbft_tpu_torch.light import LightClient, LightStore, StoreProvider
    from cometbft_tpu_torch.state.types import encode_validator_set
    from cometbft_tpu_torch.storage import MemKV, StateStore, statestore
    from cometbft_tpu_torch.types import Timestamp
    from cometbft_tpu_torch.types.evidence import decode_evidence
    from cometbft_tpu_torch.utils import factories as fx

    store, final = chain[:2]
    now = Timestamp.from_unix_ns(LIGHT_NOW_S * 10**9)
    tip = store.height()

    def provider(st, vals, n):
        ss = StateStore(MemKV())
        enc = encode_validator_set(vals)
        ss._db.write_batch([(statestore._key_vals(h), enc) for h in range(1, n + 1)])
        return StoreProvider(REPLAY_CHAIN, st, ss)

    primary = provider(store, final.validators, tip)
    anchor = primary.light_block(1).signed_header.header.hash()
    res = {}
    client = LightClient(REPLAY_CHAIN, primary, witnesses=[provider(store, final.validators, tip)],
                         store=LightStore(), device=dev)
    t = time.perf_counter()
    (_, routes) = counted_leg(counts, "ingest", "light_init", lambda: client.initialize(1, anchor))
    (lb, routes) = counted_leg(counts, "ingest", "light_skip",
                               lambda: client.verify_to_height(tip, now))
    res["skip"] = {"wall_s": time.perf_counter() - t, "routes": routes,
                   "heights": client.store.heights(), "witnesses": len(client.witnesses)}
    want = expected_light_outcome(tip, LIGHT_FORK_TARGET,
                                  [v.address for v in final.validators.validators])
    if lb.height != tip or client.store.heights() != want["heights"] or len(client.witnesses) != 1:
        raise AssertionError(f"light, skip: {res['skip']}, want heights {want['heights']}")

    t = time.perf_counter()
    (fork, _, _, _), _ = counted_leg(counts, "ingest", "light_fork", lambda: fx.make_chain(
        LIGHT_FORK_BLOCKS, n_validators=len(final.validators), chain_id=REPLAY_CHAIN,
        txs_per_block=3, seed=seed, device=dev,
        r_pool=fx.RPool(len(final.validators), LIGHT_FORK_BLOCKS, device=dev)),
        need=("fe_mul", "fe_sq"))
    res["fork_make_s"] = time.perf_counter() - t
    witness = provider(fork, final.validators, LIGHT_FORK_BLOCKS)
    received = []
    witness.report_evidence = received.append
    client2 = LightClient(REPLAY_CHAIN, primary, witnesses=[witness], store=LightStore(),
                          device=dev)
    client2.initialize(1, anchor)
    t = time.perf_counter()
    caught = {}

    def fork_verify():
        try:
            client2.verify_to_height(LIGHT_FORK_TARGET, now)
        except Exception as e:  # noqa: BLE001 — checked below
            caught["e"] = e
            return type(e).__name__, str(e)
        return None

    got, routes = counted_leg(counts, "ingest", "light_conflict", fork_verify)
    ev = getattr(caught.get("e"), "evidence", None)
    res["conflict"] = {"wall_s": time.perf_counter() - t, "routes": routes, "error": got}
    primary_hash = primary.light_block(LIGHT_FORK_TARGET).signed_header.header.hash()
    fork_hash = witness.light_block(LIGHT_FORK_TARGET).signed_header.header.hash()
    checks = {
        "error": got == want["error"],
        "common_height": ev is not None and ev.common_height == want["common_height"],
        "byzantine": ev is not None and sorted(ev.byzantine_validators) == want["byzantine"],
        "conflicting_block": ev is not None and
        ev.conflicting_block.signed_header.header.hash() == fork_hash,
        "evidence_round_trips": ev is not None and decode_evidence(ev.wrapped()).hash() == ev.hash(),
        "reported": [e.conflicting_block.height for e in received] == want["reported_heights"],
        "primary_direction": any(e.conflicting_block.signed_header.header.hash() == primary_hash
                                 for e in received),
    }
    res["conflict"]["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"light, fork: {res['conflict']}")
    log(f"light: initialize(1) and skip to {tip} at {len(final.validators)} validators in "
        f"{res['skip']['wall_s']:.3f} s (routes {res['skip']['routes']}, stored heights "
        f"{res['skip']['heights']}); forked witness ({LIGHT_FORK_BLOCKS} blocks made in "
        f"{res['fork_make_s']:.2f} s): {got[0]} at {LIGHT_FORK_TARGET} in "
        f"{res['conflict']['wall_s']:.3f} s (routes {routes}), evidence names "
        f"{len(ev.byzantine_validators)} signers, both directions reported [{card}]")
    return res


# ---- phase 9: in-process consensus

NET_NODES = 4  # the reference's InProcessNetwork harness
NET_TXS = 256
NET_HEIGHT = 6
NET_TIMEOUT_S = 120.0
LOCKSTEP_CHAIN = "lockstep-chain"
LOCKSTEP_VALIDATORS = 150  # BASELINE.json's Cosmos Hub set
LOCKSTEP_HEIGHTS = 3  # heights 1-3: the tampered proposal at 3 is the last
LOCKSTEP_TXS = 256  # kvstore txs a height, ~100 B each, the same on every node
LOCKSTEP_TX_BYTES = 100
LOCKSTEP_POWER = 10
LOCKSTEP_BAD = (3, 77)  # (height, last-commit index) of the tampered round-0 proposal
LOCKSTEP_ROUND_NS = 10_000_000  # now_ns: T0 + height x 1 s + round x 10 ms
LOCKSTEP_MAX_FIRINGS = 64  # timeout firings before the network counts as stalled
# what a lockstep run gives byte for byte on any device and in either package
LOCKSTEP_OUTCOME_KEYS = ("block_hashes", "rounds", "app_hashes", "seen_commits", "state",
                         "wal", "proposers", "nil_prevotes", "tamper_check")


def consensus_modules(package: str = "cometbft_tpu_torch"):
    """The modules a lockstep network is built from, of the port by
    default; the tests pass the reference's package name to drive it
    through the same function."""
    import importlib
    from types import SimpleNamespace

    names = {"ed": "crypto.ed25519", "types": "types", "block": "types.block",
             "proposal": "types.proposal", "execution": "state.execution",
             "storage": "storage", "client": "abci.client", "kvstore": "abci.kvstore",
             "file_pv": "privval.file_pv", "wal": "consensus.wal", "ticker": "consensus.ticker",
             "state": "consensus.state"}
    return SimpleNamespace(**{k: importlib.import_module(f"{package}.{v}")
                              for k, v in names.items()})


def lockstep_txs(height: int, n: int = LOCKSTEP_TXS) -> list[bytes]:
    """The fixed kvstore `key=value` txs of `height`, LOCKSTEP_TX_BYTES each."""
    out = []
    for i in range(n):
        key = b"h%d-k%04d=" % (height, i)
        out.append(key + b"v" * (LOCKSTEP_TX_BYTES - len(key)))
    return out


def lockstep_consensus(m, n_vals: int, heights: int, home, exec_kw: dict,
                       bad=LOCKSTEP_BAD, seed: int = 0, n_txs: int = LOCKSTEP_TXS) -> dict:
    """A lockstep network: `n_vals` ConsensusStates of the package `m`
    (`consensus_modules`) driven from this thread with no timers, each
    with its own KVStore app, stores, WAL and FilePV (from a seed-made
    Ed25519PrivKey), its executor made with `exec_kw` ({"device": ...} for
    the port, {"backend": ...} for the reference). Tickers are
    ManualTickers; `now_ns` is T0 (the genesis time) + height x 1 s +
    round x 10 ms of the node; no speculation; every height proposes
    `lockstep_txs(height)`. Messages go out in a fixed order: each node in
    turn processes what its inbox holds, until every inbox is empty; then
    each node's pending timeout (the newest schedule since its last
    firing, as TimeoutTicker keeps it) fires. At bad = (height, index),
    round 0, the proposer's block reaches the others with its last
    commit's signature at `index` flipped (`last_commit_hash` recomputed,
    the proposal re-signed with the proposer's key outside its FilePV), and
    that block is validated once more against a non-proposer's state
    (`tamper_check`). Runs until every node committed `heights`; returns
    the outcome (LOCKSTEP_OUTCOME_KEYS, each node's equal where it must
    be), the wall seconds at which the last node committed each height
    (`height_s`; `seconds` is the last of them) and the seconds spent
    collecting the outcome after (`collect_s`)."""
    import dataclasses
    import functools

    os.makedirs(home, exist_ok=True)
    rng = np.random.default_rng(seed)
    privs = [m.ed.Ed25519PrivKey(bytes(r))
             for r in rng.integers(0, 256, (n_vals, 32), dtype=np.uint8)]
    vals = m.types.ValidatorSet([m.types.Validator.from_pub_key(p.pub_key(), LOCKSTEP_POWER)
                                 for p in privs])
    index_of = {v.address: i for i, v in enumerate(vals.validators)}
    genesis = m.execution.make_genesis_state(LOCKSTEP_CHAIN, vals)
    t0_ns = genesis.last_block_time.unix_ns()
    votes, held, out = {}, {}, {"tamper_check": None, "proposers": {}}
    css = []

    def deliver(i, msg):
        for j, cs in enumerate(css):
            if j != i:
                cs.send(msg, f"node{i}")

    def tamper(prop, bb, priv):
        blk = m.block.Block.decode(bb.block_bytes)
        lc, idx = blk.last_commit, bad[1]
        sigs = list(lc.signatures)
        c = sigs[idx]
        sigs[idx] = m.block.CommitSig(c.block_id_flag, c.validator_address, c.timestamp,
                                      bytes([c.signature[0] ^ 1]) + c.signature[1:])
        commit = m.block.Commit(lc.height, lc.round, lc.block_id, sigs)
        blk = m.block.Block(header=dataclasses.replace(blk.header,
                                                       last_commit_hash=commit.hash()),
                            data=blk.data, evidence=blk.evidence, last_commit=commit)
        p = m.proposal.Proposal(height=prop.height, round=prop.round, pol_round=prop.pol_round,
                                block_id=m.block.block_id_for(blk), timestamp=prop.timestamp)
        p.signature = priv.sign(p.sign_bytes(LOCKSTEP_CHAIN))
        return p, m.wal.BlockBytesMessage(bb.height, bb.round, blk.encode()), blk

    def broadcast(i, msg):
        if isinstance(msg, m.state.VoteMessage):
            v = msg.vote
            votes[(v.height, v.round, int(v.type), v.validator_index)] = v.is_nil()
        elif isinstance(msg, m.state.ProposalMessage):
            p = msg.proposal
            out["proposers"][f"{p.height}/{p.round}"] = index_of[privs[i].pub_key().address()]
            if bad is not None and (p.height, p.round) == (bad[0], 0):
                held[i] = p
                return
        elif isinstance(msg, m.wal.BlockBytesMessage) and i in held:
            p, bb, blk = tamper(held.pop(i), msg, privs[i])
            other = css[(i + 1) % len(css)]
            out["tamper_check"] = outcome_of(
                lambda: m.execution.validate_block(other.sm_state, blk, **exec_kw))
            deliver(i, m.state.ProposalMessage(p))
            deliver(i, bb)
            return
        deliver(i, msg)

    for i, priv in enumerate(privs):
        store = m.storage.BlockStore(m.storage.MemKV())
        ex = m.execution.BlockExecutor(
            m.client.AppConns(m.kvstore.KVStoreApp()),
            state_store=m.storage.StateStore(m.storage.MemKV()), block_store=store, **exec_kw)
        box = []
        cs = m.state.ConsensusState(
            chain_id=LOCKSTEP_CHAIN, sm_state=genesis.copy(), executor=ex, block_store=store,
            privval=m.file_pv.FilePV(priv, None, os.path.join(home, f"pv{i}.state.json")),
            wal=m.wal.WAL(os.path.join(home, f"wal{i}")),
            broadcast=functools.partial(broadcast, i),
            tx_source=lambda box=box: lockstep_txs(box[0].height, n_txs), name=f"node{i}",
            now_ns=lambda box=box: (t0_ns + box[0].height * 1_000_000_000
                                    + box[0].round * LOCKSTEP_ROUND_NS),
            ticker_factory=m.ticker.ManualTicker, speculative=False)
        box.append(cs)
        css.append(cs)

    def pump():
        moved = True
        while moved:
            moved = False
            for cs in css:
                for _ in range(cs.inbox.qsize()):
                    cs._process(cs.inbox.get_nowait())
                    moved = True

    fired = [0] * len(css)

    def fire_timeouts() -> bool:
        any_fired = False
        for k, cs in enumerate(css):
            sched = cs.ticker.scheduled[fired[k]:]
            if not sched:
                continue
            pending = sched[0]
            for ti in sched[1:]:
                if (pending.height, pending.round, pending.step) <= (ti.height, ti.round,
                                                                      ti.step):
                    pending = ti
            fired[k] = len(cs.ticker.scheduled)
            cs._on_ticker_timeout(pending)
            any_fired = True
        return any_fired

    t_start = time.perf_counter()
    committed, height_s = 0, []
    for cs in css:
        cs._schedule_round0_start()
    for _ in range(LOCKSTEP_MAX_FIRINGS):
        pump()
        low = min(cs.sm_state.last_block_height for cs in css)
        while committed < low:
            committed += 1
            height_s.append(time.perf_counter() - t_start)
        if low >= heights:
            break
        if not fire_timeouts():
            raise AssertionError(f"lockstep network stalled at height {low + 1}")
    else:
        raise AssertionError(f"lockstep network did not reach height {heights}")
    for cs in css:
        cs.wal.close()

    stores = [cs.block_store for cs in css]
    for h in range(1, heights + 1):
        if len({cs.decided[h].key() for cs in css}) != 1:
            raise AssertionError(f"lockstep: the nodes decided different blocks at height {h}")
    states = {cs.sm_state.encode() for cs in css}
    if len(states) != 1:
        raise AssertionError("lockstep: the nodes' final states differ")

    def app_hash_after(store, h):
        blk = store.load_block(h + 1)
        return (blk.header.app_hash if blk is not None else css[0].sm_state.app_hash).hex()

    app_hashes = [{app_hash_after(s, h) for s in stores} for h in range(1, heights + 1)]
    if any(len(a) != 1 for a in app_hashes):
        raise AssertionError(f"lockstep: app hashes differ between nodes: {app_hashes}")
    wal_digest = hashlib.sha256()
    for i in range(len(css)):
        wal = m.wal.WAL(os.path.join(home, f"wal{i}"))
        for tm in wal.read_all():
            wal_digest.update(m.wal._encode_msg(tm.msg))
        wal.close()
    bad_h = bad[0] if bad is not None else None
    out.update(
        block_hashes=[stores[0].load_block(h).hash().hex() for h in range(1, heights + 1)],
        rounds=[stores[0].load_seen_commit(h).round for h in range(1, heights + 1)],
        app_hashes=[a.pop() for a in app_hashes],
        seen_commits=[hashlib.sha256(b"".join(s.load_seen_commit(h).encode()
                                              for s in stores)).hexdigest()
                      for h in range(1, heights + 1)],
        state=hashlib.sha256(states.pop()).hexdigest(),
        wal=wal_digest.hexdigest(),
        nil_prevotes=sorted(k[3] for k, nil in votes.items()
                            if nil and (k[0], k[1], k[2]) == (bad_h, 0, 1)),
        height_s=height_s, seconds=height_s[-1],
        collect_s=time.perf_counter() - t_start - height_s[-1], validators=len(css))
    return out


def expected_consensus_outcome(n_vals: int, heights: int, home, bad=LOCKSTEP_BAD,
                               seed: int = 0, n_txs: int = LOCKSTEP_TXS) -> dict:
    """The lockstep network's outcome (LOCKSTEP_OUTCOME_KEYS) on the host:
    the port at device "cpu" with the default dispatch (the native engine
    at these commit sizes). tests/test_torch_chip_smoke.py holds it against
    the reference's modules on the CPU."""
    got = lockstep_consensus(consensus_modules(), n_vals, heights, home, {"device": "cpu"},
                             bad=bad, seed=seed, n_txs=n_txs)
    return {k: got[k] for k in LOCKSTEP_OUTCOME_KEYS}


def quiet_expected_consensus_outcome(n_vals: int, heights: int, home: str, bad, seed: int,
                                     n_txs: int):
    """(`expected_consensus_outcome`, its wall seconds) with the nodes' log
    records dropped: phase 9 runs it in a second process."""
    from cometbft_tpu_torch.utils import log as L

    L.set_sink(lambda level, msg, fields: None)
    t0 = time.perf_counter()
    out = expected_consensus_outcome(n_vals, heights, home, bad=bad, seed=seed, n_txs=n_txs)
    return out, time.perf_counter() - t0


class SplitTimer:
    """Exclusive wall time of wrapped functions, by name: a call's time
    goes to its name less the time of wrapped calls inside it. One
    thread. `restore()` puts the originals back."""

    def __init__(self):
        self.ms, self.calls, self._stack, self._undo = {}, {}, [], []

    def wrap(self, owner, attr: str, name: str, on_call=None) -> None:
        import functools

        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            if on_call is not None:
                on_call(*args, **kwargs)
            self._stack.append(0.0)
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t
                inner = self._stack.pop()
                self.ms[name] = self.ms.get(name, 0.0) + (dt - inner) * 1e3
                self.calls[name] = self.calls.get(name, 0) + 1
                if self._stack:
                    self._stack[-1] += dt

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


def histogram_delta(before: dict, after: dict) -> dict:
    """{labels: (count, sum)} of what a histogram gained between two
    `snapshot()`s."""
    out = {}
    for k, v in after.items():
        b = before.get(k, {"count": 0, "sum": 0.0})
        if v["count"] != b["count"]:
            out[k] = (v["count"] - b["count"], v["sum"] - b["sum"])
    return out


def net_leg(dev, card, counts: dict, home) -> dict:
    """(a): the reference's harness, `InProcessNetwork(4, device=dev)` with
    FAST_TIMEOUTS, its threads and speculation: NET_TXS kvstore txs into
    node 0's mempool (gossip carries them), run to NET_HEIGHT."""
    from cometbft_tpu_torch.consensus.net import FAST_TIMEOUTS, InProcessNetwork
    from cometbft_tpu_torch.utils.metrics import consensus_metrics

    txs = [b"net-k%03d=v%03d" % (i, i) for i in range(NET_TXS)]
    cm = consensus_metrics()
    before = {"interval": cm.block_interval_seconds.snapshot(),
              "steps": cm.step_duration_seconds.snapshot()}

    home.mkdir(parents=True, exist_ok=True)

    def run():
        net = InProcessNetwork(NET_NODES, str(home), timeouts=FAST_TIMEOUTS, device=dev)
        net.start()
        try:
            t0 = time.perf_counter()
            for tx in txs:
                net.nodes[0].mempool.check_tx(tx)
            reached = net.wait_for_height(NET_HEIGHT + 1, timeout=NET_TIMEOUT_S)
            deadline = time.monotonic() + 30
            while any(n.mempool.size() for n in net.nodes) and time.monotonic() < deadline:
                time.sleep(0.05)
            wall = time.perf_counter() - t0
            stopped = [n.idx for n in net.nodes if n.cs._stopped.is_set()]
        finally:
            net.stop()
        return net, reached, wall, stopped

    (net, reached, wall, stopped), routes = counted_leg(counts, "consensus", "net", run)
    if not reached or stopped:
        raise AssertionError(f"consensus, (a): height {NET_HEIGHT} reached {reached}, nodes "
                             f"stopped {stopped} ({[n.cs.halt_error for n in net.nodes]})")
    top = min(len(n.cs.decided) for n in net.nodes)
    for h in range(1, top + 1):
        if len({n.cs.decided[h].key() for n in net.nodes}) != 1:
            raise AssertionError(f"consensus, (a): the nodes decided different blocks at {h}")
    low = min(n.cs.sm_state.last_block_height for n in net.nodes)

    def app_hash_at(n):
        if n.cs.sm_state.last_block_height == low:
            return n.cs.sm_state.app_hash
        return n.block_store.load_block(low + 1).header.app_hash

    if len({app_hash_at(n) for n in net.nodes}) != 1:
        raise AssertionError(f"consensus, (a): app hashes differ at height {low}")
    for n in net.nodes:
        committed = {tx for h in range(1, n.block_store.height() + 1)
                     for tx in n.block_store.load_block(h).data.txs}
        missing = [tx for tx in txs if tx not in committed
                   or n.app.query("", tx.partition(b"=")[0]).value != tx.partition(b"=")[2]]
        if missing:
            raise AssertionError(f"consensus, (a): node {n.idx} lacks {len(missing)} txs, e.g. "
                                 f"{missing[:3]}")
    steps = histogram_delta(before["steps"], cm.step_duration_seconds.snapshot())
    interval = histogram_delta(before["interval"], cm.block_interval_seconds.snapshot())
    count, total = interval.get((), (0, 0.0))
    out = {"nodes": NET_NODES, "txs": NET_TXS, "height": low, "wall_s": wall,
           "blocks_per_s": low / wall, "routes": routes,
           "rounds": cm.rounds.values().get((), 0.0),
           "block_interval_ms": total / count * 1e3 if count else None,
           "step_ms": {k[0]: round(s / c * 1e3, 3) for k, (c, s) in sorted(steps.items())},
           "step_calls": {k[0]: c for k, (c, _) in sorted(steps.items())}}
    log(f"consensus, (a) {NET_NODES} nodes on {dev}: {NET_TXS} txs committed and read back on "
        f"every node, height {low} in {wall:.3f} s ({out['blocks_per_s']:.2f} blocks/s), same "
        f"block ids and app hash; last-commit checks and votes by route {routes}; rounds gauge "
        f"{out['rounds']:.0f}, block interval {out['block_interval_ms']:.1f} ms, mean ms by "
        f"step {out['step_ms']} [{card}]")
    return out


def lockstep_leg(dev, card, counts: dict, seed: int, home, mul_rate: float) -> dict:
    """(b): the lockstep network at LOCKSTEP_VALIDATORS validators to
    LOCKSTEP_HEIGHTS on `dev` with the NATIVE_MAX seam at 0, so that every
    last-commit check runs on the device routes, against
    `expected_consensus_outcome` (the same run on the host, in a second
    process started once the card's run is over, so that nothing runs
    beside the timed one). The first full last commit's batch verifier is
    kept as the path queued it and held against the plain versions
    (`batch_window_check`) at its bucket, with lane LOCKSTEP_BAD[1] the
    tampered one."""
    import concurrent.futures
    import multiprocessing

    from cometbft_tpu_torch.consensus import state as S
    from cometbft_tpu_torch.consensus import wal as W
    from cometbft_tpu_torch.crypto import ed25519 as E
    from cometbft_tpu_torch.privval import file_pv as PV
    from cometbft_tpu_torch.state import execution as X

    kept = []
    submit = E.Ed25519BatchVerifier.submit

    def keep_first(bv):
        if not kept and bv.count() == LOCKSTEP_VALIDATORS:
            copy = E.Ed25519BatchVerifier(dev)
            copy.absorb(bv)
            kept.append(copy)
        return submit(bv)

    columns = []
    timer = SplitTimer()
    timer.wrap(X, "verify_commit", "checks", on_call=lambda chain, vals, bid, h, commit, **kw:
               columns.append(tuple(not s.is_absent() for s in commit.signatures)))
    timer.wrap(X.BlockExecutor, "apply_block", "apply")
    timer.wrap(S.ConsensusState, "_handle_vote", "votes")
    timer.wrap(S.ConsensusState, "_handle_proposal", "proposal")
    timer.wrap(S.ConsensusState, "_handle_block_bytes", "proposal")
    timer.wrap(PV.FilePV, "_sign_vote_inner", "sign")
    timer.wrap(PV.FilePV, "sign_proposal", "sign")
    timer.wrap(W.WAL, "write", "wal")
    timer.wrap(W.WAL, "write_sync", "wal")
    saved = E.NATIVE_MAX
    E.NATIVE_MAX = 0
    E.Ed25519BatchVerifier.submit = keep_first
    try:
        got, routes = counted_leg(
            counts, "consensus", "lockstep",
            lambda: lockstep_consensus(consensus_modules(), LOCKSTEP_VALIDATORS,
                                       LOCKSTEP_HEIGHTS, home / "card", {"device": dev},
                                       bad=LOCKSTEP_BAD, seed=seed, n_txs=LOCKSTEP_TXS),
            need=("decompress", "ladder_sub_mul8"))
    finally:
        E.NATIVE_MAX = saved
        E.Ed25519BatchVerifier.submit = submit
        timer.restore()
    # the host's run, in a spawned process (the native packer's threads
    # forbid a fork) with the card idle
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        want, host_s = pool.submit(quiet_expected_consensus_outcome, LOCKSTEP_VALIDATORS,
                                   LOCKSTEP_HEIGHTS, str(home / "host"), LOCKSTEP_BAD, seed,
                                   LOCKSTEP_TXS).result()
    diff = [k for k in LOCKSTEP_OUTCOME_KEYS if got[k] != want[k]]
    if diff:
        raise AssertionError(f"consensus, (b): {diff} differ from expected_consensus_outcome: "
                             f"{[(got[k], want[k]) for k in diff]}")
    bad_h, bad_i = LOCKSTEP_BAD
    proposer = got["proposers"][f"{bad_h}/0"]
    want_check = ("BlockValidationError",
                  f"invalid last commit: invalid signature at index {bad_i}")
    if got["tamper_check"] != want_check:
        raise AssertionError(f"consensus, (b): the tampered block gave {got['tamper_check']}")
    if got["nil_prevotes"] != [i for i in range(LOCKSTEP_VALIDATORS) if i != proposer]:
        raise AssertionError(f"consensus, (b): nil prevotes at ({bad_h}, 0): "
                             f"{got['nil_prevotes']}")
    if got["rounds"][bad_h - 1] != 1 or any(r for h, r in enumerate(got["rounds"], 1)
                                            if h != bad_h):
        raise AssertionError(f"consensus, (b): decided rounds {got['rounds']}")
    c = counts["lockstep"]
    checks = timer.calls["checks"]
    if not (c["ladder_sub_mul8"] == checks == routes.get("ladder")):
        raise AssertionError(f"consensus, (b): {c['ladder_sub_mul8']} ladder launches for "
                             f"{checks} last-commit checks (routes {routes})")
    if c["decompress"] != checks + len(set(columns)):
        raise AssertionError(f"consensus, (b): {c['decompress']} decompress launches for "
                             f"{checks} checks and {len(set(columns))} signer columns")
    if not kept:
        raise AssertionError(f"consensus, (b): no last commit of {LOCKSTEP_VALIDATORS} lanes "
                             "was submitted")
    window = batch_window_check(dev, card, kept[0], "consensus last commit", bad_i, mul_rate)
    per_node = 3 * (LOCKSTEP_HEIGHTS - 1) + 1  # 3 a height from 2 on, 1 more in round 0 of bad_h
    wall = got["seconds"]
    split = {k: v / LOCKSTEP_HEIGHTS for k, v in timer.ms.items()}
    split["other"] = wall * 1e3 / LOCKSTEP_HEIGHTS - sum(split.values())
    out = {"validators": LOCKSTEP_VALIDATORS, "heights": LOCKSTEP_HEIGHTS, "wall_s": wall,
           "collect_s": got["collect_s"], "host_expected_s": host_s,
           "blocks_per_s": LOCKSTEP_HEIGHTS / wall,
           "height_s": got["height_s"], "ms_a_height": split, "calls": timer.calls,
           "checks": checks, "predicted_checks": LOCKSTEP_VALIDATORS * per_node + 1,
           "signer_columns": len(set(columns)), "routes": routes, "rounds": got["rounds"],
           "tamper_check": got["tamper_check"], "proposer_at_bad": proposer,
           "window_check": window,
           "outcome": {k: got[k] for k in LOCKSTEP_OUTCOME_KEYS if k != "nil_prevotes"}}
    log(f"consensus, (b) lockstep {LOCKSTEP_VALIDATORS} validators on {dev}, NATIVE_MAX 0: "
        f"heights 1-{LOCKSTEP_HEIGHTS} in {wall:.3f} s alone ({out['blocks_per_s']:.3f} "
        f"blocks/s; the host's expected run after it {host_s:.3f} s), decided rounds "
        f"{got['rounds']}, "
        f"the state, app hashes, block hashes, seen commits and WALs equal "
        f"expected_consensus_outcome; ({bad_h}, 0): {len(got['nil_prevotes'])} nil prevotes "
        f"(all but the proposer, index "
        f"{proposer}), the tampered block {got['tamper_check']}; {checks} last-commit checks "
        f"({LOCKSTEP_VALIDATORS} x {per_node} + 1 direct predicted) by route {routes}, "
        f"ladder {c['ladder_sub_mul8']}, decompress {c['decompress']} ({len(set(columns))} "
        f"signer column); ms a height {({k: round(v, 1) for k, v in split.items()})} [{card}]")
    return out


def consensus_phase(dev, card, seed: int, kern: dict, mul_rate: float) -> dict:
    """Phase 9: in-process consensus on the card, (a) the threaded harness
    at the calibrated dispatch and (b) the lockstep network with every
    last commit checked on the device; each leg with the launch counts set
    to 0 just before it and read right after. The nodes' log records are
    counted, not printed."""
    import tempfile

    from cometbft_tpu_torch.utils import log as L

    out, counts = {"card": card}, {}
    finalized = []
    sink = L._config.sink
    L.set_sink(lambda level, msg, fields: finalized.append(fields.get("node"))
               if msg == "finalized block" else None)
    t_phase = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out["net"] = net_leg(dev, card, counts, Path(tmp) / "net")
            out["lockstep"] = lockstep_leg(dev, card, counts, seed, Path(tmp), mul_rate)
    finally:
        L.set_sink(sink)
    out["finalized_records"] = len(finalized)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"consensus: phase 9 took {out['seconds']:.1f} s, {len(finalized)} 'finalized block' "
        f"records [{card}]")
    out["counts"] = counts
    for name in SOURCES:
        kern[name]["launches_by_route"]["consensus"] = sum(c[name] for c in counts.values())
        kern[name]["launches"] += kern[name]["launches_by_route"]["consensus"]
    return out


# ---- phase 10: the verify mesh and block sync over p2p

MESH_SHARDS = (2, 4)  # logical shards of the one card when a single GPU is visible
MESH_BAD = (77, 5_003, 9_999)  # broken lanes of the 10,000-signature commit (the last among them)
# (lanes, shards) of the small layouts; shards 0: the engine's own; lanes
# None: one fewer than its shards (an all-dead shard)
MESH_SMALL = ((13, 8), (97, 0), (None, 0), (0, 0))
MESH_STREAM = 16  # streamed commits, placed round robin
MESH_REPS = 3
SYNC_TOP = 65  # (b1): phase 7's chain seen up to height 65; the node syncs to 64
SYNC_CHAIN = "sync-chain"
SYNC_VALIDATORS = 10_000  # (b2), (b3): the north star's scale
SYNC_BLOCKS = 9  # 8 of them synced: the tip waits for its successor's commit
SYNC_FORGED = (6, 4_321)  # (b3): the liar's block 6 has last-commit signature 4,321 flipped
SYNC_TIMEOUT_S = 600.0


def mesh_layouts(dev) -> list:
    """The device lists the mesh leg runs over: every visible GPU when there
    are several, else MESH_SHARDS logical shards of `dev`."""
    n = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n > 1:
        return [[torch.device("cuda", i) for i in range(n)]]
    return [[dev] * d for d in MESH_SHARDS]


def broken_lanes(items, lanes) -> list:
    """A copy of the (pub, msg, sig) items with each lane's R broken."""
    out = list(items)
    for i in lanes:
        pub, msg, sig = out[i]
        out[i] = (pub, msg, bytes([sig[0] ^ 1]) + sig[1:])
    return out


def mesh_arrays(items, b: int):
    """The ladder route's pinned host arrays of `items` padded to b lanes:
    (pubkey column, R||S||k rows, live mask), packed by the verifier."""
    from cometbft_tpu_torch.crypto import ed25519 as E

    bv = E.Ed25519BatchVerifier(torch.device("cpu"))
    n = len(items)
    if n:
        bv.add_batch(*to_columns(items))
    a = torch.zeros((b, 32), dtype=torch.uint8)
    if n:
        a[:n] = torch.from_numpy(np.frombuffer(bytes(bv._pub_buf), np.uint8).reshape(n, 32).copy())
    pin = torch.cuda.is_available()
    rsk = bv._pack_rsk(n, b)
    live = torch.arange(b) < n
    return (a.pin_memory(), rsk.pin_memory(), live.pin_memory()) if pin else (a, rsk, live)


def single_device_verdict(dev, a, rsk, live):
    """(all-ok, bits on the host) of the prehashed ladder on one device over
    the whole batch: what each mesh shard computes, unsharded."""
    from cometbft_tpu_torch.ops import ed25519_verify as V

    a, rsk, live = (t.to(dev) for t in (a, rsk, live))
    bits, ok = V.verify_batch_prehashed(a, rsk[:, :32], rsk[:, 32:64], rsk[:, 64:], live)
    return bool(ok.item()), bits.cpu()


def check_sharded(what: str, eng_or_fn, dev, a, rsk, live) -> bool:
    """A sharded verify against the single device's, bit for bit; returns
    its all-ok."""
    from cometbft_tpu_torch.parallel import mesh as M

    if callable(eng_or_fn):
        ok, bits = eng_or_fn(a, rsk, live)
    else:
        ok, bits = eng_or_fn.submit(a, rsk, live)
    got = (bool(ok.item()), M.gather_bits(bits))
    want = single_device_verdict(dev, a, rsk, live)
    if got[0] != want[0] or not torch.equal(got[1], want[1]):
        bad = (~got[1]).nonzero().flatten()[:8].tolist()
        raise AssertionError(f"mesh, {what}: sharded all-ok {got[0]}, bad lanes {bad}; the single "
                             f"device says {want[0]}, {(~want[1]).nonzero().flatten()[:8].tolist()}")
    return got[0]


def mesh_shard_check(eng, a, rsk, live) -> dict:
    """The kernels at a mesh shard's own shapes: one `eng.submit` of the
    arrays, the last shard's inputs kept as the sharded verifier hands them
    to `verify_batch_prehashed`; on them `decompress` over the shard's A
    and R together (2 x shard lanes, as the shard launches it) and
    `ladder_sub_mul8` over the shard's lanes, each through its wrapper
    against its plain version on every lane, bit for bit after freeze."""
    from cometbft_tpu_torch.ops import curve as C
    from cometbft_tpu_torch.ops import ed25519_verify as V
    from cometbft_tpu_torch.ops import field as F
    from cometbft_tpu_torch.ops import scalar as SC

    kept, real = [], V.verify_batch_prehashed

    def keep(*args):
        kept.append(tuple(x.clone() for x in args))
        return real(*args)

    V.verify_batch_prehashed = keep
    try:
        ok, _ = eng.submit(a, rsk, live)
        bool(ok.item())
    finally:
        V.verify_batch_prehashed = real
    if len(kept) != eng.n_devices:
        raise AssertionError(f"mesh shard check: {len(kept)} shards verified, want {eng.n_devices}")
    a_b, r_b, s_b, k_b, _ = kept[-1]
    k = a_b.shape[0]
    enc = torch.cat([a_b, r_b])
    valid, pt = C.decompress(enc)
    sign, y = C._split_encoding(enc)
    p_valid, p_x, p_t = C.decompress_plain(y, sign)
    mx, ex = frozen_diff(F, pt[0], p_x)
    mt, et = frozen_diff(F, pt[3], p_t)
    d_mism = int((valid != p_valid).sum()) + mx + mt
    s_dig, k_dig = SC.digits_from_bytes(s_b), SC.digits_from_bytes(k_b)
    neg_a, r_pt = C.neg(tuple(c[:, :k] for c in pt)), tuple(c[:, k:] for c in pt)
    got = torch.stack(C.ladder_sub_mul8(s_dig, k_dig, neg_a, r_pt))
    want = torch.stack(C.ladder_sub_mul8_plain(s_dig, k_dig, neg_a, r_pt))
    l_mism, el = frozen_diff(F, got, want)
    if d_mism or l_mism:
        raise AssertionError(f"mesh shard check over {eng.n_devices} shards: decompress at "
                             f"B={2 * k} {d_mism} lanes, ladder_sub_mul8 at B={k} {l_mism} lanes "
                             "differ from the plain versions")
    return {"shard_lanes": k, "decompress_lanes": 2 * k, "decompress_mismatches": d_mism,
            "decompress_max_abs_err": max(ex, et), "ladder_mismatches": l_mism,
            "ladder_max_abs_err": el}


def mesh_phase(dev, card, kern: dict, commits, chain) -> dict:
    """Phase 10 (a): the verify mesh over each layout of `mesh_layouts`, held
    bit for bit against the single device's ladder, and a shard's own
    kernel launches against their plain versions (`mesh_shard_check`);
    the model's mesh term and pick at the commit's bucket; then, with the engine
    installed and the pick forced, `submit()` through the mesh, streamed
    commits round robin and replay of phase 7's chain at depth 1 + d; each
    leg with the launch counts set to 0 just before it and read right
    after."""
    from cometbft_tpu_torch.abci import AppConns, KVStoreApp
    from cometbft_tpu_torch.blocksync import ReplayEngine
    from cometbft_tpu_torch.crypto import ed25519 as E
    from cometbft_tpu_torch.crypto.ed25519 import collect_pending
    from cometbft_tpu_torch.graft_entry import dryrun_multichip
    from cometbft_tpu_torch.ops import ed25519_verify as V
    from cometbft_tpu_torch.parallel import mesh as M
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.utils.metrics import crypto_metrics

    store, final, genesis = chain
    valid = list(commits[0])
    bad = broken_lanes(valid, MESH_BAD)
    gpus = torch.cuda.device_count() if dev.type == "cuda" else 0
    what_shards = "GPUs" if gpus > 1 else f"logical shards of {dev} (one after another on its stream)"
    out, counts = {"layouts": {}, "shards_are": what_shards}, {}
    t_phase = time.perf_counter()
    seams = (E._mesh_beats_single, E._rlc_beats_ladder, E._delta_beats_prehashed)
    try:
        for devs in mesh_layouts(dev):
            d = len(devs)
            res = {}
            eng = M.MeshVerifyEngine(devs)
            b = M.pad_to_shards(len(valid), d, E._bucket(len(valid)))
            arrays = {"valid": mesh_arrays(valid, b), "bad": mesh_arrays(bad, b)}
            if not check_sharded(f"{d} shards, 10,000 valid", eng, dev, *arrays["valid"]):
                raise AssertionError("mesh: the valid 10,000-signature commit did not verify")
            if check_sharded(f"{d} shards, 10,000 with lanes {MESH_BAD} broken", eng, dev,
                             *arrays["bad"]):
                raise AssertionError("mesh: the broken commit verified")
            res["shard_check"] = mesh_shard_check(eng, *arrays["bad"])
            for n, shards in MESH_SMALL:
                e = eng if not shards else M.MeshVerifyEngine([devs[0]] * shards)
                n = e.n_devices - 1 if n is None else n
                check_sharded(f"{n} lanes over {e.n_devices} shards", e, dev,
                              *mesh_arrays(broken_lanes(valid[:n], [n - 1] if n > 1 else []),
                                           M.pad_to_shards(n, e.n_devices)))
            # the device-SHA form against verify_batch on the same padded items
            bv = E.Ed25519BatchVerifier(dev, device_sha=True)
            bv.add_batch(*to_columns(bad))
            buf, fields, _ = bv._pack_device_sha(len(bad), b)
            t = E.unpack_fields(buf, fields)
            args = [t[k] for k in ("a", "r", "s", "words", "two", "live")]
            ok, bits = M.sharded_verify_fn(eng.mesh)(*args)
            wbits, wok = V.verify_batch(*(x.to(dev) for x in args))
            if bool(ok.item()) != bool(wok.item()) or not torch.equal(M.gather_bits(bits),
                                                                      wbits.cpu()):
                raise AssertionError(f"mesh, {d} shards: the device-SHA form differs from "
                                     "verify_batch")
            if d == 4:
                grid = M.MeshVerifyEngine(devs, hosts=2)
                g_ok, g_bits = grid.submit(*arrays["bad"])
                o_ok, o_bits = eng.submit(*arrays["bad"])
                if bool(g_ok.item()) != bool(o_ok.item()) or not torch.equal(
                        M.gather_bits(g_bits), M.gather_bits(o_bits)):
                    raise AssertionError("mesh: the 2 x 2 (host, sig) grid differs from 1-D")
                res["grid_2x2"] = "equal to 1-D"

            # the engine installed, the pick forced: submit() through the mesh
            M.set_engine(eng)
            E._mesh_beats_single = lambda n_, b_, device: True
            E._rlc_beats_ladder = lambda n_, b_, device: False
            E._delta_beats_prehashed = lambda n_, b_, device: False

            def submit_bad():
                bv = E.Ed25519BatchVerifier(dev)
                bv.add_batch(*to_columns(bad))
                p = bv.submit()
                return p._path, p.result()

            (path, (ok, bits)), routes = counted_leg(counts, "mesh", f"submit_{d}", submit_bad,
                                                     need=("decompress", "ladder_sub_mul8"))
            c = counts[f"submit_{d}"]
            if path != "mesh" or ok or [i for i, x in enumerate(bits) if not x] != list(MESH_BAD):
                raise AssertionError(f"mesh, submit(): path {path}, bad lanes "
                                     f"{[i for i, x in enumerate(bits) if not x][:8]}")
            if c["decompress"] != d or c["ladder_sub_mul8"] != d:
                raise AssertionError(f"mesh, submit() over {d} shards launched {c}")

            # streamed commits: the ladder route, each whole commit on the next device
            E._mesh_beats_single = lambda n_, b_, device: False
            before = crypto_metrics().mesh_batches_total.values()

            def streamed():
                return collect_pending([submit_commit(to_columns(commits[i % 2]), dev)
                                        for i in range(MESH_STREAM)])

            results, _ = counted_leg(counts, "mesh", f"stream_{d}", streamed,
                                     need=("ladder_sub_mul8",))
            after = crypto_metrics().mesh_batches_total.values()
            placed = {k[0]: v - before.get(k, 0.0) for k, v in after.items()
                      if k[1] == "stream" and v != before.get(k, 0.0)}
            if placed != {str(i): MESH_STREAM / d for i in range(d)} or \
                    not all(ok and all(bits) for ok, bits in results):
                raise AssertionError(f"mesh, streamed: placements {placed}")

            # replay of phase 7's chain at depth 1 + d, every window through the mesh
            E._mesh_beats_single = lambda n_, b_, device: True
            rep = ReplayEngine(store, BlockExecutor(AppConns(KVStoreApp()), device=dev),
                               window=REPLAY_WINDOW, device=dev)
            t0 = time.perf_counter()
            (state, stats), routes_r = counted_leg(counts, "mesh", f"replay_{d}",
                                                   lambda: rep.run(genesis.copy()),
                                                   need=("decompress", "ladder_sub_mul8"))
            replay_s = time.perf_counter() - t0
            if rep._pipeline_depth() != 1 + d or state.encode() != final.encode() or \
                    stats.blocks != REPLAY_BLOCKS or set(routes_r) != {"mesh"}:
                raise AssertionError(f"mesh, replay at depth {rep._pipeline_depth()}: routes "
                                     f"{routes_r}, {stats.blocks} blocks, state equal "
                                     f"{state.encode() == final.encode()}")
            M.set_engine(None)

            # the calibrated terms, and a sharded submit's time beside one device's
            terms = eng.dispatch_terms()
            if not terms["calibrated"]:
                raise AssertionError("mesh: dispatch_terms() did not calibrate")
            # the model's mesh term at the commit's bucket and the pick it makes
            M.set_engine(eng)
            n_c, b_c = len(valid), E._bucket(len(valid))
            model = E.dispatch_model(n_c, b_c, dev)
            res["model"] = {"bucket": b_c, "picked": seams[0](n_c, b_c, dev),
                            **{f"{r}_ms": {k: v * 1e3 for k, v in model[r].items()}
                               for r in ("mesh", "ladder", "rlc")},
                            **{f"t_{r}_ms": model[f"t_{r}"] * 1e3 for r in ("mesh", "ladder", "rlc")}}
            M.set_engine(None)

            def sharded():
                ok, _ = eng.submit(*arrays["valid"])
                ok.item()

            def single():
                single_device_verdict(dev, *arrays["valid"])

            res.update(shards=d, devices=[str(x) for x in devs], terms=terms,
                       submit_ms=median_ms(sharded, MESH_REPS),
                       single_ms=median_ms(single, MESH_REPS), submit_routes=routes,
                       placed=placed, replay_s=replay_s,
                       replay_blocks_per_s=REPLAY_BLOCKS / replay_s, replay_routes=routes_r)
            dryrun_multichip(d, str(dev))
            small = ", ".join(f"{'d - 1' if n is None else n} over {k or d}" for n, k in MESH_SMALL)
            sc, mo = res["shard_check"], res["model"]
            log(f"mesh, {d} {what_shards}: the model at {n_c:,} lanes (bucket {b_c:,}) ms: mesh "
                + ", ".join(f"{k} {v:.3f}" for k, v in mo["mesh_ms"].items())
                + f" -> {mo['t_mesh_ms']:.3f}; ladder {mo['t_ladder_ms']:.3f}, rlc "
                f"{mo['t_rlc_ms']:.3f}; the mesh picked: {mo['picked']} [{card}]")
            log(f"mesh, {d} {what_shards}: the last shard of the broken commit, decompress at "
                f"B={sc['decompress_lanes']} and ladder_sub_mul8 at B={sc['shard_lanes']} exact "
                f"on every lane against the plain versions [{card}]")
            log(f"mesh, {d} {what_shards}: {len(valid):,} lanes valid and broken, lanes over "
                f"shards {small}, the device-SHA form{', the 2 x 2 grid' if d == 4 else ''}: all "
                f"bit for bit the single device's; submit() took the mesh ({d} decompress, {d} ladder "
                f"launches); {MESH_STREAM} streamed commits placed {placed}; replay of "
                f"{REPLAY_BLOCKS} blocks at depth {1 + d} through the mesh in {replay_s:.2f} s to "
                f"phase 7's state; terms put_fixed {terms['put_fixed_s'] * 1e6:.1f} us, "
                f"collective {terms['collective_s'] * 1e6:.1f} us; a sharded 10,000-signature "
                f"verify {res['submit_ms']:.3f} ms against one device's {res['single_ms']:.3f} ms "
                f"[{card}]")
            out["layouts"][d] = res
    finally:
        M.set_engine(None)
        M.reset_engine()
        E._mesh_beats_single, E._rlc_beats_ladder, E._delta_beats_prehashed = seams
    out["seconds"] = time.perf_counter() - t_phase
    out["counts"] = counts
    for name in SOURCES:
        kern[name]["launches_by_route"]["mesh"] = sum(c[name] for c in counts.values())
        kern[name]["launches"] += kern[name]["launches_by_route"]["mesh"]
    return out


class StoreView:
    """A block store served up to height `top`; with `forge` = (height,
    index), that block's last commit has signature `index` flipped (a lying
    peer's store)."""

    def __init__(self, inner, top: int, forge=None):
        self.inner, self.top, self.forge = inner, top, forge

    def height(self) -> int:
        return min(self.inner.height(), self.top)

    def base(self) -> int:
        return self.inner.base()

    def load_block(self, h: int):
        if h > self.top:
            return None
        blk = self.inner.load_block(h)
        if blk is not None and self.forge and h == self.forge[0]:
            blk.last_commit = with_flipped_signature(blk.last_commit, self.forge[1])
        return blk

    def load_block_commit(self, h: int):
        return self.inner.load_block_commit(h) if h < self.top else None

    def load_seen_commit(self, h: int):
        return self.inner.load_seen_commit(h) if h <= self.top else None


def host_state(store, genesis, top: int, app=None, state_store=None):
    """The state that applying blocks 1..top of `store` gives on the host:
    every last commit verified by the native engine (NATIVE_MAX raised over
    every commit size), `app` (a fresh KVStoreApp unless given); with
    `state_store`, every state is saved there from genesis on."""
    from cometbft_tpu_torch.abci import AppConns, KVStoreApp
    from cometbft_tpu_torch.crypto import ed25519 as E
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.types.block import block_id_for

    prev, E.NATIVE_MAX = E.NATIVE_MAX, 1 << 30
    try:
        ex = BlockExecutor(AppConns(app or KVStoreApp()), state_store=state_store, device="cpu")
        state = genesis.copy()
        if state_store is not None:
            state_store.save(state)
        for h in range(1, top + 1):
            blk = store.load_block(h)
            state = ex.apply_block(state, block_id_for(blk), blk)
    finally:
        E.NATIVE_MAX = prev
    return state


def host_refusal(store, state, height: int):
    """The host's verdict on block `height` checked against block height+1's
    last commit, the light check block sync runs (the native engine), as
    `outcome_of` gives it."""
    from cometbft_tpu_torch.crypto import ed25519 as E
    from cometbft_tpu_torch.types.block import block_id_for
    from cometbft_tpu_torch.types.validation import verify_commit_light

    first, second = store.load_block(height), store.load_block(height + 1)
    prev, E.NATIVE_MAX = E.NATIVE_MAX, 1 << 30
    try:
        return outcome_of(lambda: verify_commit_light(
            state.chain_id, state.validators, block_id_for(first), height,
            second.last_commit, device="cpu"))
    finally:
        E.NATIVE_MAX = prev


class SyncNet:
    """Block-sync nodes on 127.0.0.1: each a `Switch` with its `Transport`
    (and a `SecretConnection` a peer) and a `BlockSyncReactor`."""

    def __init__(self, chain_id: str, rate):
        self.chain_id, self.rate, self.switches = chain_id, rate, []

    def node(self, reactor, name: str):
        from cometbft_tpu_torch.p2p import NodeInfo, NodeKey, Switch, Transport

        nk = NodeKey.generate()
        tr = Transport(nk, NodeInfo(node_id=nk.node_id(), network=self.chain_id, moniker=name))
        sw = Switch(tr, send_rate=self.rate, recv_rate=self.rate)
        sw.add_reactor(reactor)
        tr.listen()
        sw.start()
        self.switches.append(sw)
        return sw

    @staticmethod
    def connect(syncing_sw, syncing, serving_sw, timeout_s: float = 20.0):
        """The syncing node dials the serving one and waits for the peer."""
        host, port = serving_sw.transport.node_info.listen_addr.split(":")
        peer = syncing_sw.dial_peer(host, int(port))
        deadline = time.monotonic() + timeout_s
        while peer.id not in syncing._peers and time.monotonic() < deadline:
            time.sleep(0.01)
        return peer

    def cipher(self) -> dict:
        """Frames and milliseconds of every live connection's cipher, both
        ends: bytes sealed and opened, and the time it took."""
        from cometbft_tpu_torch.p2p.secret_connection import SEALED_FRAME_SIZE

        out = {"sealed_frames": 0, "opened_frames": 0, "seal_ms": 0.0, "open_ms": 0.0}
        for sw in self.switches:
            for p in sw.peers():
                sc = p.mconn._conn
                out["sealed_frames"] += sc.sealed_frames
                out["opened_frames"] += sc.opened_frames
                out["seal_ms"] += sc.seal_s * 1e3
                out["open_ms"] += sc.open_s * 1e3
        out["bytes"] = out["sealed_frames"] * SEALED_FRAME_SIZE
        return out

    def stop(self) -> None:
        for sw in self.switches:
            sw.stop()


def sync_split(tap) -> dict:
    """The median per-block verify and apply milliseconds of the leg's
    `blocksync.block` spans."""
    spans = tap.spans("blocksync.block")
    return {"blocks": len(spans),
            "verify_ms": float(np.median([s["verify_ms"] for s in spans])) if spans else None,
            "apply_ms": float(np.median([s["apply_ms"] for s in spans])) if spans else None}


def quiet_split(store, genesis, top: int, dev) -> dict:
    """The light checks and applies of a sync to `top`, run on `dev` with no
    wire beside them: the median ms a block of each, and the state bytes
    reached."""
    from cometbft_tpu_torch.abci import AppConns, KVStoreApp
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.types.block import block_id_for
    from cometbft_tpu_torch.types.validation import verify_commit_light

    ex, state = BlockExecutor(AppConns(KVStoreApp()), device=dev), genesis.copy()
    verify, apply = [], []
    for h in range(1, top + 1):
        first, second = store.load_block(h), store.load_block(h + 1)
        bid = block_id_for(first)
        t0 = time.perf_counter()
        verify_commit_light(state.chain_id, state.validators, bid, h, second.last_commit,
                            device=dev)
        t1 = time.perf_counter()
        state = ex.apply_block(state, bid, first)
        verify.append(t1 - t0)
        apply.append(time.perf_counter() - t1)
    return {"verify_ms": float(np.median(verify)) * 1e3, "apply_ms": float(np.median(apply)) * 1e3,
            "state": state.encode()}


def sync_leg(dev, card, counts, leg: str, net, serving, genesis, top: int, tap,
             expect_state: bytes, need=()):
    """One syncing node (fresh store, `dev`) against the serving reactors,
    synced to `top`: its state bytes must be `expect_state`. Returns the
    leg's numbers and the syncing reactor."""
    from cometbft_tpu_torch.abci import AppConns, KVStoreApp
    from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.storage import BlockStore, MemKV

    store = BlockStore(MemKV())
    syncing = BlockSyncReactor(store, executor=BlockExecutor(AppConns(KVStoreApp()), device=dev),
                               state=genesis.copy(), device=dev)
    sw = net.node(syncing, f"{leg}-syncer")
    for s in serving:
        net.connect(sw, syncing, s)
    tap.mark()
    t0 = time.perf_counter()
    state, routes = counted_leg(counts, "blocksync", leg,
                                lambda: syncing.sync(timeout_s=SYNC_TIMEOUT_S), need=need)
    wall = time.perf_counter() - t0
    if state.last_block_height != top or store.height() != top or state.encode() != expect_state:
        raise AssertionError(f"blocksync, {leg}: height {state.last_block_height} (store "
                             f"{store.height()}), want {top}; state equal to the host's "
                             f"{state.encode() == expect_state}; refused {syncing.refused}")
    res = {"blocks": top, "wall_s": wall, "blocks_per_s": top / wall, "routes": routes,
           "launches": {k: v for k, v in counts[leg].items() if v}, **sync_split(tap),
           **net.cipher(),
           "synced_block_bytes": sum(len(store.load_block(h).encode()) for h in range(1, top + 1))}
    return res, syncing, store


def blocksync_phase(dev, card, seed: int, kern: dict, chain) -> dict:
    """Phase 10 (b): block sync over TCP on 127.0.0.1 between two switches,
    the syncing reactor on `dev`: (b1) phase 7's chain at the reference's
    rates, (b2) a 10,000-validator chain with the rate limits off, (b3) a
    lying peer, then an honest one."""
    from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor
    from cometbft_tpu_torch.p2p.conn import DEFAULT_RECV_RATE, DEFAULT_SEND_RATE
    from cometbft_tpu_torch.utils import factories as fx
    from cometbft_tpu_torch.utils import trace
    from cometbft_tpu_torch.utils.metrics import blocksync_metrics

    out, counts = {"card": card}, {}
    path = OUT_DIR / "trace_blocksync.jsonl"
    trace.configure(str(path))
    tap = TraceTap(path)
    try:
        # (b1) BASELINE.json's block-sync config: phase 7's chain up to 65
        store7, _, genesis7 = chain
        want = host_state(store7, genesis7, SYNC_TOP - 1)
        if want.app_hash != store7.load_block(SYNC_TOP).header.app_hash:
            raise AssertionError("blocksync, (b1): the host's state misses block 65's app hash")
        net = SyncNet(REPLAY_CHAIN, DEFAULT_SEND_RATE)
        try:
            server = net.node(BlockSyncReactor(StoreView(store7, SYNC_TOP)), "b1-server")
            out["b1"], _, _ = sync_leg(dev, card, counts, "b1", net, [server], genesis7,
                                       SYNC_TOP - 1, tap, want.encode())
        finally:
            net.stop()
        out["b1"]["rate_bytes_per_s"] = (DEFAULT_SEND_RATE, DEFAULT_RECV_RATE)

        # (b2) the north star's scale, the rate limits off
        t0 = time.perf_counter()
        (store, _, genesis, _), _ = counted_leg(counts, "blocksync", "generate", lambda: fx.make_chain(
            SYNC_BLOCKS, n_validators=SYNC_VALIDATORS, chain_id=SYNC_CHAIN, txs_per_block=1,
            seed=seed, device=dev, r_pool=fx.RPool(SYNC_VALIDATORS, SYNC_BLOCKS, device=dev)))
        out["generate_s"] = time.perf_counter() - t0
        top = SYNC_BLOCKS - 1
        want = host_state(store, genesis, top).encode()
        net = SyncNet(SYNC_CHAIN, 0)
        try:
            server = net.node(BlockSyncReactor(StoreView(store, SYNC_BLOCKS)), "b2-server")
            out["b2"], _, _ = sync_leg(dev, card, counts, "b2", net, [server], genesis, top, tap,
                                       want)
        finally:
            net.stop()
        if not set(out["b2"]["routes"]) & {"ladder", "rlc"} or \
                not out["b2"]["launches"].get("ladder_sub_mul8"):
            raise AssertionError(f"blocksync, (b2): the light checks took {out['b2']['routes']}, "
                                 f"launches {out['b2']['launches']}")
        # the same checks and applies with no wire beside them
        quiet, _ = counted_leg(counts, "blocksync", "b2_quiet",
                               lambda: quiet_split(store, genesis, top, dev))
        if quiet.pop("state") != want:
            raise AssertionError("blocksync, (b2) without the wire: not the host's state")
        out["b2"]["quiet"] = quiet
        out["chain"] = (store, genesis)  # for phase 11 (popped before results.json)

        # (b3) a lying peer alone, then an honest one too
        from cometbft_tpu_torch.abci import AppConns, KVStoreApp
        from cometbft_tpu_torch.state.execution import BlockExecutor
        from cometbft_tpu_torch.storage import BlockStore, MemKV

        liar_view = StoreView(store, SYNC_BLOCKS, forge=SYNC_FORGED)
        h_bad = SYNC_FORGED[0] - 1  # block 5 is checked against the liar's block 6
        want_refusal = host_refusal(liar_view, host_state(store, genesis, h_bad - 1), h_bad)
        if want_refusal is None:
            raise AssertionError("blocksync, (b3): the host accepts the forged commit")
        bad_before = blocksync_metrics().bad_blocks_total.values().get((), 0.0)
        net = SyncNet(SYNC_CHAIN, 0)
        try:
            liar = net.node(BlockSyncReactor(liar_view), "b3-liar")
            honest = net.node(BlockSyncReactor(StoreView(store, SYNC_BLOCKS)), "b3-honest")
            fresh = BlockStore(MemKV())
            syncing = BlockSyncReactor(fresh, executor=BlockExecutor(AppConns(KVStoreApp()),
                                                                     device=dev),
                                       state=genesis.copy(), device=dev)
            sw = net.node(syncing, "b3-syncer")
            liar_peer = net.connect(sw, syncing, liar)
            tap.mark()
            t0 = time.perf_counter()
            state, routes1 = counted_leg(counts, "blocksync", "b3_liar",
                                         lambda: syncing.sync(timeout_s=SYNC_TIMEOUT_S))
            liar_s = time.perf_counter() - t0
            got_refusal = [(h, p, (type(e).__name__, str(e))) for h, p, e in syncing.refused]
            bad_blocks = blocksync_metrics().bad_blocks_total.values().get((), 0.0) - bad_before
            if state.last_block_height != h_bad - 1 or bad_blocks < 1 or \
                    got_refusal[:1] != [(h_bad, liar_peer.id, want_refusal)] or \
                    liar_peer.id in {p.id for p in sw.peers()}:
                raise AssertionError(f"blocksync, (b3) liar alone: height "
                                     f"{state.last_block_height}, want {h_bad - 1}; bad blocks "
                                     f"{bad_blocks}; refusals {got_refusal}; want {want_refusal}; "
                                     f"peers after {[p.id for p in sw.peers()]}")
            split1 = sync_split(tap)
            net.connect(sw, syncing, honest)
            tap.mark()
            t0 = time.perf_counter()
            state, routes2 = counted_leg(counts, "blocksync", "b3_honest",
                                         lambda: syncing.sync(timeout_s=SYNC_TIMEOUT_S))
            honest_s = time.perf_counter() - t0
            if state.last_block_height != top or state.encode() != want:
                raise AssertionError(f"blocksync, (b3) with the honest peer: height "
                                     f"{state.last_block_height}, state equal to (b2)'s "
                                     f"{state.encode() == want}")
            for h in range(1, top + 1):
                if fresh.load_block(h).encode() != store.load_block(h).encode():
                    raise AssertionError(f"blocksync, (b3): stored block {h} is not the honest one")
            out["b3"] = {"refusal": got_refusal, "bad_blocks": bad_blocks,
                         "liar": {"wall_s": liar_s, "height": h_bad - 1, "routes": routes1,
                                  **split1},
                         "honest": {"wall_s": honest_s, "blocks": top - h_bad + 1,
                                    "blocks_per_s": (top - h_bad + 1) / honest_s,
                                    "routes": routes2, **sync_split(tap)},
                         "banned": sorted(syncing.banned), **net.cipher()}
        finally:
            net.stop()
    finally:
        trace.disable()
    log(f"blocksync, (b2) the same {top} light checks and applies with no wire beside them: "
        f"median verify {out['b2']['quiet']['verify_ms']:.3f} ms, apply "
        f"{out['b2']['quiet']['apply_ms']:.3f} ms a block [{card}]")
    for leg in ("b1", "b2"):
        r = out[leg]
        log(f"blocksync, ({leg}) {r['blocks']} blocks synced over TCP in {r['wall_s']:.2f} s -> "
            f"{r['blocks_per_s']:.2f} blocks/s; median a block verify {r['verify_ms']} ms, apply "
            f"{r['apply_ms']} ms; wire {r['bytes']} B sealed for {r['synced_block_bytes']} B of "
            f"blocks synced, seal {r['seal_ms']:.0f} ms, open {r['open_ms']:.0f} ms; routes "
            f"{r['routes']}, launches {r['launches']} [{card}]")
    r = out["b3"]
    h = r["honest"]
    log(f"blocksync, (b3) the liar alone: stopped at height {r['liar']['height']} in "
        f"{r['liar']['wall_s']:.2f} s (median a block verify {r['liar']['verify_ms']} ms, apply "
        f"{r['liar']['apply_ms']} ms), refusal {r['refusal'][0]}, bad blocks "
        f"{r['bad_blocks']:.0f}, the liar banned and disconnected; with the honest peer: "
        f"{h['blocks']} more blocks in {h['wall_s']:.2f} s ({h['blocks_per_s']:.2f} blocks/s, "
        f"median verify {h['verify_ms']} ms, apply {h['apply_ms']} ms) to (b2)'s state, the "
        f"forged block never stored; wire {r['bytes']} B sealed, seal {r['seal_ms']:.0f} ms, "
        f"open {r['open_ms']:.0f} ms; routes {r['liar']['routes']} then {h['routes']} [{card}]")
    out["counts"] = counts
    for name in SOURCES:
        kern[name]["launches_by_route"]["blocksync"] = sum(c[name] for c in counts.values())
        kern[name]["launches"] += kern[name]["launches_by_route"]["blocksync"]
    return out


# ---- phase 11: the network reactors and state sync

TCP_CHAIN = "tcp-chain"
TCP_NODES = 4
TCP_HEIGHT = 6
TCP_TXS = 64  # kvstore txs submitted at node 3
TCP_PINNED_HEIGHT = 3  # the rerun with every last-commit check on the ladder
TCP_CHECK_BAD_LANE = 1  # the tampered lane of the checked last commit
TCP_PEX_INTERVAL_S = 0.5
TCP_TIMEOUT_S = 120.0
# tests/test_node.py's timeouts
TCP_TIMEOUTS = {"propose": 0.6, "propose_delta": 0.2, "prevote": 0.3, "prevote_delta": 0.1,
                "precommit": 0.3, "precommit_delta": 0.1, "commit": 0.1}
GOSSIP_FRAME_TXS = 256  # txs a frame of the raw peer (one admission window at the default)
GOSSIP_TIMEOUT_S = 300.0
SS_C1_TOP = 65  # (c1): phase 7's chain served up to 65, a snapshot every 20 (40 and 60 kept)
SS_C1_INTERVAL = 20
SS_C1_CHECK_BUCKET = 1024  # (c1)'s light checks: 334 or 667 of 1,000 lanes, bucket 1,024
SS_C1_CHECK_BAD_LANE = 101  # the tampered lane of (c1)'s checked light check
SS_C2_INTERVAL = 5  # (c2): phase 10 (b2)'s 9 blocks, a snapshot at 5
SS_CHUNK_BYTES = 256
SS_LIAR_HEIGHT = 62  # (c3): the liar's snapshot, above the honest one at 60
SS_LIAR_ERROR = ("ErrRejectSnapshot", "app rejected snapshot during apply")
SS_TIMEOUT_S = 600.0


def network_modules(package: str = "cometbft_tpu_torch"):
    """`consensus_modules` and the modules of a node on p2p: the switch, PEX,
    the three reactors, the mempool and the evidence pool."""
    import importlib

    m = consensus_modules(package)
    for k, v in {"p2p": "p2p", "pex": "p2p.pex", "creactor": "consensus.reactor",
                 "mreactor": "mempool.reactor", "ereactor": "evidence.reactor",
                 "mempool": "mempool", "evidence": "evidence"}.items():
        setattr(m, k, importlib.import_module(f"{package}.{v}"))
    return m


class TcpNet:
    """Validators over TCP on 127.0.0.1: each a ConsensusState with its own
    KVStore app, stores, CListMempool, EvidencePool, WAL and FilePV (keys
    from `seed`), and a Transport and Switch with the consensus, mempool,
    evidence and PEX reactors, wired as the reference's node wires them.
    Node i is built from packages[i] (`network_modules`, the port's by
    default) with its executor made with exec_kws[i]. Nodes 1.. know only
    node 0's address and dial it; PEX connects the rest."""

    def __init__(self, n: int, home, packages=None, exec_kws=None, seed: int = 0,
                 chain_id: str = TCP_CHAIN, pex_interval_s: float = TCP_PEX_INTERVAL_S):
        home = Path(home)
        home.mkdir(parents=True, exist_ok=True)
        packages = packages or ["cometbft_tpu_torch"] * n
        exec_kws = exec_kws or [{"device": "cuda"}] * n
        keys = [bytes(r) for r in np.random.default_rng(seed).integers(0, 256, (n, 32),
                                                                          dtype=np.uint8)]
        self.chain_id, self.mesh_s, self.t_start = chain_id, None, None
        self.nodes = [self._node(network_modules(packages[i]), i, keys, home, exec_kws[i],
                                 pex_interval_s) for i in range(n)]

    def _node(self, m, i: int, keys, home, exec_kw: dict, pex_interval_s: float):
        from types import SimpleNamespace

        privs = [m.ed.Ed25519PrivKey(k) for k in keys]
        genesis = m.execution.make_genesis_state(self.chain_id, m.types.ValidatorSet(
            [m.types.Validator.from_pub_key(p.pub_key(), LOCKSTEP_POWER) for p in privs]))
        app = m.kvstore.KVStoreApp()
        bs, ss = m.storage.BlockStore(m.storage.MemKV()), m.storage.StateStore(m.storage.MemKV())
        ss.save(genesis)
        conns = m.client.AppConns(app)
        mp = m.mempool.CListMempool(conns)
        pool = m.evidence.EvidencePool(state_store=ss, block_store=bs, chain_id=self.chain_id)
        ex = m.execution.BlockExecutor(conns, state_store=ss, block_store=bs, mempool=mp,
                                       evidence_pool=pool, **exec_kw)
        cs = m.state.ConsensusState(
            chain_id=self.chain_id, sm_state=genesis.copy(), executor=ex, block_store=bs,
            privval=m.file_pv.FilePV(privs[i], None, str(home / f"pv{i}.state.json")),
            wal=m.wal.WAL(str(home / f"wal{i}")), timeouts=m.state.TimeoutConfig(**TCP_TIMEOUTS),
            tx_source=lambda: mp.reap_columns(max_bytes=1 << 20), name=f"node{i}")
        nk = m.p2p.NodeKey.generate()
        tr = m.p2p.Transport(nk, m.p2p.NodeInfo(node_id=nk.node_id(), network=self.chain_id,
                                                moniker=f"node{i}"))
        sw = m.p2p.Switch(tr)
        book = m.pex.AddrBook(None, self_id=nk.node_id())
        reactors = [m.creactor.ConsensusReactor(cs), m.mreactor.MempoolReactor(mp),
                    m.ereactor.EvidenceReactor(pool),
                    m.pex.PexReactor(book, ensure_interval_s=pex_interval_s)]
        for r in reactors:
            r.set_switch(sw)
            sw.add_reactor(r)
        return SimpleNamespace(idx=i, m=m, priv=privs[i], app=app, block_store=bs,
                               state_store=ss, mempool=mp, evidence_pool=pool, cs=cs,
                               transport=tr, switch=sw, book=book, reactors=reactors,
                               id=nk.node_id())

    def start(self) -> None:
        for nd in self.nodes:
            nd.transport.listen()
            nd.switch.start()
        self.t_start = time.perf_counter()
        for nd in self.nodes:
            nd.reactors[3].start()
        host, port = self.nodes[0].transport.node_info.listen_addr.split(":")
        for nd in self.nodes[1:]:
            nd.switch.dial_peer(host, int(port))
        for nd in self.nodes:
            nd.cs.start(replay_wal=False)

    def meshed(self) -> bool:
        """Every node connected to every other, each in its address book."""
        for nd in self.nodes:
            others = {o.id for o in self.nodes if o is not nd}
            if {p.id for p in nd.switch.peers()} != others or not all(
                    nd.book.has(o) for o in others):
                return False
        return True

    def wait_mesh(self, timeout_s: float) -> float:
        """Seconds from start to a full mesh (PEX)."""
        deadline = time.monotonic() + timeout_s
        while not self.meshed():
            if time.monotonic() > deadline:
                raise AssertionError("tcp: PEX formed no full mesh: peers " + str(
                    [sorted(p.id[:8] for p in nd.switch.peers()) for nd in self.nodes]))
            time.sleep(0.02)
        self.mesh_s = time.perf_counter() - self.t_start
        return self.mesh_s

    def equivocate(self, at: int, byz: int, timeout_s: float):
        """A prevote of validator `byz` for another block than its own
        prevote of the round, signed with its key and sent to node `at`'s
        consensus as a peer's (as tests/test_evidence_reactor.py:45 sends
        it), once node `at` holds byz's own prevote: the conflicting vote is
        never added, so no other node sees it and the pair is reported once.
        Sent again at a later round or height only if it came too late to be
        seen; returns the DuplicateVoteEvidence once node `at`'s pool holds
        it."""
        nd = self.nodes[at]
        m, priv = nd.m, self.nodes[byz].priv
        addr = priv.pub_key().address()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            seen = len(nd.cs.evidence)
            h, r = nd.cs.height, nd.cs.round
            idx, _ = nd.cs.validators.get_by_address(addr)
            prevotes = nd.cs.votes.prevotes(r) if h >= 2 else None
            own = prevotes.get_by_index(idx) if prevotes is not None else None
            if own is None or own.height != h:
                time.sleep(0.005)  # a validator set stored for the vote's height
                continue
            v = m.types.Vote(
                type=m.types.SignedMsgType.PREVOTE, height=h, round=r,
                block_id=m.types.BlockID(hash=b"\xee" * 32, part_set_header=(
                    m.types.PartSetHeader(total=1, hash=b"\xee" * 32))),
                timestamp=m.types.Timestamp.from_unix_ns(time.time_ns()),
                validator_address=addr, validator_index=idx)
            v.signature = priv.sign(v.sign_bytes(self.chain_id))
            nd.cs.send(m.state.VoteMessage(v), peer_id="byz")
            while time.monotonic() < deadline:
                if len(nd.cs.evidence) > seen:
                    pending = nd.evidence_pool.pending_evidence()
                    if pending:
                        return pending[0]
                elif nd.cs.height > h + 1 and nd.cs.inbox.empty():
                    time.sleep(0.1)
                    if len(nd.cs.evidence) == seen:
                        break  # handled at a later height: send one again
                time.sleep(0.02)
        raise AssertionError(f"tcp: no evidence in node {at}'s pool")

    def stop(self) -> None:
        for nd in self.nodes:
            nd.cs.stop()
        for nd in self.nodes:
            nd.reactors[3].stop()
            nd.reactors[2].stop()
            nd.reactors[0].stop()
            nd.switch.stop()
            nd.mempool.close()

    def outcome(self, txs, top: int) -> dict:
        """What every node committed up to `top`: the block hashes and app
        hashes (each node's equal, or an error), each tx in a block and read
        back from every app, the evidence committed."""
        nodes = self.nodes
        hashes, app_hashes = [], []
        for h in range(1, top + 1):
            blocks = [nd.block_store.load_block(h) for nd in nodes]
            if any(b is None for b in blocks) or len({b.hash() for b in blocks}) != 1:
                raise AssertionError(f"tcp: the nodes' blocks at height {h} differ or miss")
            hashes.append(blocks[0].hash().hex())
            if h > 1:
                app_hashes.append(blocks[0].header.app_hash.hex())
        evidence = []
        for nd in nodes:
            evs = [(h, ev.hash().hex()) for h in range(1, nd.block_store.height() + 1)
                   for ev in nd.block_store.load_block(h).evidence]
            evidence.append(evs)
        missing = {}
        for nd in nodes:
            committed = {tx for h in range(1, nd.block_store.height() + 1)
                         for tx in nd.block_store.load_block(h).data.txs}
            lost = [tx for tx in txs if tx not in committed or nd.app.query(
                "", tx.partition(b"=")[0]).value != tx.partition(b"=")[2]]
            if lost:
                missing[nd.idx] = len(lost)
        return {"block_hashes": hashes, "app_hashes": app_hashes, "evidence": evidence,
                "missing_txs": missing}


def run_tcp_net(net, txs, top: int, timeout_s: float, evidence_from=None) -> dict:
    """Start `net`, wait for PEX's full mesh, submit `txs` at the last node
    and, with `evidence_from` = (at, byz), an equivocation at node `at`;
    run until every node committed `top`, every tx and the evidence; stop.
    Returns the timings, the evidence and `net.outcome`."""
    net.start()
    try:
        mesh_s = net.wait_mesh(timeout_s)
        for tx in txs:
            net.nodes[-1].mempool.check_tx(tx)
        ev = net.equivocate(*evidence_from, timeout_s) if evidence_from else None
        deadline = time.monotonic() + timeout_s

        def done():
            if min(nd.cs.sm_state.last_block_height for nd in net.nodes) < top:
                return False
            for nd in net.nodes:
                h = nd.block_store.height()
                blocks = [nd.block_store.load_block(i) for i in range(1, h + 1)]
                if ev is not None and not any(b.evidence for b in blocks):
                    return False
                if not set(txs) <= {tx for b in blocks for tx in b.data.txs}:
                    return False
            return True

        while not done():
            if time.monotonic() > deadline or any(nd.cs._stopped.is_set() for nd in net.nodes):
                raise AssertionError(
                    f"tcp: heights {[nd.cs.sm_state.last_block_height for nd in net.nodes]}, "
                    f"stopped {[nd.cs.halt_error for nd in net.nodes if nd.cs._stopped.is_set()]}")
            time.sleep(0.05)
        wall = time.perf_counter() - net.t_start
        low = min(nd.cs.sm_state.last_block_height for nd in net.nodes)
        stopped = [nd.idx for nd in net.nodes if nd.cs._stopped.is_set()]
    finally:
        net.stop()
    return {"mesh_s": mesh_s, "wall_s": wall, "height": low, "duplicate_vote": ev,
            "stopped": stopped, **net.outcome(txs, low)}


def tcp_leg(dev, card, counts: dict, home, seed: int, mul_rate: float) -> dict:
    """(a): 4 validators over TCP, each with the consensus, mempool, evidence
    and PEX reactors, executors on `dev` at the calibrated dispatch: PEX
    meshes them from node 0's address, TCP_TXS kvstore txs submitted at
    node 3 and one equivocation at node 0 are committed, to TCP_HEIGHT at
    least. Then again with the NATIVE_MAX seam at 0, so that every last
    commit is checked on the ladder, to TCP_PINNED_HEIGHT; the first full
    last commit's verifier is held against the plain versions at its bucket
    (`batch_window_check`)."""
    from cometbft_tpu_torch.crypto import ed25519 as E
    from cometbft_tpu_torch.utils.metrics import consensus_metrics

    txs = [b"tcp-k%03d=v%03d" % (i, i) for i in range(TCP_TXS)]
    cm = consensus_metrics()
    before = cm.block_interval_seconds.snapshot()
    net = TcpNet(TCP_NODES, home / "a", exec_kws=[{"device": dev}] * TCP_NODES, seed=seed)
    res, routes = counted_leg(counts, "network", "tcp", lambda: run_tcp_net(
        net, txs, TCP_HEIGHT, TCP_TIMEOUT_S, evidence_from=(0, 1)))
    ev = res.pop("duplicate_vote")
    per_node = [len(e) for e in res["evidence"]]
    if res["stopped"] or res["missing_txs"] or per_node != [1] * TCP_NODES or len(
            {tuple(e) for e in res["evidence"]}) != 1 or res["evidence"][0][0][1] != ev.hash().hex():
        raise AssertionError(f"tcp, (a): stopped {res['stopped']}, txs missing "
                             f"{res['missing_txs']}, evidence by node {res['evidence']} "
                             f"(want {ev.hash().hex()} once)")
    count, total = histogram_delta(before, cm.block_interval_seconds.snapshot()).get((), (0, 0.0))
    res.update(routes=routes, blocks_per_s=res["height"] / res["wall_s"],
               block_interval_ms=total / count * 1e3 if count else None,
               evidence_height=ev.height, evidence_block=res["evidence"][0][0][0])

    kept = []
    submit = E.Ed25519BatchVerifier.submit

    def keep_first(bv):
        if not kept and bv.count() >= TCP_NODES - 1:
            copy = E.Ed25519BatchVerifier(dev)
            copy.absorb(bv)
            kept.append(copy)
        return submit(bv)

    pinned = TcpNet(TCP_NODES, home / "pinned", exec_kws=[{"device": dev}] * TCP_NODES,
                    seed=seed)
    saved, E.NATIVE_MAX = E.NATIVE_MAX, 0
    E.Ed25519BatchVerifier.submit = keep_first
    try:
        res2, routes2 = counted_leg(counts, "network", "tcp_pinned", lambda: run_tcp_net(
            pinned, [], TCP_PINNED_HEIGHT, TCP_TIMEOUT_S), need=("decompress", "ladder_sub_mul8"))
    finally:
        E.NATIVE_MAX = saved
        E.Ed25519BatchVerifier.submit = submit
    if res2["stopped"] or not kept:
        raise AssertionError(f"tcp, pinned: stopped {res2['stopped']}, kept {len(kept)}")
    res2.pop("duplicate_vote")
    res2["routes"] = routes2
    res2["window_check"] = batch_window_check(dev, card, kept[0], "tcp last commit",
                                              TCP_CHECK_BAD_LANE, mul_rate)
    res["pinned"] = res2
    log(f"network, (a) {TCP_NODES} validators over TCP on {dev}: PEX full mesh from node 0's "
        f"address in {res['mesh_s']:.3f} s; height {res['height']} in {res['wall_s']:.3f} s "
        f"({res['blocks_per_s']:.2f} blocks/s, block interval {res['block_interval_ms']:.1f} ms), "
        f"same block and app hashes on every node, {TCP_TXS} txs from node 3 committed and read "
        f"back everywhere, the equivocation at height {ev.height} committed once in block "
        f"{res['evidence_block']} on every node, no node stopped; routes {routes}; pinned to "
        f"the ladder: height {res2['height']} in {res2['wall_s']:.3f} s, routes {routes2}, "
        f"the kept {res2['window_check']['lanes']}-lane last commit exact at bucket "
        f"{res2['window_check']['bucket']} [{card}]")
    return res


def gossip_leg(dev, card, counts: dict, stream, tap) -> dict:
    """(b): a raw peer sends phase 8's signed stream to node B over TCP in
    mempool frames of GOSSIP_FRAME_TXS; B admits through its
    AdmissionPipeline at window BIG_WINDOW on `dev` and gossips what it
    admitted to node C (the same node config). B's outcome of each tx must
    be expected_ingest_outcome's, C's pool B's, and no tx B refused may
    reach C."""
    from cometbft_tpu_torch.abci import KVStoreApp
    from cometbft_tpu_torch.abci.types import CheckTxResult
    from cometbft_tpu_torch.encoding import proto as pb
    from cometbft_tpu_torch.mempool.reactor import MEMPOOL_CHANNEL, MempoolReactor
    from cometbft_tpu_torch.p2p import ChannelDescriptor, Reactor

    txs, bad = stream
    want = expected_ingest_outcome(txs, bad, MEMPOOL_SIZE, MAX_TX_BYTES)
    refused = {tx for tx, w in zip(txs, want) if w is not None} - {
        tx for tx, w in zip(txs, want) if w is None}

    class Raw(Reactor):
        def channels(self):
            return [ChannelDescriptor(MEMPOOL_CHANNEL, priority=5)]

        def add_peer(self, peer):
            pass

        def remove_peer(self, peer, reason):
            pass

        def receive(self, chan_id, peer, msg):
            pass

    nodes = {}
    for name in ("b", "c"):
        mp = ingest_node(once_app(KVStoreApp, CheckTxResult), dev, tenant=f"gossip-{name}",
                         window=BIG_WINDOW, delay_s=BIG_DELAY_S)
        got, orig = [], mp.submit_tx

        def submit(tx, from_peer="", _orig=orig, _got=got):
            fut = _orig(tx, from_peer=from_peer)
            _got.append((from_peer, tx, fut))
            return fut

        mp.submit_tx = submit
        nodes[name] = (mp, MempoolReactor(mp), got)
    net = SyncNet(INGEST_CHAIN, 0)
    gossiped = []
    try:
        sw_raw = net.node(Raw(), "raw")
        raw_id = sw_raw.transport.node_info.node_id
        sw_b = net.node(nodes["b"][1], "gossip-b")
        sw_c = net.node(nodes["c"][1], "gossip-c")
        for sw, r in ((sw_b, nodes["b"][1]), (sw_c, nodes["c"][1])):
            r.set_switch(sw)
        queue = sw_b.queue_broadcast
        sw_b.queue_broadcast = lambda chan, msg: (gossiped.append(len(msg)), queue(chan, msg))
        host, port = sw_b.transport.node_info.listen_addr.split(":")
        sw_c.dial_peer(host, int(port))
        peer_b = sw_raw.dial_peer(host, int(port))
        frames = [b"".join(pb.f_bytes(1, tx, emit_empty=True)
                           for tx in txs[i:i + GOSSIP_FRAME_TXS])
                  for i in range(0, len(txs), GOSSIP_FRAME_TXS)]
        mp_b, _, got_b = nodes["b"]
        mp_c, _, got_c = nodes["c"]
        tap.mark()

        def run():
            t = time.perf_counter()
            for f in frames:
                peer_b.send(MEMPOOL_CHANNEL, f)
            deadline = time.monotonic() + GOSSIP_TIMEOUT_S
            while (sum(p == raw_id for p, _, _ in got_b) < len(txs)
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            outcomes = future_outcomes([f for p, _, f in got_b if p == raw_id])
            admitted_s = time.perf_counter() - t
            n_b = mp_b.size()
            while mp_c.size() < n_b and time.monotonic() < deadline:
                time.sleep(0.01)
            future_outcomes([f for _, _, f in got_c])
            return outcomes, admitted_s, time.perf_counter() - t

        (got, admitted_s, wall), routes = counted_leg(counts, "network", "gossip", run,
                                                      need=("decompress", "ladder_sub_mul8"))
        cipher = net.cipher()
        net.stop()
        for mp, _, _ in nodes.values():
            mp.close()  # the drainers' last windows' spans are written
        check_ingest("(b) gossip at B", got, want)
        pool_b, pool_c = mp_b.reap_max_txs(-1), mp_c.reap_max_txs(-1)
        leaked = sum(tx in refused for _, tx, _ in got_c)
        if pool_c != pool_b or leaked:
            raise AssertionError(f"network, (b): C holds {len(pool_c)} txs, B {len(pool_b)}, "
                                 f"equal {pool_c == pool_b}; {leaked} refused txs reached C")
        spans = {k: [s for s in tap.spans("mempool.admit_window")
                     if s["tenant"] == f"gossip-{k}"] for k in ("b", "c")}
        admitted = sum(o is None for o in got)
        res = {"txs": len(txs), "frames": len(frames), "admitted": admitted,
               "wall_s": wall, "admitted_s": admitted_s, "admitted_per_s": admitted / admitted_s,
               "routes": routes, "windows": {k: [s["n"] for s in v] for k, v in spans.items()},
               "window_stats": window_stats(spans["b"]), "gossip_frames": len(gossiped),
               "gossip_bytes": sum(gossiped), "pool": len(pool_c), "c_received": len(got_c),
               **cipher}
    finally:
        net.stop()
        for mp, _, _ in nodes.values():
            mp.close()
    log(f"network, (b) gossip: {len(txs)} signed txs in {len(frames)} frames from a raw peer "
        f"to B over TCP, {admitted} admitted at B in {admitted_s:.3f} s "
        f"({res['admitted_per_s']:.0f} txs/s, each outcome as expected_ingest_outcome), "
        f"windows {res['windows']}; B gossiped {res['gossip_frames']} frames, "
        f"{res['gossip_bytes']} B, to C, whose pool equals B's ({len(pool_c)} txs, no refused "
        f"tx received); routes {routes}; wire {res['bytes']} B sealed [{card}]")
    return res


class TimedProvider:
    """A provider whose calls are timed: all of them, or those of `names`
    only (the others pass through). `worst` is the longest call."""

    def __init__(self, inner, names=None):
        self.inner, self.names = inner, names
        self.seconds, self.calls, self.worst = 0.0, 0, 0.0

    def __getattr__(self, name):
        fn = getattr(self.inner, name)
        if self.names is not None and name not in self.names:
            return fn

        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                took = time.perf_counter() - t
                self.seconds += took
                self.calls += 1
                self.worst = max(self.worst, took)

        return timed


def state_source(store, genesis, top: int, interval: int):
    """A state-sync source for `store` served to `top`: the host's replay of
    blocks 1..top - 1 into KVStoreApp(snapshot_interval=interval), each
    state saved in a StateStore (the validator sets of heights 1..top).
    Returns (the app, the state store, the state reached, seconds)."""
    from cometbft_tpu_torch.abci import KVStoreApp
    from cometbft_tpu_torch.storage import MemKV, StateStore

    t0 = time.perf_counter()
    app, ss = KVStoreApp(snapshot_interval=interval, chunk_size=SS_CHUNK_BYTES), StateStore(MemKV())
    state = host_state(store, genesis, top - 1, app=app, state_store=ss)
    return app, ss, state, time.perf_counter() - t0


def statesync_leg(dev, card, counts: dict, leg: str, chain_id: str, store, genesis, top: int,
                  source, liar: bool = False) -> dict:
    """One fresh node state-syncs from a source over TCP, then block-syncs to
    its tip. The source serves `store` up to `top` (snapshots, chunks and
    light blocks through its StateSyncReactor, blocks through a
    BlockSyncReactor); `source` is `state_source`'s. The syncing node restores
    through StateSyncReactor, Syncer, LightStateProvider and
    LightClient(device=dev) over P2PLightProvider (trusting block 1's
    hash), saves the verified commit, and block-syncs on `dev`. With
    `liar`, a second peer advertises a snapshot at SS_LIAR_HEIGHT of
    another state first: it must be refused with SS_LIAR_ERROR. The app
    restored must have the snapshot's height and the header's app hash,
    and at the tip the app's state bytes and the node's state (all but the
    heights of the last validator and params changes, which a restore
    sets to its own) must equal the source's."""
    import dataclasses

    from cometbft_tpu_torch.abci import AppConns, KVStoreApp
    from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor
    from cometbft_tpu_torch.light import LightClient
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.statesync import LightStateProvider, SnapshotPool, Syncer
    from cometbft_tpu_torch.statesync.reactor import P2PLightProvider, StateSyncReactor
    from cometbft_tpu_torch.statesync.snapshots import Snapshot
    from cometbft_tpu_torch.storage import BlockStore, MemKV
    from cometbft_tpu_torch.types import Timestamp

    app, source_ss, want, source_s = source
    snap_h = max(s.height for s in app.list_snapshots())
    view = StoreView(store, top)
    out = {"source_s": source_s, "snapshot_height": snap_h, "tip": top - 1}

    net = SyncNet(chain_id, 0)
    try:
        serving = StateSyncReactor(AppConns(app).snapshot, None, block_store=view,
                                   state_store=source_ss)
        sw_src = net.node(serving, f"{leg}-source")
        sw_src.add_reactor(BlockSyncReactor(view))
        if liar:
            fake = KVStoreApp(chunk_size=SS_CHUNK_BYTES)
            fake.store = {b"evil": b"data"}
            fake.height = SS_LIAR_HEIGHT
            fake._take_snapshot()
            sw_liar = net.node(StateSyncReactor(AppConns(fake).snapshot, None), f"{leg}-liar")
            sw_liar.add_reactor(BlockSyncReactor(BlockStore(MemKV())))
        target = KVStoreApp()
        conns = AppConns(target)
        tstore = BlockStore(MemKV())
        pool = SnapshotPool()
        syncing = StateSyncReactor(conns.snapshot, pool)
        bsync = BlockSyncReactor(tstore, executor=BlockExecutor(conns, device=dev), device=dev)
        sw = net.node(syncing, f"{leg}-target")
        sw.add_reactor(bsync)
        t0 = time.perf_counter()
        deadline = time.monotonic() + 60
        if liar:  # the liar's offer first: it is tried first at any height
            net.connect(sw, syncing, sw_liar)
            while pool.best() is None and time.monotonic() < deadline:
                time.sleep(0.01)
        net.connect(sw, syncing, sw_src)
        honest = next(Snapshot(s.height, s.format, s.chunks, s.hash, s.metadata)
                      for s in app.list_snapshots() if s.height == snap_h)
        while not pool.peers(honest) and time.monotonic() < deadline:
            time.sleep(0.01)
        out["discovery_s"] = time.perf_counter() - t0
        best = pool.best()
        if best is None or best.height != (SS_LIAR_HEIGHT if liar else snap_h):
            raise AssertionError(f"statesync, {leg}: the pool's best snapshot {best}")

        fetcher = TimedProvider(P2PLightProvider(syncing, chain_id), names=("light_block",))
        lc = LightClient(chain_id, fetcher, device=dev, trusting_period_s=TRUST_PERIOD_S)
        provider = TimedProvider(LightStateProvider(
            lc, chain_id, now=Timestamp.from_unix_ns(LIGHT_NOW_S * 10**9)))
        syncer = Syncer(conns.snapshot, provider, syncing.fetch_chunk, pool=pool,
                        chunk_timeout=30.0)

        def restore():
            t = time.perf_counter()
            lc.initialize(1, store.load_block(1).header.hash())
            provider.seconds += time.perf_counter() - t
            return syncer.sync_any()

        t0 = time.perf_counter()
        (state, commit), routes = counted_leg(counts, "network", f"{leg}_restore", restore)
        restore_s = time.perf_counter() - t0
        header_hash = store.load_block(snap_h + 1).header.app_hash
        rejected = [(s.height, (type(e).__name__, str(e))) for s, e in syncer.rejected]
        want_rejected = [(SS_LIAR_HEIGHT, SS_LIAR_ERROR)] if liar else []
        if (state.last_block_height, target.height) != (snap_h, snap_h) or \
                target.app_hash != header_hash or state.app_hash != header_hash or \
                rejected != want_rejected:
            raise AssertionError(f"statesync, {leg}: restored height {state.last_block_height} "
                                 f"(app {target.height}), want {snap_h}; app hash equal to "
                                 f"header {snap_h + 1}'s {target.app_hash == header_hash}; "
                                 f"rejected {rejected}, want {want_rejected}")
        out.update(restore_s=restore_s, restore_routes=routes, rejected=rejected,
                   light_s=provider.seconds, light_blocks=len(lc.store.heights()),
                   light_heights=lc.store.heights(), chunk_s=restore_s - provider.seconds,
                   fetch_s=fetcher.seconds, fetches=fetcher.calls, fetch_worst_s=fetcher.worst,
                   verify_s=provider.seconds - fetcher.seconds,
                   chunks=next(s.chunks for s in app.list_snapshots() if s.height == snap_h))
        out["light_ms_a_block"] = provider.seconds * 1e3 / max(1, out["light_blocks"])
        out["fetch_ms_a_block"] = fetcher.seconds * 1e3 / max(1, fetcher.calls)

        tstore.save_seen_commit(state.last_block_height, commit)
        bsync.state = state
        t0 = time.perf_counter()
        final, routes = counted_leg(counts, "network", f"{leg}_blocksync",
                                    lambda: bsync.sync(timeout_s=SS_TIMEOUT_S))
        out.update(blocksync_s=time.perf_counter() - t0, blocksync_routes=routes,
                   blocks=final.last_block_height - snap_h)
        same = dataclasses.replace(
            final, last_height_validators_changed=want.last_height_validators_changed,
            last_height_params_changed=want.last_height_params_changed).encode() == want.encode()
        if final.last_block_height != top - 1 or not same or \
                target._serialize_state() != app._serialize_state():
            raise AssertionError(f"statesync, {leg}: tip {final.last_block_height}, want "
                                 f"{top - 1}; state equal to the source's {same}; app state "
                                 f"bytes equal {target._serialize_state() == app._serialize_state()}")
        out["changed_heights"] = (final.last_height_validators_changed,
                                  final.last_height_params_changed)
        out.update(net.cipher())
    finally:
        net.stop()
    both = (counts[f"{leg}_restore"], counts[f"{leg}_blocksync"])
    out["launches"] = {k: sum(c[k] for c in both) for k in both[0] if any(c[k] for c in both)}
    return out


def statesync_phase(dev, card, counts: dict, chains, mul_rate: float) -> dict:
    """(c): (c1) phase 7's chain (1,000 validators) served to SS_C1_TOP with
    the NATIVE_MAX seam at 0 and the delta seam off, so that every check
    takes the ladder on the card; the first light check's verifier is held
    against the plain versions at its bucket, with lane SS_C1_CHECK_BAD_LANE
    the tampered one (`batch_window_check`); (c2) phase 10 (b2)'s
    10,000-validator chain at the calibrated dispatch; (c3) (c1) with a
    liar whose snapshot the verified header refutes, at the calibrated
    dispatch."""
    from cometbft_tpu_torch.crypto import ed25519 as E

    (store7, genesis7), (store10, genesis10) = chains
    out = {}
    source7 = state_source(store7, genesis7, SS_C1_TOP, SS_C1_INTERVAL)
    kept, submit = [], E.Ed25519BatchVerifier.submit

    def keep_first(bv):
        if not kept and E._bucket(bv.count()) == SS_C1_CHECK_BUCKET:
            copy = E.Ed25519BatchVerifier(dev)
            copy.absorb(bv)
            kept.append(copy)
        return submit(bv)

    saved = E.NATIVE_MAX, E._delta_beats_prehashed
    E.NATIVE_MAX, E._delta_beats_prehashed = 0, lambda n, b, device: False
    try:
        E.Ed25519BatchVerifier.submit = keep_first
        try:
            out["c1"] = statesync_leg(dev, card, counts, "c1", REPLAY_CHAIN, store7, genesis7,
                                      SS_C1_TOP, source7)
        finally:
            E.Ed25519BatchVerifier.submit = submit
        routes = {k for r in ("restore_routes", "blocksync_routes")
                  for k in out["c1"][r]} - {"batch"}
        if routes != {"ladder"} or not kept:
            raise AssertionError(f"statesync, (c1): routes {routes}, want the ladder alone; "
                                 f"a light check at bucket {SS_C1_CHECK_BUCKET} kept: {bool(kept)}")
        out["c1"]["window_check"] = batch_window_check(
            dev, card, kept[0], "state-sync light check (c1)", SS_C1_CHECK_BAD_LANE, mul_rate)
    finally:
        E.NATIVE_MAX, E._delta_beats_prehashed = saved
    out["c2"] = statesync_leg(dev, card, counts, "c2", SYNC_CHAIN, store10, genesis10,
                              store10.height(), state_source(store10, genesis10,
                                                             store10.height(), SS_C2_INTERVAL))
    out["c3"] = statesync_leg(dev, card, counts, "c3", REPLAY_CHAIN, store7, genesis7,
                              SS_C1_TOP, source7, liar=True)
    for leg in ("c1", "c2", "c3"):
        r = out[leg]
        if leg != "c3" and not r["launches"].get("ladder_sub_mul8"):
            raise AssertionError(f"statesync, ({leg}): no light check ran on the card: "
                                 f"launches {r['launches']}")
        log(f"network, ({leg}) state sync over TCP on {dev}: snapshot {r['snapshot_height']} "
            f"({r['chunks']} chunks) restored, then block sync of {r['blocks']} blocks to "
            f"{r['tip']}, the app state bytes and the state the source's; discovery "
            f"{r['discovery_s']:.3f} s, light {r['light_s']:.3f} s ({r['light_blocks']} light "
            f"blocks, {r['light_ms_a_block']:.1f} ms each, heights {r['light_heights']}: "
            f"{r['fetches']} fetches {r['fetch_s']:.3f} s, {r['fetch_ms_a_block']:.1f} ms each, "
            f"worst {r['fetch_worst_s']:.3f} s; verification {r['verify_s']:.3f} s), "
            f"chunks fetched and applied {r['chunk_s']:.3f} s, block sync "
            f"{r['blocksync_s']:.3f} s; rejected {r['rejected']}; routes {r['restore_routes']} "
            f"then {r['blocksync_routes']}; launches {r['launches']}; the source's replay "
            f"{r['source_s']:.2f} s [{card}]")
    return out


def network_phase(dev, card, seed: int, kern: dict, chains, stream, mul_rate: float) -> dict:
    """Phase 11: the network reactors and state sync on the card: (a) 4
    validators over TCP with PEX, (b) tx gossip at the ingest cell's width,
    (c) state sync at 1,000 and 10,000 validators and a liar; each leg with
    the launch counts set to 0 just before it and read right after. The
    nodes' log records are counted, not printed."""
    import tempfile

    from cometbft_tpu_torch.utils import log as L
    from cometbft_tpu_torch.utils import trace

    out, counts, records = {"card": card}, {}, []
    sink = L._config.sink
    L.set_sink(lambda level, msg, fields: records.append(msg))
    tap = TraceTap(OUT_DIR / "trace_network.jsonl")
    if tap.path.exists():
        tap.path.unlink()
    trace.configure(str(tap.path))
    t_phase = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out["tcp"] = tcp_leg(dev, card, counts, Path(tmp), seed, mul_rate)
        out["gossip"] = gossip_leg(dev, card, counts, stream, tap)
        out["statesync"] = statesync_phase(dev, card, counts, chains, mul_rate)
    finally:
        trace.disable()
        L.set_sink(sink)
    out["log_records"] = len(records)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"network: phase 11 took {out['seconds']:.1f} s, {len(records)} log records [{card}]")
    out["counts"] = counts
    for name in SOURCES:
        kern[name]["launches_by_route"]["network"] = sum(c[name] for c in counts.values())
        kern[name]["launches"] += kern[name]["launches_by_route"]["network"]
    return out


# ---- phase 12: the node

NODE_CHAIN = "node-chain"
NODE_TXS = 64  # (a): kvstore txs through broadcast_tx_commit
NODE_RESTART_HEIGHTS = 3  # (a): heights committed after the restart
NODE_PROCS = 4  # (b)
NODE_PROC_HEIGHT = 6
NODE_PROC_TXS = 256  # (b): broadcast_tx_sync at the last node
NODE_SOURCE_TOP = 5  # (c): the heights of phase 10 (b2)'s chain the source holds
NODE_TIMEOUT_S = 120.0  # each wait of the phase


def free_port_base(n: int) -> int:
    """A port p with p .. p + n - 1 free on 127.0.0.1."""
    import random
    import socket

    rnd = random.Random()
    for _ in range(200):
        base, socks = rnd.randrange(20_000, 60_000 - n), []
        try:
            for port in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise AssertionError(f"node: no {n} free consecutive ports on 127.0.0.1")


def rpc(addr, method: str, timeout: float = 60.0, **params):
    """One JSON-RPC call to the node at `addr` (host, port)."""
    from cometbft_tpu_torch.rpc.client import HTTPClient

    return HTTPClient(f"http://{addr[0]}:{addr[1]}", timeout=timeout).call(method, params)


def wait_for(what: str, pred, timeout_s: float, poll_s: float = 0.1, procs=()):
    """Poll `pred` until it returns a true value (an exception counts as
    false); fail at the deadline, or at once if one of `procs` exited."""
    deadline = time.monotonic() + timeout_s
    last = None
    while time.monotonic() < deadline:
        for p in procs:
            if p.poll() is not None:
                raise AssertionError(f"node: a node process exited {p.returncode} while "
                                     f"waiting for {what}")
        try:
            got = pred()
            if got:
                return got
        except Exception as e:  # noqa: BLE001 - not up yet
            last = e
        time.sleep(poll_s)
    raise AssertionError(f"node: timed out after {timeout_s:.0f} s waiting for {what}"
                         + (f" (last error: {last})" if last else ""))


class WsSubscriber:
    """A websocket client of a node's RPC (RFC 6455, masked text frames):
    one `subscribe`, acknowledged before the constructor returns; a reader
    thread keeps every event the node pushes."""

    def __init__(self, addr, query: str):
        import base64
        import socket
        import threading

        self.sock = socket.create_connection(addr, timeout=30)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((f"GET /websocket HTTP/1.1\r\nHost: {addr[0]}:{addr[1]}\r\n"
                           "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                           f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n"
                           ).encode())
        head = b""
        while not head.endswith(b"\r\n\r\n"):
            head += self._recv_exact(1)
        if b" 101 " not in head.split(b"\r\n")[0]:
            raise AssertionError(f"websocket: no upgrade: {head[:80]!r}")
        self.sock.settimeout(None)
        self.msgs = []
        self._acked = threading.Event()
        self._send({"jsonrpc": "2.0", "id": 1, "method": "subscribe",
                    "params": {"query": query}})
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()
        if not self._acked.wait(30):
            raise AssertionError(f"websocket: subscribe {query!r} not acknowledged")

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("websocket closed")
            buf += chunk
        return buf

    def _send(self, obj) -> None:
        payload = json.dumps(obj).encode()
        mask, n = os.urandom(4), len(payload)
        head = bytes([0x81]) + (bytes([0x80 | n]) if n < 126
                                else bytes([0x80 | 126]) + n.to_bytes(2, "big"))
        self.sock.sendall(head + mask + bytes(b ^ mask[i % 4] for i, b in enumerate(payload)))

    def _read(self) -> None:
        try:
            while True:
                b0, b1 = self._recv_exact(2)
                n = b1 & 0x7F
                if n == 126:
                    n = int.from_bytes(self._recv_exact(2), "big")
                elif n == 127:
                    n = int.from_bytes(self._recv_exact(8), "big")
                data = self._recv_exact(n)
                if b0 & 0x0F == 0x1:
                    msg = json.loads(data)
                    if msg.get("id") == 1:
                        self._acked.set()
                    else:
                        self.msgs.append(msg)
        except (OSError, ValueError):
            return

    def heights(self) -> list:
        """The block heights of the NewBlock events received, in order."""
        return [int(m["result"]["data"]["block_height"]) for m in list(self.msgs)
                if "result" in m]

    def close(self) -> None:
        import socket

        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def node_config(home: Path, device, p2p: str, rpc_laddr: str, peers: str = "",
                rate: int | None = None):
    """The home's config.toml as `init` or `testnet` wrote it, with the
    listen addresses, the peers, (off the card) the backend and, given
    `rate`, the p2p send and receive rates set, saved back; returns it with
    its home set."""
    from cometbft_tpu_torch.config import Config

    path = home / "config" / "config.toml"
    cfg = Config.load(str(path))
    cfg.base.crypto_backend = torch.device(device).type
    cfg.p2p.laddr, cfg.rpc.laddr, cfg.p2p.persistent_peers = p2p, rpc_laddr, peers
    if rate is not None:
        cfg.p2p.send_rate = cfg.p2p.recv_rate = rate
    cfg.save(str(path))
    cfg.base.home = str(home)
    return cfg


def start_process(home: Path, log_path: Path):
    """`python3 -m cometbft_tpu_torch.cli --home HOME start`, from this
    checkout, its output to `log_path`."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (str(ROOT), env.get("PYTHONPATH"))))
    with open(log_path, "wb") as fh:
        return subprocess.Popen(
            [sys.executable, "-m", "cometbft_tpu_torch.cli", "--home", str(home), "start"],
            cwd=str(ROOT), env=env, stdout=fh, stderr=subprocess.STDOUT)


def stop_processes(procs, logs) -> list:
    """SIGTERM each process and wait for it; the exit codes (None for one
    that had to be killed). A process that did not exit with 0 is an error,
    its log's tail in the message."""
    import signal

    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=60))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rcs.append(None)
    for rc, path in zip(rcs, logs):
        if rc != 0:
            tail = Path(path).read_text(errors="replace")[-3000:]
            raise AssertionError(f"node: the process of {path} exited {rc}:\n{tail}")
    return rcs


def node_single_leg(dev, card, home: Path) -> dict:
    """Phase 12 (a): one node from `cli init` with the config's defaults, in
    this process with its RPC listener; NODE_TXS txs through HTTP
    broadcast_tx_commit, each read back by abci_query and by `tx` with its
    proof checked against the block's data hash; a websocket NewBlock
    subscription gets one event a height; then a new Node on the same home
    (the handshake and the WAL) commits NODE_RESTART_HEIGHTS more."""
    import base64
    from concurrent.futures import ThreadPoolExecutor

    from cometbft_tpu_torch import cli
    from cometbft_tpu_torch.abci.kvstore import KVStoreApp
    from cometbft_tpu_torch.crypto import merkle
    from cometbft_tpu_torch.crypto.keys import tmhash
    from cometbft_tpu_torch.node import Node

    if cli.main(["--home", str(home), "init", "--chain-id", NODE_CHAIN]) != 0:
        raise AssertionError("node, (a): cli init failed")
    cfg = node_config(home, dev, "tcp://127.0.0.1:0", "tcp://127.0.0.1:0")
    defaults = (cfg.base.db_backend, cfg.mempool.admission_window, cfg.sched.enabled)
    if defaults != ("sqlite", 256, True):
        raise AssertionError(f"node, (a): init's config is not the defaults: {defaults}")
    out = {}
    t_start = time.perf_counter()
    node = Node(cfg, app=KVStoreApp())
    node.start()
    try:
        addr = node.rpc_addr
        ws = WsSubscriber(addr, "tm.event = 'NewBlock'")
        h0 = node.block_store.height()
        txs = [f"node-a-{i:03d}=value-{i}".encode() for i in range(NODE_TXS)]

        def commit(tx):
            t0 = time.perf_counter()
            r = rpc(addr, "broadcast_tx_commit", tx=tx.hex())
            return r, time.perf_counter() - t0

        t0 = time.perf_counter()
        with ThreadPoolExecutor(16) as ex:
            res = list(ex.map(commit, txs))
        out["txs_s"] = time.perf_counter() - t0
        bad = [r for r, _ in res if r.get("check_tx", {}).get("code")
               or r.get("tx_result", {}).get("code", 1)]
        if bad:
            raise AssertionError(f"node, (a): {len(bad)} txs not committed: {bad[:3]}")
        lat = np.array([dt for _, dt in res]) * 1e3
        out["commit_ms_p50"] = float(np.percentile(lat, 50))
        out["commit_ms_p99"] = float(np.percentile(lat, 99))
        for tx, (r, _) in zip(txs, res):
            key, value = tx.split(b"=")
            q = rpc(addr, "abci_query", data=key.hex())["response"]
            # the indexer takes the tx from the event bus on its own thread
            got = wait_for(f"tx {tx!r} in the index",
                           lambda: rpc(addr, "tx", hash=r["hash"], prove=True), NODE_TIMEOUT_S,
                           poll_s=0.02)
            blk = node.block_store.load_block(int(got["height"]))
            pr = got["proof"]["proof"]
            proof = merkle.Proof(int(pr["total"]), int(pr["index"]),
                                 base64.b64decode(pr["leaf_hash"]),
                                 [base64.b64decode(a) for a in pr["aunts"]])
            if (bytes.fromhex(q["value"]) != value or bytes.fromhex(got["tx"]) != tx
                    or got["height"] != r["height"]
                    or bytes.fromhex(got["proof"]["root_hash"]) != blk.header.data_hash
                    or not proof.verify(blk.header.data_hash, tmhash(tx))):
                raise AssertionError(f"node, (a): tx {tx!r} not read back: {q}, {got}")
        top = node.block_store.height()
        wait_for("a NewBlock event of every height", lambda: ws.heights()[-1:] >= [top],
                 NODE_TIMEOUT_S)
        # block h0 may have committed after the subscription: its event is not counted
        heights = [h for h in ws.heights() if h0 < h <= top]
        if heights != list(range(h0 + 1, top + 1)):
            raise AssertionError(f"node, (a): NewBlock events {heights}, want {h0 + 1}..{top}")
        ws.close()
        hashes = [node.block_store.load_block(h).hash() for h in range(1, top + 1)]
    finally:
        node.stop()
    stored = node.block_store.height()  # a block may commit between the checks and stop()
    out.update(first_run_s=time.perf_counter() - t_start, heights=stored,
               tx_heights=sorted({int(r["height"]) for r, _ in res}), ws_events=len(heights))
    out["blocks_per_s"] = stored / out["first_run_s"]

    # the restart: the handshake replays the stored blocks into a fresh app
    t0 = time.perf_counter()
    node = Node(cfg, app=KVStoreApp())
    replayed = node.handshaker.blocks_replayed
    node.start()
    try:
        wait_for(f"height {stored + NODE_RESTART_HEIGHTS} after the restart",
                 lambda: node.consensus.sm_state.last_block_height
                 >= stored + NODE_RESTART_HEIGHTS, NODE_TIMEOUT_S)
        addr = node.rpc_addr
        for tx in txs:
            key, value = tx.split(b"=")
            if bytes.fromhex(rpc(addr, "abci_query", data=key.hex())["response"]["value"]) \
                    != value:
                raise AssertionError(f"node, (a): {key!r} lost across the restart")
        if [node.block_store.load_block(h).hash() for h in range(1, top + 1)] != hashes:
            raise AssertionError("node, (a): the stored blocks changed across the restart")
        after = node.consensus.sm_state.last_block_height
    finally:
        node.stop()
    if replayed != stored:
        raise AssertionError(f"node, (a): the handshake replayed {replayed} blocks, not {stored}")
    out.update(restart_s=time.perf_counter() - t0, replayed=replayed, height_after=after)
    log(f"node, (a) one node: {NODE_TXS} txs by broadcast_tx_commit in {out['txs_s']:.2f} s "
        f"(p50 {out['commit_ms_p50']:.1f} ms, p99 {out['commit_ms_p99']:.1f} ms, in blocks "
        f"{out['tx_heights']}), each read back by abci_query and tx with its proof; "
        f"{len(heights)} NewBlock events, one a height; {stored} heights in "
        f"{out['first_run_s']:.2f} s ({out['blocks_per_s']:.3f} blocks/s); the restart "
        f"replayed {replayed} blocks and reached height {after} in {out['restart_s']:.2f} s "
        f"[{card}]")
    return out


def node_procs_leg(dev, card, root: Path, log_dir: Path) -> dict:
    """Phase 12 (b): NODE_PROCS homes from `cli testnet`, each node its own
    process (`python3 -m cometbft_tpu_torch.cli start`): the chain runs to
    NODE_PROC_HEIGHT with every node's /block hash and app hash equal at
    every height and the /status app hashes equal; NODE_PROC_TXS txs by
    broadcast_tx_sync at the last node, each found by `tx` on node 0; every
    process exits 0 on SIGTERM."""
    from cometbft_tpu_torch import cli

    base = free_port_base(2 * NODE_PROCS)
    net = root / "testnet"
    if cli.main(["testnet", "--v", str(NODE_PROCS), "--output", str(net), "--chain-id",
                 NODE_CHAIN + "-procs", "--starting-port", str(base)]) != 0:
        raise AssertionError("node, (b): cli testnet failed")
    homes = [net / f"node{i}" for i in range(NODE_PROCS)]
    addrs = [("127.0.0.1", base + 2 * i + 1) for i in range(NODE_PROCS)]
    if torch.device(dev).type != "cuda":  # the CPU rehearsal
        for i, home in enumerate(homes):
            node_config(home, dev, f"tcp://127.0.0.1:{base + 2 * i}",
                        f"tcp://127.0.0.1:{base + 2 * i + 1}",
                        ",".join(f"127.0.0.1:{base + 2 * j}" for j in range(NODE_PROCS)
                                 if j != i))
    logs = [log_dir / f"node_proc{i}.log" for i in range(NODE_PROCS)]
    t0 = time.perf_counter()
    procs = [start_process(h, lg) for h, lg in zip(homes, logs)]
    out = {}
    try:
        def heights():
            return [int(rpc(a, "status", timeout=5)["sync_info"]["latest_block_height"])
                    for a in addrs]

        wait_for("height 1 on every node", lambda: min(heights()) >= 1, NODE_TIMEOUT_S,
                 procs=procs)
        out["first_block_s"] = time.perf_counter() - t0
        txs = [f"node-b-{i:03d}=value-{i}".encode() for i in range(NODE_PROC_TXS)]
        hashes = []
        for tx in txs:
            r = rpc(addrs[-1], "broadcast_tx_sync", tx=tx.hex())
            if r["code"]:
                raise AssertionError(f"node, (b): broadcast_tx_sync refused {tx!r}: {r}")
            hashes.append(r["hash"])
        missing = set(hashes)

        def found():
            for h in list(missing):
                try:
                    rpc(addrs[0], "tx", timeout=5, hash=h)
                    missing.discard(h)
                except RuntimeError:
                    pass
            return not missing and min(heights()) >= NODE_PROC_HEIGHT

        wait_for(f"height {NODE_PROC_HEIGHT} and every tx on node 0", found, NODE_TIMEOUT_S,
                 poll_s=0.5, procs=procs)
        top = min(heights())
        blocks = [[rpc(a, "block", height=h) for a in addrs] for h in range(1, top + 1)]
        for h, per_node in enumerate(blocks, 1):
            ids = {b["block_id"]["hash"] for b in per_node}
            apps = {b["block"]["header"]["app_hash"] for b in per_node}
            if len(ids) != 1 or len(apps) != 1:
                raise AssertionError(f"node, (b): the nodes differ at height {h}: {ids}, {apps}")

        def same_status():
            st = [rpc(a, "status")["sync_info"] for a in addrs]
            if len({s["latest_block_height"] for s in st}) != 1:
                return None
            return {s["latest_app_hash"] for s in st}

        apps = wait_for("/status at one height on every node", same_status, NODE_TIMEOUT_S,
                        poll_s=0.05, procs=procs)
        if len(apps) != 1:
            raise AssertionError(f"node, (b): /status app hashes differ: {apps}")
        # block 1's time is the genesis time: the interval runs from block 2
        times = [b[0]["block"]["header"]["time"] for b in blocks[1:]]
        t_ns = [int(t["seconds"]) * 10**9 + int(t["nanos"]) for t in times]
        out.update(height=top, txs=len(txs), run_s=time.perf_counter() - t0,
                   block_interval_s=(t_ns[-1] - t_ns[0]) / 1e9 / (top - 2))
        out["blocks_per_s"] = 1 / out["block_interval_s"]
    finally:
        out["exit_codes"] = stop_processes(procs, logs)
    log(f"node, (b) {NODE_PROCS} node processes: first block {out['first_block_s']:.2f} s after "
        f"the launch; heights 1-{out['height']} equal on every node (block hash, app hash, "
        f"/status), {out['txs']} txs sent at node {NODE_PROCS - 1} all found on node 0; block "
        f"interval {out['block_interval_s']:.3f} s ({out['blocks_per_s']:.3f} blocks/s, "
        f"header times), exit codes {out['exit_codes']} on SIGTERM; the 4-signature last "
        f"commits take the native route by design (under NATIVE_MAX) [{card}]")
    return out


def genesis_doc_of(genesis):
    """The GenesisDoc whose genesis state is `genesis` (a make_chain
    chain's), checked byte for byte."""
    from cometbft_tpu_torch.state.execution import make_genesis_state
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    gd = GenesisDoc(
        chain_id=genesis.chain_id, genesis_time=genesis.last_block_time,
        initial_height=genesis.initial_height,
        validators=[GenesisValidator(v.pub_key.bytes(), v.voting_power)
                    for v in genesis.validators.validators])
    back = make_genesis_state(gd.chain_id, gd.validator_set(), app_hash=gd.app_hash,
                              initial_height=gd.initial_height, genesis_time=gd.genesis_time,
                              consensus_params=gd.consensus_params)
    if back.encode() != genesis.encode():
        raise AssertionError("node: the genesis document does not give the chain's genesis")
    return gd


def node_catchup_leg(dev, card, counts: dict, root: Path, log_dir: Path, chain) -> dict:
    """Phase 12 (c): a source node process (`cli start`) on a home holding
    the first NODE_SOURCE_TOP heights of `chain` (sqlite block and state
    stores, the genesis of its validators), its handshake replaying them
    into its app; a fresh Node in this process, `persistent_peers` the
    source, catches up through Node.start()'s block-sync hand-off with the
    calibrated dispatch. Its state at the tip must be the host's, its
    /commit of the tip all the signatures, and `decompress` with the ladder
    or `accum_weight` must have launched. Both nodes run with the p2p rate
    limits off, as phase 10 (b2): a block of 10,000 signatures is ~1.1 MB,
    and at the default 512,000 B/s, with the pool's 5 s re-requests, four
    of them would take most of Node.start()'s 30 s."""
    from cometbft_tpu_torch import cli
    from cometbft_tpu_torch.abci.kvstore import KVStoreApp
    from cometbft_tpu_torch.node import Node
    from cometbft_tpu_torch.storage import BlockStore, SqliteKV, StateStore

    store, genesis = chain
    top = NODE_SOURCE_TOP
    n_vals = len(genesis.validators.validators)
    gd = genesis_doc_of(genesis)
    src, dst = root / "source", root / "catchup"
    for home in (src, dst):
        if cli.main(["--home", str(home), "init", "--chain-id", genesis.chain_id]) != 0:
            raise AssertionError("node, (c): cli init failed")
        gd.save(str(home / "config" / "genesis.json"))
    t0 = time.perf_counter()
    bkv, skv = SqliteKV(str(src / "data" / "blockstore.db")), SqliteKV(str(src / "data" /
                                                                           "state.db"))
    bs = BlockStore(bkv)
    for h in range(1, top + 1):
        bs.save_block(store.load_block(h), store.load_seen_commit(h))
    source_state = host_state(store, genesis, top, state_store=StateStore(skv))
    bkv.close()
    skv.close()
    want = host_state(store, genesis, top - 1).encode()
    out = {"validators": n_vals, "home_s": time.perf_counter() - t0}
    port = free_port_base(2)
    node_config(src, dev, f"tcp://127.0.0.1:{port}", f"tcp://127.0.0.1:{port + 1}", rate=0)
    cfg = node_config(dst, dev, "tcp://127.0.0.1:0", "tcp://127.0.0.1:0", f"127.0.0.1:{port}",
                      rate=0)
    logs = [log_dir / "node_source.log"]
    t0 = time.perf_counter()
    procs = [start_process(src, logs[0])]
    try:
        st = wait_for("the source's RPC", lambda: rpc(("127.0.0.1", port + 1), "status",
                                                      timeout=5)["sync_info"],
                      NODE_TIMEOUT_S, poll_s=0.2, procs=procs)
        out["source_boot_s"] = time.perf_counter() - t0
        if (int(st["latest_block_height"]) != top
                or bytes.fromhex(st["latest_app_hash"]) != source_state.app_hash):
            raise AssertionError(f"node, (c): the source's handshake gave {st}")
        node = Node(cfg, app=KVStoreApp())
        try:
            def catch_up():
                t = time.perf_counter()
                node.start()
                return time.perf_counter() - t, node.consensus.sm_state

            (start_s, state), routes = counted_leg(counts, "node", "catchup", catch_up)
            c = counts["catchup"]
            pool = node.blocksync_reactor.pool
            synced = ("block sync never ran: no peer when start() looked" if pool is None else
                      f"block sync stopped at height {pool.height} of the peers' "
                      f"{pool.max_peer_height()}, {len(node.blocksync_reactor.refused)} refused")
            if not c["decompress"] or not (c["ladder_sub_mul8"] or c["accum_weight"]):
                raise AssertionError(f"node, (c): no device check ran ({synced}): launches {c}")
            if state.last_block_height != top - 1 or state.encode() != want:
                raise AssertionError(f"node, (c): caught up to height "
                                     f"{state.last_block_height} (want {top - 1}), state equal "
                                     f"{state.encode() == want} ({synced})")
            # block sync stores the tip's commit as it came (block top's last
            # commit): the seen commit, since block top itself is not stored
            commit = rpc(node.rpc_addr, "commit", height=top - 1)["signed_header"]["commit"]
            sigs = [s for s in commit["signatures"] if s["signature"]]
            if (len(sigs) != n_vals or commit["block_id"]["hash"]
                    != store.load_block(top - 1).hash().hex().upper()):
                raise AssertionError(f"node, (c): /commit of {top - 1} has {len(sigs)} "
                                     f"signatures for block {commit['block_id']['hash']}")
        finally:
            node.stop()
    finally:
        out["exit_codes"] = stop_processes(procs, logs)
    out.update(start_s=start_s, blocks=top - 1, routes=routes, launches=counts["catchup"],
               blocks_per_s=(top - 1) / start_s)
    log(f"node, (c) {n_vals} validators: a source process on {top} stored heights (booted in "
        f"{out['source_boot_s']:.2f} s, its handshake to the state's app hash); a fresh Node "
        f"caught up {top - 1} blocks in Node.start() {start_s:.2f} s ({out['blocks_per_s']:.3f} "
        f"blocks/s) to the host's state, /commit {top - 1} with {n_vals} signatures; routes "
        f"{routes}, launches {({k: v for k, v in counts['catchup'].items() if v})} [{card}]")
    return out


def node_phase(dev, card, kern: dict, chain) -> dict:
    """Phase 12: the node through its entry points (`cli`, `Node`, the RPC):
    (a) one node, (b) node processes, (c) a 10,000-validator catch-up; each
    leg with the launch counts set to 0 just before it and read right after.
    The in-process nodes' log records are counted, not printed; the node
    processes' output goes to OUT_DIR/node/."""
    import tempfile

    from cometbft_tpu_torch.utils import log as L

    out, counts, records = {"card": card}, {}, []
    log_dir = OUT_DIR / "node"
    log_dir.mkdir(parents=True, exist_ok=True)
    sink = L._config.sink
    L.set_sink(lambda level, msg, fields: records.append(
        f"{time.time():.3f} {level} {msg} {fields}"))
    t_phase = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            out["single"], _ = counted_leg(counts, "node", "single",
                                           lambda: node_single_leg(dev, card, tmp / "single"))
            out["procs"], _ = counted_leg(counts, "node", "procs",
                                          lambda: node_procs_leg(dev, card, tmp, log_dir))
            out["catchup"] = node_catchup_leg(dev, card, counts, tmp, log_dir, chain)
    finally:
        L.set_sink(sink)
        (log_dir / "in_process.log").write_text("\n".join(records) + "\n")
    out["log_records"] = len(records)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"node: phase 12 took {out['seconds']:.1f} s, {len(records)} log records [{card}]")
    out["counts"] = counts
    for name in SOURCES:
        kern[name]["launches_by_route"]["node"] = sum(c[name] for c in counts.values())
        kern[name]["launches"] += kern[name]["launches_by_route"]["node"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent-sha", type=Path, default=None,
                    help="an earlier commit's csrc/sha512_kernels.cu to time beside this one's")
    args = ap.parse_args(argv)

    # ---- phase 1: the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; one CUDA GPU is needed",
              file=sys.stderr)
        return 1
    card = nvidia_smi("name,power.limit")
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    sys.path.insert(0, str(ROOT))
    from cometbft_tpu_torch.crypto import ed25519 as E
    from cometbft_tpu_torch.crypto import ed25519_ref as ref
    from cometbft_tpu_torch.crypto import rlc
    from cometbft_tpu_torch.crypto.ed25519 import collect_pending
    from cometbft_tpu_torch.crypto.testgen import generate_signed_batch
    from cometbft_tpu_torch.ops import curve as C
    from cometbft_tpu_torch.ops import ed25519_verify as V
    from cometbft_tpu_torch.ops import field as F
    from cometbft_tpu_torch.ops import kernels as K
    from cometbft_tpu_torch.ops import msm as M

    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(0)
    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    mul_rate = INT32_MUL_PER_SM_CLK * props.multi_processor_count * sm_mhz * 1e6
    int_rate = INT32_OPS_PER_SM_CLK * props.multi_processor_count * sm_mhz * 1e6
    log(f"SMs {props.multi_processor_count}, max SM clock {sm_mhz:.0f} MHz, "
        f"int32 multiply rate {mul_rate:.4g}/s")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    results = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}

    # ---- phase 2: build
    t0 = time.perf_counter()
    K.build()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s (nvcc, {len(K.LIBRARIES)} libraries in parallel)")
    report = K.ptxas_report()
    (OUT_DIR / "ptxas.txt").write_text("\n".join(f"== {k}\n{v}" for k, v in report.items()))
    ptxas_lines = [
        ln.strip() for txt in report.values() for ln in txt.splitlines()
        if "Compiling entry" in ln or "registers" in ln or "spill" in ln
    ]
    for ln in ptxas_lines:
        log("ptxas:", ln)
    regs = ptxas_per_kernel(K, report)
    for name in ("ladder_sub_mul8", "accum_weight"):
        if regs[name]["spill_bytes"]:
            raise AssertionError(f"{name} spills: {regs[name]}")
    results["build_s"] = build_s
    results["ptxas"] = ptxas_lines

    # ---- phase 3: each kernel against its plain version at the path's shapes
    rng = np.random.default_rng(args.seed)
    kern = {}
    per_lane = products_per_lane(8)  # accum_weight's is recounted at the commit's S below

    def record(name, mism, err, kernel_fn, plain_fn, reps, batch, nbytes, ops_s=None):
        """Time the kernel (CUDA events around back-to-back calls, and its
        device time alone from the profiler) and its plain version, and
        compute the bound from this call's bytes and operations (by default
        the field products' wide multiplies)."""
        ms = cuda_ms(kernel_fn, reps)
        device_ms = kernel_device_ms(kernel_fn, name, reps)
        plain_ms = cuda_ms(plain_fn, max(1, reps // 10))
        if ops_s is None:
            ops_s = wide_muls(per_lane[name]) * batch / mul_rate
        bytes_s = nbytes / HBM_BYTES_PER_S
        kern[name] = {
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "mismatches": mism, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "library_ms": None, "batch": batch, "device_only_ms": device_ms,
            **({"field_products_per_lane": {"mul": per_lane[name][0], "sq": per_lane[name][1]}}
               if name in per_lane else {}),
            **regs[name],
        }
        log(f"check {name}: B={batch} mismatches={mism} max_abs_err={err} "
            f"kernel {ms:.4f} ms (device alone {device_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"bound {kern[name]['bound_ms']:.4f} ms "
            f"({kern[name]['bound_by']})")
        if mism:
            raise AssertionError(f"{name}: {mism} lanes disagree with the plain version")

    a = torch.from_numpy(loose_limbs(rng, B)).to(dev)
    b = torch.from_numpy(loose_limbs(rng, B)).to(dev)
    got = K.fe_mul(a, b)
    check_loose("fe_mul", got)
    mism, err = frozen_diff(F, got, F.mul_plain(a, b))
    record("fe_mul", mism, err, lambda: K.fe_mul(a, b), lambda: F.mul_plain(a, b), 200, B,
           3 * 88 * B)
    got = K.fe_sq(a)
    check_loose("fe_sq", got)
    mism, err = frozen_diff(F, got, F.sq_plain(a))
    record("fe_sq", mism, err, lambda: K.fe_sq(a), lambda: F.sq_plain(a), 200, B, 2 * 88 * B)

    # decompress: random points (valid), random bytes (about half valid) and
    # the ZIP-215 edge encodings
    P = F.P_INT
    t8 = torsion_point(ref)
    encs = rng.integers(0, 256, (B, 32), dtype=np.uint8)

    def put(i, enc: bytes):
        encs[i] = np.frombuffer(enc, np.uint8)

    def with_sign(y: int) -> bytes:
        e = bytearray(y.to_bytes(32, "little"))
        e[31] |= 0x80
        return bytes(e)

    edges = [ref._encode_point(0, 1), with_sign(1), with_sign(P + 1), P.to_bytes(32, "little"),
             with_sign(P), (0).to_bytes(32, "little")]
    edges += [(P + k).to_bytes(32, "little") for k in range(19)]  # non-canonical y = p + k
    edges += [y.to_bytes(32, "little") for y in range(2, 40)]  # some have no square root
    edges += [ref._encode_point(*ref._ext_to_affine(ref._ext_scalar_mul(k, t8))) for k in range(8)]
    for i, e in enumerate(edges):
        put(i, e)
    n_pts = 512
    pts = C.compress(C.fixed_base(torch.from_numpy(C.scalar_digits(
        [int.from_bytes(rng.bytes(32), "little") % ref.L for _ in range(n_pts)])).to(dev))).cpu()
    encs[len(edges):len(edges) + n_pts] = pts.numpy()
    sign, y = C._split_encoding(torch.from_numpy(encs).to(dev))
    sign_row = sign[None, :].contiguous()
    valid, x, t = K.decompress(y, sign_row)
    check_loose("decompress x", x)
    check_loose("decompress t", t)
    pv, px, pt = C.decompress_plain(y, sign)
    want_edges = [ref._decode_point(e, zip215=True) is not None for e in edges]
    if (pv[:len(edges)].cpu().tolist() != want_edges
            or not bool(pv[len(edges):len(edges) + n_pts].all())):
        raise AssertionError("decompress plain version disagrees with the oracle")
    mism_v = int(((valid[0] != 0) != pv).sum())
    mx, ex = frozen_diff(F, x, px)
    mt, et = frozen_diff(F, t, pt)
    for n in RAGGED_LANES:
        part = K.decompress(y[:, :n].contiguous(), sign_row[:, :n].contiguous())
        if not all(torch.equal(g, f[:, :n]) for g, f in zip(part, (valid, x, t))):
            raise AssertionError(f"decompress: lanes differ between B={n} and B={B} launches")
    log(f"decompress: {int(pv.sum())}/{B} valid lanes, {len(edges)} edge encodings")
    record("decompress", mism_v + mx + mt, max(ex, et), lambda: K.decompress(y, sign_row),
           lambda: C.decompress_plain(y, sign), 20, B, (88 + 4) * B + (4 + 2 * 88) * B)

    # ladder: real points (valid decompressed lanes) and random digits
    ok_pts = torch.nonzero(pv).flatten()
    idx = ok_pts[torch.from_numpy(rng.integers(0, len(ok_pts), B)).to(dev)]
    neg_a = C.neg(tuple(c[:, idx].contiguous() for c in (px, y, F.const(1, dev).expand_as(y), pt)))
    idx_r = ok_pts[torch.from_numpy(rng.integers(0, len(ok_pts), B)).to(dev)]
    r_pt = tuple(c[:, idx_r].contiguous() for c in (px, y, F.const(1, dev).expand_as(y), pt))
    sd = torch.from_numpy(rng.integers(-8, 8, (64, B), dtype=np.int32)).to(dev)
    kd = torch.from_numpy(rng.integers(-8, 8, (64, B), dtype=np.int32)).to(dev)
    # edge lanes beside the random ones: digits all -8, all 7 and all 0;
    # identity and 8-torsion A, then identity and 8-torsion R
    for lane, v in enumerate((-8, 7, 0)):
        sd[:, lane] = v
        kd[:, lane] = v
    t8_limbs = [torch.from_numpy(F.from_int(c % P)).to(dev) for c in t8]
    ident = [torch.from_numpy(F.from_int(c)).to(dev) for c in (0, 1, 1, 0)]
    for lane, pt_, dst in ((3, ident, neg_a), (4, t8_limbs, neg_a), (5, ident, r_pt),
                           (6, t8_limbs, r_pt)):
        for c in range(4):
            dst[c][:, lane] = pt_[c]
    a4, r4 = torch.stack(neg_a), torch.stack(r_pt)
    base = C.base_niels(dev)
    n = LADDER_CHECK_LANES
    sub = K.ladder_sub_mul8(a4[..., :n].contiguous(), r4[..., :n].contiguous(),
                            sd[:, :n].contiguous(), kd[:, :n].contiguous(), base)
    check_loose("ladder_sub_mul8", sub)
    want = C.ladder_sub_mul8_plain(sd[:, :n], kd[:, :n], tuple(c[:, :n] for c in neg_a),
                                   tuple(c[:, :n] for c in r_pt))
    mism, err = frozen_diff(F, sub, torch.stack(want))
    full = K.ladder_sub_mul8(a4, r4, sd, kd, base)
    for m in RAGGED_LANES:
        part = sub if m == n else K.ladder_sub_mul8(
            a4[..., :m].contiguous(), r4[..., :m].contiguous(), sd[:, :m].contiguous(),
            kd[:, :m].contiguous(), base)
        if not torch.equal(full[..., :m], part):
            raise AssertionError(f"ladder_sub_mul8: lanes differ between B={m} and B={B} launches")
    log(f"ladder: {n} lanes against the plain version (digit extremes, identity and torsion "
        f"A and R in lanes 0-6), ragged launches {RAGGED_LANES} equal to the B={B} launch")
    record("ladder_sub_mul8", mism, err, lambda: K.ladder_sub_mul8(a4, r4, sd, kd, base),
           lambda: C.ladder_sub_mul8_plain(sd, kd, neg_a, r_pt), 10, B,
           (8 * 88 + 2 * 256 + 264) * B + base.numel() * 4)
    del a, b, encs, y, x, t, px, pt, a4, r4, full, sd, kd

    # accum_weight: the layout of one real 10,000-signature commit, z from --seed
    t0 = time.perf_counter()
    items = generate_signed_batch(COMMIT_SIGS, seed=args.seed, msg_len=100, vote_shaped=True,
                                  device=dev)
    z16 = np.random.default_rng(args.seed).integers(0, 256, (COMMIT_SIGS, 16), dtype=np.uint8)
    prep = rlc.prepare(items, np.zeros(COMMIT_SIGS, bool), B, z16)
    s_pad = 8
    while s_pad < prep["s_rounds"]:
        s_pad *= 2
    gather_idx, gather_neg = M.expand_stream(
        *(torch.from_numpy(prep[k].astype(np.int32)).to(dev)
          for k in ("stream", "stream_neg", "counts")), s_pad)
    encs = np.zeros((2 * B, 32), np.uint8)
    for i, (pub, _, sig) in enumerate(items):
        encs[i] = np.frombuffer(sig[:32], np.uint8)  # R_i at i
        encs[B + i] = np.frombuffer(pub, np.uint8)  # A_i at B + i
    _, pts = C.decompress(torch.from_numpy(encs).to(dev))
    niels = tuple(torch.cat([c, i], dim=1).contiguous() for c, i in zip(
        C.to_niels(pts)[:3], M._identity_niels(1, dev)))
    weights = torch.from_numpy(prep["weights"].reshape(-1)).to(dev)
    neg32 = gather_neg.to(torch.int32)
    log(f"accum_weight input: one commit laid out in {time.perf_counter() - t0:.2f} s, "
        f"s_rounds {prep['s_rounds']}, S = {s_pad}, WK = {M.WK}, M = {2 * B + 1} points")
    per_lane["accum_weight"] = products_per_lane(s_pad)["accum_weight"]
    got = M.accumulate_weighted(niels, gather_idx, gather_neg, weights)
    check_loose("accum_weight", got)
    want = M.accumulate_weighted_plain(niels, gather_idx, gather_neg, weights)
    mism, err = frozen_diff(F, got, want)
    for n in RAGGED_LANES:
        part = K.accum_weight(niels, gather_idx[:, :n].contiguous(), neg32[:, :n].contiguous(),
                              weights[:n].contiguous())
        if not torch.equal(part, got[..., :n]):
            raise AssertionError(f"accum_weight: lanes differ between WK={n} and WK={M.WK} "
                                 "launches")
    log(f"accum_weight: ragged launches {RAGGED_LANES} equal to the WK={M.WK} launch")
    n_pts = niels[0].shape[1]
    record("accum_weight", mism, err, lambda: K.accum_weight(niels, gather_idx, neg32, weights),
           lambda: M.accumulate_weighted_plain(niels, gather_idx, gather_neg, weights), 20, M.WK,
           3 * 88 * n_pts + 2 * 4 * s_pad * M.WK + 4 * M.WK + 4 * 88 * M.WK)
    kern["accum_weight"].update(s_rounds=prep["s_rounds"], s_pad=s_pad)
    del want, gather_idx, gather_neg, neg32, niels, weights, pts, encs

    # the RLC tail on that commit: its weighted lanes (the accum_weight
    # output), region sums, total, and [8](msm + [c]B) by one ladder launch
    n_dec = sum(per_lane["decompress"])
    product_cycles = kern["decompress"]["device_only_ms"] * 1e-3 * sm_mhz * 1e6 / n_dec
    log(f"one field product's latency, from decompress's chain of {n_dec}: "
        f"{product_cycles:.0f} cycles at {sm_mhz:.0f} MHz")

    def floor_ms(stages: int) -> float:
        return stages * product_cycles / (sm_mhz * 1e6) * 1e3

    sums = M.region_tree_sum(got)
    check_loose("region_sum", sums)
    mism, err = frozen_diff(F, sums, M.region_tree_sum_plain(got))
    record("region_sum", mism, err, lambda: K.region_sum(got),
           lambda: M.region_tree_sum_plain(got), 200, M.N_REGIONS,
           4 * 88 * M.WK + 4 * 88 * M.N_REGIONS)
    kern["region_sum"]["latency_floor_ms"] = floor_ms(REGION_SUM_STAGES)
    msm = M.window_combine(sums)
    check_loose("window_combine", msm)
    mism, err = frozen_diff(F, msm, M.window_combine_plain(sums))
    combine_stages = 2 * (sum(M.REGION_DBL) + M.N_REGIONS)
    record("window_combine", mism, err, lambda: K.window_combine(sums),
           lambda: M.window_combine_plain(sums), 50, 1, 4 * 88 * M.N_REGIONS + 4 * 88)
    kern["window_combine"].update(latency_floor_ms=floor_ms(combine_stages),
                                  product_stages=combine_stages)
    c_dig = torch.from_numpy(prep["c_digits"]).to(dev)
    tail_args = (c_dig, torch.zeros_like(c_dig), C.identity(1, dev), C.neg(msm))
    tail = torch.stack(C.ladder_sub_mul8(*tail_args))
    mism, err = frozen_diff(F, tail, torch.stack(C.ladder_sub_mul8_plain(*tail_args)))
    if mism:
        raise AssertionError(f"ladder_sub_mul8 at B = 1: {mism} lanes disagree with the plain "
                             "version")
    if not bool(F.is_zero(tail[0])[0] & F.eq(tail[1], tail[2])[0]):
        raise AssertionError("the valid commit's [8](msm + [c]B) is not the identity")
    tail_a4 = torch.stack(tail_args[2])
    tail_r4 = torch.stack(tail_args[3])
    base = C.base_niels(dev)

    def tail_launch():
        return K.ladder_sub_mul8(tail_a4, tail_r4, c_dig, tail_args[1], base)

    tail_ms = cuda_ms(tail_launch, 50)
    tail_alone = kernel_device_ms(tail_launch, "ladder_sub_mul8", 50)
    kern["ladder_sub_mul8"]["rlc_tail_b1"] = {
        "mismatches": mism, "max_abs_err": err, "ms": tail_ms, "device_only_ms": tail_alone,
        "bound_ms": wide_muls(per_lane["ladder_sub_mul8"]) / mul_rate * 1e3,
        "bound_by": "operations", "latency_floor_ms": floor_ms(LADDER_STAGES),
        "product_stages": LADDER_STAGES}
    log(f"RLC tail on the commit: region sums and total exact; ladder at B = 1 (k = 0, A the "
        f"identity, R = -msm) exact, verdict true; {tail_ms:.4f} ms (device alone "
        f"{tail_alone:.4f} ms), latency floor {floor_ms(LADDER_STAGES):.4f} ms; window_combine "
        f"latency floor {floor_ms(combine_stages):.4f} ms ({combine_stages} stages)")
    del got, sums, msm, tail, tail_a4, tail_r4
    torch.cuda.synchronize()
    sha_phase(dev, args.seed, items, record, kern, mul_rate, int_rate, args.parent_sha)
    del items
    torch.cuda.synchronize()

    # ---- phase 4: the main path, counted, route by route
    # (a) the ladder route, pinned through the dispatch seam
    if COMMIT_SIGS < E.NATIVE_MAX:
        raise AssertionError("the phase's commits would take the native route")
    seam, delta_seam = E._rlc_beats_ladder, E._delta_beats_prehashed
    E._rlc_beats_ladder = lambda n, b, device: False
    E._delta_beats_prehashed = lambda n, b, device: False
    K.reset_launches()
    t0 = time.perf_counter()
    commits = [generate_signed_batch(COMMIT_SIGS, seed=args.seed + i, msg_len=100,
                                     vote_shaped=True, device=dev) for i in range(2)]
    gen_s = time.perf_counter() - t0
    log(f"testgen: 2 x {COMMIT_SIGS} vote-shaped signatures on the card in {gen_s:.2f} s")
    cols = [to_columns(c) for c in commits]

    def pipeline(device_sha=False):
        """16 commits submitted back to back, then one collect_pending."""
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        pend = [submit_commit(cols[i % 2], dev, device_sha) for i in range(PIPELINE_DEPTH)]
        t_sub = time.perf_counter()
        res = collect_pending(pend)
        t_end = time.perf_counter()
        if not all(ok for ok, _ in res) or not all(len(bits) == COMMIT_SIGS for _, bits in res):
            raise AssertionError("a valid 10,000-signature commit did not verify")
        return t_end - t_start, t_sub - t_start

    cold_s, _ = pipeline()
    warm_s, warm_submit_s = pipeline()
    sigs_per_s = PIPELINE_DEPTH * COMMIT_SIGS / warm_s
    log(f"ladder pipeline: {PIPELINE_DEPTH} commits x {COMMIT_SIGS} sigs, all ok; cold pubkey "
        f"cache {cold_s:.3f} s, warm {warm_s:.3f} s (submits {warm_submit_s:.3f} s) -> "
        f"{sigs_per_s:.0f} sigs/s on {card}")

    # one commit with fixed bad lanes
    items = list(commits[0])
    a_sc = [int.from_bytes(rng.bytes(32), "little") % ref.L for _ in range(4)]
    pub, msg, sig = items[0]
    items[0] = (pub, msg, bytes([sig[0] ^ 1]) + sig[1:])  # flipped signature bit
    pub, msg, sig = items[1]
    s = int.from_bytes(sig[32:], "little")
    items[1] = (pub, msg, sig[:32] + (s + ref.L).to_bytes(32, "little"))  # S >= L
    pub, msg, sig = items[2]
    items[2] = (pub[:31] + bytes([pub[31] ^ 0x80]), msg, sig)  # sign-flipped A
    for lane, shift_a in ((3, True), (4, False)):  # torsion-shifted A, then R
        msg = items[lane][1]
        pub, sig = torsion_signed(ref, a_sc[lane - 3], a_sc[lane - 1], msg, shift_a, t8)
        items[lane] = (pub, msg, sig)
    expect = [False, False, False, True, True] + [True] * (COMMIT_SIGS - 5)
    if [ref.verify(p, m, s) for p, m, s in items[:5]] != expect[:5]:
        raise AssertionError("the bad-lane construction does not give the intended verdicts")
    bad_cols = to_columns(items)
    sample = [0, 1, 2, 3, 4] + sorted(
        rng.choice(np.arange(5, COMMIT_SIGS), ORACLE_SAMPLE - 5, replace=False).tolist())
    oracle = [ref.verify(*items[i]) for i in sample]

    def check_bad_lanes(route, pending, want=expect, want_sample=oracle, what="bad-lane commit"):
        ok, bits = pending.result()
        if ok or bits != want:
            wrong = [i for i, (g, w) in enumerate(zip(bits, want)) if g != w]
            raise AssertionError(f"{route} {what}: bitmap wrong at lanes {wrong[:20]}")
        if [bits[i] for i in sample] != want_sample:
            raise AssertionError(f"{route}: bitmap disagrees with ed25519_ref.verify on the sample")
        log(f"{route} {what}: bitmap exact (lanes 0-2 rejected, torsion lanes 3-4 "
            f"accepted); {ORACLE_SAMPLE}-lane sample agrees with ed25519_ref.verify")

    check_bad_lanes("ladder", submit_commit(bad_cols, dev))

    def read_counts(route, expected):
        torch.cuda.synchronize()
        counts = dict(K.launches)
        log(f"{route} route launches: {counts}")
        for name in expected:
            if counts[name] == 0:
                raise AssertionError(f"kernel {name} was never launched on the {route} route")
        return counts

    counts = read_counts("ladder", ("fe_mul", "fe_sq", "decompress", "ladder_sub_mul8"))
    commits_verified = 2 * PIPELINE_DEPTH + 1
    log(f"  over {commits_verified} commit verifications and 2 generated commits")

    # (b) the RLC/MSM route: the same commits, pinned through the dispatch seam
    K.reset_launches()
    E._rlc_beats_ladder = lambda n, b, device: True
    try:
        rlc_cold_s, _ = pipeline()
        rlc_warm_s, rlc_warm_submit_s = pipeline()
        bad, bad_submits = submit_through_rlc(
            bad_cols, dev, lambda p: check_bad_lanes("RLC route, declined to the ladder", p))
        if bool(bad._all_ok.item()):
            raise AssertionError("bad-lane commit: the RLC all-ok scalar is not false")
        check_bad_lanes("RLC (blame rerun)", bad)
        tail_kernels = ("decompress", "accum_weight", "region_sum", "window_combine",
                        "ladder_sub_mul8")
        rlc_counts = read_counts("RLC", tail_kernels)
    finally:
        E._rlc_beats_ladder = lambda n, b, device: False
    accepted = rlc_counts["accum_weight"]  # one a commit the layout accepted
    if (rlc_counts["region_sum"] != accepted or rlc_counts["window_combine"] != accepted
            or rlc_counts["ladder_sub_mul8"] < accepted or rlc_counts["decompress"] < 2 * accepted):
        raise AssertionError(f"RLC route: a tail kernel missed a commit: {rlc_counts}")
    field_launches = rlc_counts["fe_mul"] + rlc_counts["fe_sq"]
    if field_launches > 2 * accepted:
        raise AssertionError(f"RLC route: {field_launches} fe_mul + fe_sq launches over "
                             f"{accepted} commits, more than 2 a commit")
    log(f"RLC route: {accepted} commits through the layout, {field_launches} fe_mul + fe_sq "
        f"launches ({field_launches / max(accepted, 1):.2f} a commit)")
    rlc_sigs_per_s = PIPELINE_DEPTH * COMMIT_SIGS / rlc_warm_s
    log(f"RLC pipeline: {PIPELINE_DEPTH} commits x {COMMIT_SIGS} sigs, all ok; cold "
        f"{rlc_cold_s:.3f} s, warm {rlc_warm_s:.3f} s (submits {rlc_warm_submit_s:.3f} s) -> "
        f"{rlc_sigs_per_s:.0f} sigs/s on {card}")
    rlc_commits = 2 * PIPELINE_DEPTH + bad_submits

    # (c) the device-SHA route and (d) the delta route, the RLC seam pinned
    # False: the same commits and the bad-lane commit; on the device-SHA
    # route also the bad-lane commit with two oversize lanes (5 valid, 6
    # broken: 200-byte messages), which the host verifies at result()
    seed5 = hashlib.sha256(b"oversize lane").digest()
    big = rng.bytes(200)
    over_items = list(items)
    over_items[5] = (ref.pubkey_from_seed(seed5), big, ref.sign(seed5, big))
    over_items[6] = (over_items[5][0], big[:-1] + b"!", over_items[5][2])
    over_expect = expect[:5] + [True, False] + expect[7:]
    if [ref.verify(*over_items[i]) for i in (5, 6)] != [True, False]:
        raise AssertionError("the oversize lanes do not give the intended verdicts")
    over_cols = to_columns(over_items)
    over_oracle = [over_expect[i] if i in (5, 6) else o for i, o in zip(sample, oracle)]
    sha_routes = {}
    for route in ("device_sha", "delta"):
        K.reset_launches()
        device_sha = route == "device_sha"
        E._delta_beats_prehashed = lambda n, b, device, pick=not device_sha: pick
        r_cold_s, _ = pipeline(device_sha)
        r_warm_s, r_warm_submit_s = pipeline(device_sha)
        pending = submit_commit(bad_cols, dev, device_sha)
        if pending._path != route:
            raise AssertionError(f"the bad-lane commit took {pending._path}, not {route}")
        check_bad_lanes(route, pending)
        submits = 2 * PIPELINE_DEPTH + 1
        if device_sha:
            pending = submit_commit(over_cols, dev, True)
            if pending._oversize_idx != [5, 6]:
                raise AssertionError(f"oversize lanes {pending._oversize_idx}, not [5, 6]")
            check_bad_lanes(route, pending, over_expect, over_oracle,
                            "commit with oversize lanes 5-6 (5 accepted, 6 rejected on the host)")
            submits += 1
        r_counts = read_counts(route, SHA_KERNELS)
        check_challenge_launches(route, r_counts, submits)
        r_sigs = PIPELINE_DEPTH * COMMIT_SIGS / r_warm_s
        log(f"{route} pipeline: {PIPELINE_DEPTH} commits x {COMMIT_SIGS} sigs, all ok; cold "
            f"{r_cold_s:.3f} s, warm {r_warm_s:.3f} s (submits {r_warm_submit_s:.3f} s) -> "
            f"{r_sigs:.0f} sigs/s on {card}")
        sha_routes[route] = {"sigs_per_s": r_sigs, "pipeline_warm_s": r_warm_s,
                             "pipeline_cold_s": r_cold_s, "counts": r_counts, "commits": submits}
    # (e) the standalone challenge kernels through their ops-level entry points
    ops_counts = ops_challenge_leg(dev, cols[0])
    E._rlc_beats_ladder, E._delta_beats_prehashed = seam, delta_seam
    route_sigs = {"ladder": sigs_per_s, "rlc": rlc_sigs_per_s,
                  **{r: v["sigs_per_s"] for r, v in sha_routes.items()}}
    log("sigs/s, warm, same call: " + ", ".join(f"{r} {v:.0f}" for r, v in route_sigs.items())
        + f" [{card}]")
    by_route = {"ladder": counts, "rlc": rlc_counts,
                **{r: v["counts"] for r, v in sha_routes.items()}, "ops": ops_counts}
    for name in SOURCES:
        kern[name]["launches"] = sum(c[name] for c in by_route.values())
        kern[name]["launches_by_route"] = {r: c[name] for r, c in by_route.items()}
    for name in ("sha512_reduce", *SHA_STANDALONE):
        kern[name]["launches_per_commit"] = {r: sha_routes[r]["counts"][name]
                                             / sha_routes[r]["commits"] for r in sha_routes}
    # the ladder and delta routes decompress A once per set
    kern["decompress"]["launches_per_commit"] = {"ladder": 1, "rlc": 2, "device_sha": 2, "delta": 1}
    kern["ladder_sub_mul8"]["launches_per_commit"] = counts["ladder_sub_mul8"] / commits_verified
    for name in ("accum_weight", "region_sum", "window_combine"):
        kern[name]["launches_per_commit"] = rlc_counts[name] / rlc_commits
    for name in ("fe_mul", "fe_sq"):
        kern[name]["rlc_launches_per_accepted_commit"] = rlc_counts[name] / max(accepted, 1)

    # stage split of one warm commit (not counted: the counts were read above)
    from cometbft_tpu_torch.crypto.batch import create_batch_verifier
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PubKey, _bucket

    pubs, sigs, blob, lens = cols[0]
    bv = create_batch_verifier(Ed25519PubKey(pubs[0].tobytes()), device=dev)
    bv.add_batch(pubs, sigs, blob, lens)
    n_lanes, bucket = bv.count(), _bucket(bv.count())
    stage = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rsk_host = bv._pack_rsk(n_lanes, bucket)
    stage["host_pack_hash_ms"] = (time.perf_counter() - t0) * 1e3
    ok_a, neg_a_cached = bv._pubkeys_on_device(n_lanes, bucket)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    rsk = rsk_host.to(dev, non_blocking=True)
    ev[1].record()
    live = torch.arange(bucket, device=dev) < n_lanes
    bits_dev, all_ok = V.verify_batch_cached_a(ok_a, neg_a_cached, rsk, live)
    ev[2].record()
    torch.cuda.synchronize()
    stage["h2d_ms"] = ev[0].elapsed_time(ev[1])
    stage["device_ms"] = ev[1].elapsed_time(ev[2])
    t0 = time.perf_counter()
    if not bool(all_ok.item()):
        raise AssertionError("stage-split commit did not verify")
    stage["d2h_ms"] = (time.perf_counter() - t0) * 1e3
    stage["kernels_ms"] = kern["decompress"]["ms"] + kern["ladder_sub_mul8"]["ms"]
    stage["torch_glue_ms"] = stage["device_ms"] - stage["kernels_ms"]
    stage["h2d_bytes_per_lane"] = rsk_host.numel() / n_lanes
    stage["h2d_bytes_per_lane_pubkeys_once_per_set"] = 32 * bucket / n_lanes
    log("stage split, one warm 10,000-signature commit: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage.items()) + f" [{card}]")

    # where the device time of that commit goes, by kernel name
    n_kernels, busy_ms, by_kernel, table = profile_commit(
        lambda: V.verify_batch_cached_a(ok_a, neg_a_cached, rsk, live)[1].item(),
        "profile_commit.txt")
    log(f"profile, one warm commit: {n_kernels} device kernels ({by_kernel}), "
        f"{busy_ms:.3f} ms busy")
    for ln in table.splitlines()[:16]:
        log("profile:", ln)
    stage["profiled_device_kernels"] = n_kernels
    stage["profiled_kernels_by_name"] = by_kernel
    stage["profiled_device_busy_ms"] = busy_ms

    # the RLC route's stage split, the same warm commit
    rlc_stage = {}
    # the layout draws z afresh each time and declines about one commit in
    # sixteen (PERF.md, section 6); a declined one is packed again
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        packed = bv._pack_rlc()
        rlc_stage["host_prepare_ms"] = (time.perf_counter() - t0) * 1e3
        if packed is not None:
            break
    else:
        raise AssertionError("the RLC layout declined the stage-split commit 5 times")
    buf_host, fields, s_commit = packed
    torch.cuda.synchronize()
    ev[0].record()
    buf = buf_host.to(dev, non_blocking=True)
    ev[1].record()
    ok_dev = E.verify_rlc_packed(buf, fields, s_commit)
    ev[2].record()
    torch.cuda.synchronize()
    rlc_stage["h2d_ms"] = ev[0].elapsed_time(ev[1])
    rlc_stage["device_ms"] = ev[1].elapsed_time(ev[2])
    t0 = time.perf_counter()
    if not bool(ok_dev.item()):
        raise AssertionError("RLC stage-split commit did not verify")
    rlc_stage["d2h_ms"] = (time.perf_counter() - t0) * 1e3
    rlc_stage["s_pad"] = s_commit
    rlc_stage["kernels_ms"] = (2 * kern["decompress"]["ms"] + kern["accum_weight"]["ms"]
                               + kern["region_sum"]["ms"] + kern["window_combine"]["ms"]
                               + kern["ladder_sub_mul8"]["rlc_tail_b1"]["ms"])
    rlc_stage["torch_glue_and_tail_ms"] = rlc_stage["device_ms"] - rlc_stage["kernels_ms"]
    rlc_stage["h2d_bytes_per_lane"] = buf_host.numel() / n_lanes
    log("RLC stage split, one warm 10,000-signature commit: " + ", ".join(
        f"{k} {v:.3f}" for k, v in rlc_stage.items()) + f" [{card}]")
    n_kernels, busy_ms, by_kernel, table = profile_commit(
        lambda: E.verify_rlc_packed(buf, fields, s_commit).item(), "profile_rlc_commit.txt")
    log(f"profile, one warm RLC commit: {n_kernels} device kernels ({by_kernel}), "
        f"{busy_ms:.3f} ms busy")
    for ln in table.splitlines()[:16]:
        log("profile:", ln)
    rlc_stage["profiled_device_kernels"] = n_kernels
    rlc_stage["profiled_kernels_by_name"] = by_kernel
    rlc_stage["profiled_device_busy_ms"] = busy_ms
    if n_kernels >= RLC_MAX_DEVICE_KERNELS:
        raise AssertionError(f"one RLC commit ran {n_kernels} device kernels, "
                             f"not under {RLC_MAX_DEVICE_KERNELS}")

    # the device-SHA and delta routes' stage splits, the same warm commit
    for route, r in sha_routes.items():
        bv = E.Ed25519BatchVerifier(dev, device_sha=route == "device_sha")
        bv.add_batch(pubs, sigs, blob, lens)
        st = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if route == "device_sha":
            buf_host, fields, _ = bv._pack_device_sha(n_lanes, bucket)
        else:
            buf_host, fields = bv._pack_delta(E._detect_delta(bv._msg_buf, bv._msg_lens))
        st["host_pack_ms"] = (time.perf_counter() - t0) * 1e3
        if route == "delta":
            ok_a, neg_a_cached, a_enc = bv._pubkeys_on_device(n_lanes, bucket, with_encodings=True)
        torch.cuda.synchronize()
        ev[0].record()
        buf = buf_host.to(dev, non_blocking=True)
        ev[1].record()
        t = E.unpack_fields(buf, fields)
        if route == "device_sha":
            def run():
                return V.verify_batch(t["a"], t["r"], t["s"], t["words"], t["two"], t["live"])
        else:
            def run():
                return V.verify_batch_delta(ok_a, neg_a_cached, a_enc, t["packed"], t["meta"])
        all_ok = run()[1]
        ev[2].record()
        torch.cuda.synchronize()
        st["h2d_ms"] = ev[0].elapsed_time(ev[1])
        st["device_ms"] = ev[1].elapsed_time(ev[2])
        t0 = time.perf_counter()
        if not bool(all_ok.item()):
            raise AssertionError(f"{route} stage-split commit did not verify")
        st["d2h_ms"] = (time.perf_counter() - t0) * 1e3
        st["kernels_ms"] = (kern["sha512_reduce"]["ms"]
                            + kern["decompress"]["ms"] * (2 if route == "device_sha" else 1)
                            + kern["ladder_sub_mul8"]["ms"])
        st["torch_glue_ms"] = st["device_ms"] - st["kernels_ms"]
        st["h2d_bytes_per_lane"] = buf_host.numel() / n_lanes
        log(f"{route} stage split, one warm 10,000-signature commit: " + ", ".join(
            f"{k} {v:.3f}" for k, v in st.items()) + f" [{card}]")
        n_kernels, busy_ms, by_kernel, _ = profile_commit(
            lambda: run()[1].item(), f"profile_{route}_commit.txt", SHA_KERNELS)
        st.update(profiled_device_kernels=n_kernels, profiled_kernels_by_name=by_kernel,
                  profiled_device_busy_ms=busy_ms)
        log(f"profile, one warm {route} commit: {n_kernels} device kernels ({by_kernel}), "
            f"{busy_ms:.3f} ms busy")
        launched = {**dict.fromkeys(SHA_KERNELS, 1),
                    "decompress": 2 if route == "device_sha" else 1}
        if by_kernel != launched:
            log(f"profile of the {route} commit: kernels {by_kernel}, launched {launched}")
        r["stage"] = st

    # ---- phase 5: the native host engine
    host = host_engine_phase(dev, card, args.seed, commits[0], items, expect, route_sigs)

    # ---- phase 6: the commit-verify consumers
    consumers = consumers_phase(dev, card, args.seed, kern)

    # ---- phase 7: block-sync replay
    replay = replay_phase(dev, card, args.seed, kern, mul_rate)
    chain = replay.pop("chain")

    # ---- phase 8: ingest, blocks with the mempool and evidence, the light client
    ingest = ingest_phase(dev, card, args.seed, kern, chain, mul_rate)
    stream = ingest.pop("stream")

    # ---- phase 9: in-process consensus
    consensus = consensus_phase(dev, card, args.seed, kern, mul_rate)

    # ---- phase 10: the verify mesh and block sync over p2p
    t0 = time.perf_counter()
    mesh = mesh_phase(dev, card, kern, commits, chain)
    blocksync = blocksync_phase(dev, card, args.seed, kern, chain)
    blocksync["phase_s"] = time.perf_counter() - t0
    log(f"phase 10 took {blocksync['phase_s']:.1f} s (the mesh {mesh['seconds']:.1f} s) [{card}]")

    # ---- phase 11: the network reactors and state sync
    sync_chain = blocksync.pop("chain")
    network = network_phase(dev, card, args.seed, kern, ((chain[0], chain[2]), sync_chain),
                            stream, mul_rate)

    # ---- phase 12: the node
    node = node_phase(dev, card, kern, sync_chain)

    results.update(kernels=kern, stage=stage, sigs_per_s=sigs_per_s, pipeline_warm_s=warm_s,
                   pipeline_cold_s=cold_s, testgen_s=gen_s, counts=counts,
                   rlc_stage=rlc_stage, rlc_sigs_per_s=rlc_sigs_per_s,
                   rlc_pipeline_warm_s=rlc_warm_s, rlc_pipeline_cold_s=rlc_cold_s,
                   rlc_counts=rlc_counts, sha_routes=sha_routes, host_engine=host,
                   consumers=consumers, replay=replay, ingest=ingest, consensus=consensus,
                   mesh=mesh, blocksync=blocksync, network=network, node=node)
    (OUT_DIR / "results.json").write_text(json.dumps(results, indent=1, default=str))

    # ---- phases 13 and 14: the kernel line, the card, the contract line
    keys = ("name", "route", "source", "replaces", "launches", "mismatches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: kern[n][k] for k in keys} for n in SOURCES]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
