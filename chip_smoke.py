#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``p2pnetwork_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py     # needs one CUDA card

Phases, in order; any failure exits non-zero before the result line:

1. Device: the card's name and power limit, as ``nvidia-smi`` reports them.
2. Build: the CUDA kernels from ``p2pnetwork_tpu_torch/csrc`` (nvcc, sm_90a).
3. Kernel vs plain version, on seeded random inputs at the 1M-node
   shapes, L2 flushed before each timed launch (CUDA events). Each row
   times the kernel, its plain version and one PyTorch call:
   - B1, the segment sum, at the single-device path's two layouts — the
     hybrid remainder ``[1954, 640]`` with ``block=512`` and the blocked
     layout ``[7813, 1408]`` with ``block=128`` — and its stacked-shard
     entry on the ring's hybrid buckets ``[8, 245, 128]`` (a strided step
     slice). OR bit-equal, f32 sum within ``rtol = atol = 1e-5``, exact on
     integer values. Library call: ``scatter_add_`` on pre-gathered terms.
     Beside the two single-device layouts, ``local_src_ms``: the same rows
     with sources drawn from ``LOCAL_SOURCES`` nodes, whose gathers stay
     in L1/L2 (the gap to ``ms`` is the cost of gathers spread over the
     whole signal).
   - B2, the ring hop, on bool and f32 ``[8, 125008]``, both directions:
     bit-equal. Library call: ``torch.roll``.
   - B3, the fused ring step, on ``rot [8, 125008]`` with the ``mxu``
     layout's buckets ``[8, 245, 4864]``, block 512: OR and ``rot_next``
     bit-equal, sum within tolerance, integer sum exact. Library call:
     ``scatter_add_`` on pre-gathered terms. ``extent_w_ms``: the same
     rows given extents all W (the extent path reading every slot).
   Then the row engine's edge geometries, each against its plain version
   (OR bit-equal, integer sums exact, f32 sums within tolerance): B1 at
   an odd width (1407), rows not 16-byte aligned, narrow rows (W = 128,
   32), ``block`` 1 and ``MAX_BLOCK``, row counts that leave the
   persistent grid's last block one row, and a strided, unaligned stacked
   slice (with B3); B2 at per-shard sizes that are not multiples of 16
   bytes, both directions. C1 (run last, after every timed row): B1's
   sum on both layouts with NaN, +inf and -inf at live slots and +inf at
   ``signal[0]``, read by padding slots: the kernel's NaN set must equal
   its plain version's (the reference's one-hot spread of a non-finite
   term over its row), every other output within tolerance (``c1``
   line).
3b. B3 on the real buckets: after phase 4b has sharded phase 4's graph
   with ``mxu=True``, B3 (OR and sum) on ring steps 0 (95.7% live) and 1
   (1.3% live), sliced ``[:, t]`` as the ring pass slices them, with the
   rows' extents (``ms``, bound over the slots up to each extent) and at
   full width (``full_width_ms``, bound over every slot): OR and
   ``rot_next`` bit-equal to the plain version, sum within tolerance,
   integer sum exact; timed as in phase 3 (``kernel-real-step`` lines).
   After the timed rows, C1 as in phase 3: the sum with NaN and +-inf at
   live slots, then at ``rot[d, 0]`` (``c1`` line).
4. Main path: the 1M-node Watts–Strogatz graph flooded from node 0 to 99%
   coverage by ``run_until_coverage`` with ``Flood(pallas)``,
   ``Flood(hybrid)``, ``AdaptiveFlood(hybrid, k=1024)``, ``k=2048`` and
   ``Flood(frontier, bitset=True)``. Each must return the JAX reference's
   numbers exactly and the same final ``seen``; each but ``frontier``
   (whose dense fallback is ``auto`` -> ``gather``) must launch the
   kernel, and ``frontier`` must take 9 sparse and 2 dense rounds. Then
   each method's steady-state wall time (median of 5) and one run under
   ``torch.profiler``: device kernel time, launches and idle share.
4b. Ring: phase 4's graph sharded 8 ways on the card
   (``parallel.sharded.shard_graph``) in the ``segment``, ``mxu`` and
   ``hybrid`` layouts, each flooded to 99% by ``flood_until_coverage``
   with the default comm (the CUDA ring kernels). Each must return the
   same numbers and the same final ``seen`` as phase 4, and launch the
   layout's kernels: B2 (segment), B3 and B1 (mxu), B2 and B1 (hybrid).
   On ``mxu`` one integer-valued ``propagate(op="sum")`` must equal the
   ``comm="ppermute"`` result exactly. Then wall, syncs and a profile per
   layout, as in phase 4; on ``mxu`` the profile splits B3's device time
   by ring step, and a second one profiles the same flood with its rows
   at full width (``profile_full_width``: B3 without extents).
4c. Churn: phase 4's graph with 256 slots of dynamic edge region, the
   64-link connect batch of ``benchmarks/ladder.py`` (undirected) and
   nodes 5,000 to 14,999 failed (every layout re-masked), flooded by
   ``pallas``, ``hybrid``, ``AdaptiveFlood(hybrid, k=1024)``,
   ``frontier`` + bitset and ``segment``; each must return the JAX
   reference's churn dict (``EXPECTED_CHURN``) and the same ``seen``, and
   the first three launch B1 on the re-masked layouts. Then ``hybrid``
   resumed: ``run_from`` 3 rounds and ``run_until_coverage_from``, its
   stacked stats and resumed dict equal to the reference's, ending on the
   same ``seen``. Wall, syncs, launches and a profile per method.
4d. Skew: the ladder's 1M Barabási–Albert rung (``m = 5``, skew table, no
   neighbor table), flooded by ``skew``, ``auto`` (which must route to
   ``skew``), ``segment`` and ``AdaptiveFlood(segment, k=2048)``, then
   with a seeded 1% of its edges cut by ``skew`` and ``segment``: each
   must return the JAX reference's dict; wall and a profile per method.
3c. Threefry (``ops/threefry.py``, ``csrc/threefry.cu``; port-only, the
   counter-based draws of ``prng.py``): bits and the f32 uniform
   epilogue against the plain version, bit for bit, at odd sizes, a 2-D
   shape, ``N_PAD`` and draws from counter offsets across 2**32, for
   three keys; timed at ``N_PAD``, 100,096 and 4,096 as phase 3 times
   kernels, beside the launch floor (an empty kernel timed the same way:
   ``launch_floor_ms``) and the time back to back (``back_to_back_ms``:
   launches with no flush between them), in ``kernel-threefry`` lines. Bound by the ALU
   pipe: the loop's instructions are read from the built kernel's SASS
   (``cuobjdump -sass``) and printed beside it, by pipe and per counter
   (``sass.per_counter``: ``alu_only``, ``alu_pipe``, ``fma_pipe``).
4e. SIR: the ladder's rung (``beta=0.3, gamma=0.05``, ``key(0)``, 30
   rounds of ``engine.run``) on phase 4's graph under ``hybrid`` and
   ``pallas``: the stacked stats and a sha256 of the final ``status``
   must equal ``EXPECTED_SIR`` exactly; B1's sum entry 30 launches and
   threefry 60 in each run (``sir-path`` lines: wall, busy, idle share,
   launches, syncs).
4f. Push-sum (30 rounds) and PageRank (``run_until_converged`` on the
   residual) on phase 4's graph under ``hybrid``: ``messages`` and
   ``rounds`` exact, the f32 sums within ``PUSHSUM_TOL`` /
   ``PAGERANK_TOL`` of the reference; B1's sum two launches a round and
   one (``consensus-path`` lines).
4g. Gossip: the ladder's 100K BA rung, 30 rounds: the first round's
   partners (sha256) and every round's ``messages`` exact, ``variance``
   and ``mean`` within ``GOSSIP_TOL`` (``gossip-path`` line).
4h. Routing: the ladder's weighted rung (``bench_routing``): the 1M WS
   graph without a neighbor table, ``with_weights`` of its id-hash
   latency, ``DistanceVector(source=0, method="segment")`` by
   ``run_until_converged(stat="changed")``; then the same weights on
   phase 4's graph under ``gather`` and ``frontier``, and on phase 4d's
   1M BA rung under ``skew``. ``rounds``, ``messages``, ``value`` and the
   sha256s of ``dist``'s bits, ``parent`` and ``next_hops`` equal the
   JAX reference's (``EXPECTED_ROUTE``), so every method gives the same
   bits (``routing-path`` lines). No kernel runs: min-plus is scatters.
4i. Graph analytics on phase 4's graph: ``HopDistance(hybrid)`` and
   ``AdaptiveHopDistance(hybrid, k=1024)`` to an empty frontier (B1's
   OR), ``diameter_bounds(samples=16, hybrid)`` (B1's OR, threefry's
   bits for the picks), ``LeaderElection``, ``ConnectedComponents`` and
   ``SpanningTree`` under ``gather``, ``LeaderElection(skew)`` on the BA
   rung, ``KCore(k=10)`` under ``hybrid`` and ``pallas`` (B1's sum entry
   on the remainder and the blocked layout), ``LubyMIS(gather, hybrid)``
   (threefry's bits and B1's OR) and ``color_via_mis``: rounds, messages
   and the final states' sha256s equal ``EXPECTED_ANALYTICS``
   (``analytics-path`` lines: wall, busy, idle share, launches, syncs).
   Phases 3c and 4e-4i run after 4d, and phase 3's C1 check after them.
4j. Batched floods: ``bench.py``'s batched column at its width — B = 1,024
   floods to 0.99 on ``watts_strogatz(100_000, 10, 0.1, seed=0,
   source_csr=True)`` by ``BatchFlood`` through
   ``run_batch_until_coverage``, by ``auto``, ``gather``, ``segment`` and
   ``frontier``: rounds, completions, messages, the occupancy's f32 bits,
   p50/p99 and the sha256s of ``lane_done``, ``lane_rounds``,
   ``lane_messages`` and the ``seen`` words equal ``EXPECTED_BATCH``; no
   kernel launches. Four lanes equal single ``Flood`` runs of the port,
   timed as ``time_batch_flood`` times them (``batch-vs-sequential``
   line); then every lane retired and the next 1,024 sources admitted
   into the same batch, held to the reference's second wave
   (``batch-path`` lines: wall, busy, idle share, launches, syncs).
4k. Query lanes: ``bench.py``'s query column — ``MinPlusQueries`` (K = 64,
   ``auto`` and ``segment``) and ``PushSumQueries`` (K = 32) on 4j's
   graph, ``DhtLookups`` (K = 2,048) on ``chord(100_000)`` (``ring``) and
   ``kademlia(100_000)`` (``xor``) through ``run_queries_until_done``:
   equal to ``EXPECTED_QUERIES`` (min-plus answers by bits, DHT cursors,
   push-sum's rounds, lane rounds and messages exactly, its answers within
   ``PUSHSUM_QUERY_TOL``; ``query-path`` lines). 4j and 4k run after
   the C1 check.
4l. Discovery: the ladder's rung (``RandomWalks(n_walkers=4096)`` to 0.99
   of phase 4's graph, ``max_rounds=8192``) at 1 and 32 steps per
   super-step, then with ``restart_p=0.02``: rounds, messages, the
   coverage's f32 bits and the sha256s of ``visited`` and ``pos`` equal
   ``EXPECTED_WALK``; only the restart launches threefry
   (``discovery-path`` lines).
4m. Plumtree: the ladder's rung on phase 4h's weighted WS rung — the
   first broadcast (every stat and the eager set's sha256 exact),
   ``tree_graph(source_csr=True)`` (host seconds printed) and a flood over
   it to coverage 1.0, then a second broadcast over the tree, each equal
   to ``EXPECTED_PLUMTREE``; no kernel (``plumtree-path`` lines).
4n. The protocol library on phase 4's graph: ``Bracha(f=1, byzantine=(1,
   2))`` under ``hybrid`` and ``pallas`` (B1's sum, 2 + 4 a round), HITS
   (``hybrid``, to ``HITS_THRESHOLD``), closeness (B1's OR) and
   betweenness (B1's sum) over 8 sources, ``LabelPropagation`` and
   ``BipartiteCheck`` (``gather``), ``count_triangles`` and
   ``transitivity_sample(65536)`` (threefry), Borůvka and ``Vivaldi(dim=2)``
   (30 rounds, threefry) on the symmetric latency, ``FailureDetector`` and
   ``AntiEntropy(n_items=64)`` (threefry) on phase 4c's failed nodes:
   counts and sha256s equal ``EXPECTED_LIBRARY``, floats within
   ``EXPECTED_LIBRARY_FLOATS``' tolerances (``library-path`` lines).
   4l-4n run after 4i, on the same graph.
4o. Reordered builds: ``reorder="rcm"`` and ``"degree"`` on 4j's 100K WS
   class: every field's sha256 equals the reference's
   (``EXPECTED_REORDER``), and ``Flood(hybrid)`` over each, mapped back by
   ``to_original_order``, equals the plain build's run (B1's OR;
   ``reorder-path`` lines). 4o runs last.
   The phases of slice 7 time 3 repeats, not 5.
4p. State I/O on phase 4's graph (after 4n; ``state-io`` lines, 3
   repeats): a churn epoch (``DELTA_PAIRS`` live undirected pairs removed,
   as many random pairs added) by ``apply_delta``, then again with
   ``donate=True`` on a copy, each byte-equal (``graph_digest``) to the
   reference and to the port's ``from_edges`` of the merged list, with
   the host seconds of each; ``Flood`` ``hybrid`` and ``pallas`` to 0.99
   on the rebuilt layouts (B1's OR), dict and ``seen`` equal to the
   reference's; ``grow`` by 64 twice (the second doubles the capacity to
   2,000,128), the new nodes wired to 2 peers each by a delta, flooded by
   ``hybrid`` (B1 at the new shapes); phase 4's ``hybrid`` flood with an
   8-row ``FlightRecorder`` at 1 and 4 steps per super-step (rows equal,
   3 dropped, dict ``EXPECTED_1M``) and the recorder's cost in wall; the
   flood stopped at 5 rounds, saved, loaded into a fresh ``init`` and
   resumed to phase 4's ``seen`` (the file's digest the reference's); SIR
   ``hybrid`` by ``run_from`` 15 rounds, saved with the chain's key,
   resumed 15 more (B1's sum, threefry); ``save_graph``/``load_graph``
   and ``cached_graph``'s miss then hit, in a temporary directory; then
   the row-sum kernel (``csrc/rowsum.cu``, port-only: the f32 sums in
   XLA's order of adds) against its plain version, bit for bit, at phase
   4's neighbor table, 4g's BA table shape and the batch recorder's lane
   sums (``kernel`` lines, ``"kernel": "rowsum"``, with the launch floor
   and the time back to back), and PageRank by
   ``gather`` on phase 4's graph (the kernel once a round; within
   ``PAGERANK_TOL`` of ``EXPECTED_PAGERANK``, its wall beside the plain
   column loop's). After 4k, 4j's ``auto`` batch call with a 16-row
   recorder: rows equal, the result ``EXPECTED_BATCH``'s, the row-sum
   kernel twice a round. All against ``EXPECTED_4P``.
4q. The serving plane (slice 9). On phase 4's graph after 4p: the
   ``hybrid`` flood under ``SupervisedRun`` in 4-round chunks, preempted
   at round 8 and resumed from its store (rounds, coverage, messages
   ``EXPECTED_1M``'s, ``seen`` phase 4's, B1 launched), then its wall
   against the unsupervised flood's, 9 pairs in turns, with the host
   seconds of the engine's telemetry, the store's saves and the garbage
   collector per run, and a profile of the unsupervised flood after a
   supervised one (``supervise-path`` line). On phase 4j's graph after
   4k: bench.py's serving column (a warm service, then ``drive`` of
   ``SERVE_PATTERN`` through ``SimService`` at 1,024 lanes),
   ``EXPECTED_SERVE`` exactly, no kernel launched; one tick under the
   profiler; the same drive with a store, the journal and the seen
   hashes, preempted at tick 8 and
   finished by a service resumed from the store, its tickets equal to
   the uninterrupted drive's and the reference's (``serve-path`` lines:
   wall, lanes/s, tick phases, syncs and launches a tick, checkpoint and
   journal seconds); then the background driver (``start``, ``wait``,
   ``close``) on 100 tickets, each equal to a ticked service's, all done
   in a service resumed from its store.
4r. The self-healing and chaos plane (slice 10; ``chaos-path`` lines with
   each sub-phase's wall). (d) After 4q on phase 4's graph: 4q's
   supervised ``hybrid`` flood with ``heal=RetryPolicy(**HEAL_POLICY)``
   and a chip preemption injected at its second chunk: ``EXPECTED_1M``,
   phase 4's ``seen``, one chunk healed, B1 launched. (e) Phase 4's graph
   sharded 8 ways (``mxu``) and flooded with ``comm=FaultSpec(
   FaultSchedule(**RING_FAULTS), "pallas")``: the reference's dict, seen
   digest and fault counts (``EXPECTED_RING_FAULTED``), the counter equal
   to the schedule's replay, B2, B1 (stacked) and threefry launched and B3
   not; an empty schedule equal to the bare B3 flood bit for bit; walls
   of the faulted and bare floods in turns and a profile. (a) After 4q's
   drives on 4j's graph: 4q's drive with ``heal=`` under a preempt and a
   wedge (``SERVE_FAULTS``): ``EXPECTED_SERVE``, the tickets of an
   unfaulted drive, two chunks healed; then unhealed and healed drives
   in turns (the healing's cost). (b) The healed, faulted drive with
   ``slo=SLOEngine(serve_objectives(slo_rounds=SLO_ROUNDS))``:
   ``EXPECTED_SERVE_SLO``. (g) ``MetricsServer`` on ``127.0.0.1:0`` over
   (b)'s registry and service: ``/metrics`` parses with the ``serve_``,
   ``heal_`` and ``chaos_`` families, ``/dashboard.json`` is JSON, a
   ``POST /submit`` through ``handle_http`` ends done. (c) Last but one:
   the reference's 100k churn soak (``SOAK_STORM``, ``SOAK_TRAFFIC``)
   unfaulted, then healed through ``SERVE_FAULTS``: both
   ``EXPECTED_SOAK``, their tickets equal. (f) Last: the reference's
   crash-storm campaign (``CAMPAIGN_KILLS``, ``CAMPAIGN_CONFIG``), its
   seven children on the card: no acknowledged ticket lost, at least 3
   kills landed, then a ``Standby`` promotes over the trail and fences the
   zombie primary (``FencedEpoch``).
4s. The user bridge (slice 11; ``simnode-path`` lines), after 4r on phase
   4's graph: ``TorchSimNode`` started on a real socket, a plain port
   ``Node`` connected to it and ``SIMNODE_PINGS`` dicts each way, then
   ``run_rounds``, ``fail_sim_nodes`` (nodes 5,000-14,999),
   ``inject_sim_churn(0.01)``, ``connect_sim_nodes`` (32 pairs),
   ``save_checkpoint`` and ``run_until_coverage(0.99)``, each timed; a
   fresh node loads the file and runs to 0.99. (a) One device, Flood
   ``hybrid``, 64 runtime-link slots on the graph; (c) on its two socket
   nodes a ``ChaosPlane`` partitions and heals, its counters read back and
   the message after the heal delivered. (b) The 8-shard ring, ``mxu``,
   ``hybrid`` then ``segment``, ``dynamic_edges=64``: the re-mask
   collects liveness by B2 forward and folds the out-degrees back by B2
   reversed (each ring node profiles one more re-mask). Every node's
   event-list digest, summary, ``seen`` digest, live count and checkpoint
   payload digest equal the reference's (``EXPECTED_SIMNODE*``), each
   resumed node equals its uninterrupted twin, each ring node the
   single-device node (topology events, ``seen``, messages, rounds and
   coverage); B1, B3, B2 both ways and threefry must launch where the
   node's layout runs them. Then B2 reversed on the Horner payload, i32
   ``[8, 125008]``, against its plain version and timed (``kernel`` line).
4t. The ring's other protocols (slice 12; ``ring-protocol-path`` lines),
   after 4s on phase 4's graph, 8 shards on the card in each of
   ``RING_LAYOUTS``: SIR (4e's rung, 30 rounds) with ``exact_rng=True``
   (equal to ``EXPECTED_SIR``), with the default ``"fold"`` draws and to
   ``RING_SIR_TARGET``; PageRank and push-sum, fixed rounds and to a
   threshold, under ``hybrid`` and ``mxu``; hop distance to the end and
   leader election to quiescence under ``segment`` (``EXPECTED_ANALYTICS``'s
   digests); the ladder's sharded gossip rung; ``TorchSimNode`` on the
   ``mxu`` ring through ``examples/mesh_simnode_demo.py``'s story (a
   checkpoint and a resumed node) and a PageRank node; 4l's cohort walking
   64 rounds on a ``source_csr=True`` ring. Each run against the JAX
   ring's records (``EXPECTED_RING*``, ``EXPECTED_MESH_*``; integers,
   bools and digests exactly, f32 within ``RING_TOL``) and its launches by
   kernel (B3's sum form, B1's stacked sum, B2 on f32 and i32, threefry,
   the row sums at ``[8, 125008]``, gossip's at ``[8, 12512]``), then once
   under the profiler (wall, busy, idle share). After 4k: 4j's B = 1,024
   batch on the 100K class's ``segment`` ring, the lane words
   ``[8, 32, 12512]`` B2's payload, equal to ``EXPECTED_BATCH``. Rows: the
   row sum at the shards' shapes (1M and 100K), B2 on i32 and on the word
   stack, each against its plain version.
4v. The ring across processes (slice 14; ``rank-ring-path`` lines),
   after 4u: in this process the dense 1M floods' walls and syncs at
   world 1 and the reference worker's churn step (nodes 3 and 500,000
   failed, 8 dynamic slots, the link 1 - 999,998, flooded to 0.9); then
   ``multihost.launch`` of 2 and 8 rank processes on the one card (4 and
   1 shards a rank; the kernels built here first), each building phase
   4's graph and its own shards: the dense flood to 0.99 on each layout
   (``EXPECTED_1M``, the gathered ``seen`` against
   ``EXPECTED_RING_SEEN``, launches per rank ``RANK_LAUNCHES``, walls of
   3, syncs), the churn step against world 1's, B2 and B3 across ranks
   against their plain versions (``kernel`` lines): a pass's one exchange
   (``ring_gather``: bool ``[n_local, 125008]`` at both worlds, f32 and
   i32 at world 2, against the ring's stack; ``library_ms`` NCCL's
   ``all_gather_into_tensor`` where NCCL takes the ranks, else its error
   in ``library_error``), the pass kernel (``ring_pass_segsum_*`` on the
   real ``mxu`` buckets of every step, ``library_ms`` one ``scatter_add_``
   of every step's terms), the hop (``ring_put``, bool, against the
   global roll; ``library_ms`` the same bytes copied into the peer slot
   by ``copy_``), a pass's movement both ways (``move``: 7 hops against
   one gather, each with 16-byte shards too, in turns),
   ``ORDERING_STEPS`` hops and ``GATHER_ORDERING_STEPS`` gathers with the
   last rank held back, every block checked, and 4t's gossip rung
   (``EXPECTED_RING_GOSSIP``). A rank that
   raises must fail its launch. Slice 15 (worlds 8 then 2): 4t's
   protocol runs on the ring split over ranks (``RANK_PROTOCOLS``: at
   world 2 SIR ``exact``, PageRank and push-sum with their run-to-*
   loops on ``mxu`` and ``hybrid``, hop distance and election on
   ``segment``; at world 8 SIR and PageRank on ``mxu`` and election),
   4t's walk at both, and at world 2 4t's batched call (the lane words
   ``[4, 32, 12512]`` B2's payload across ranks) and the mesh PageRank
   node; each held to 4t's records (``EXPECTED_SIR``, ``EXPECTED_RING``
   within ``RING_TOL``, ``EXPECTED_ANALYTICS``, ``EXPECTED_RING_WALK``,
   ``EXPECTED_BATCH``, ``EXPECTED_MESH_PAGERANK``) and to 4t's world-1
   runs, every rank's launches to ``RANK_PROTOCOL_LAUNCHES``; SIR's
   status saved at world 8 (``save_orbax``) and restored at world 2,
   equal to the uninterrupted run's; the gather on the lane words, the
   pass kernel's sum form (``kernel`` lines). Phase 4w (slice 16), in
   the same rank processes after each layout's 4v runs
   (``ADAPTIVE_RANK_RUNS``): at world 2 the frontier-adaptive flood
   (``adaptive_k=ADAPTIVE_K``) on every layout, the adaptive hop distance
   on ``hybrid``, the recorded dense floods on every layout and 4t's lane
   ring recorded, 4r(e)'s faulted flood on ``mxu``; at world 8 the
   adaptive and faulted ``mxu`` floods and the hop census by host (4
   ranks a host). Each is held to 4u's and 4r(e)'s records, its sparse
   rounds to 4u's, its fault counts on every rank to 4r(e)'s, the census
   to the reference's (``EXPECTED_RING_HOP_CENSUS``), every rank's
   launches and exchanges to their prediction (``rank-adaptive-path``
   lines). Then, in this process, ``utils/trace.run_traced`` of phase
   4's ``hybrid`` flood, its records against phase 4's stats and its
   profile naming B1's kernel.
5. Result: a JSON line of kernel numbers (B1's OR launches summed over
   phases 4, 4c, 4b, 4i, 4n's closeness, 4o, 4p's floods, 4q's
   supervised flood, 4r's healed and faulted floods and 4s's nodes; B2's
   over 4b, 4r's faulted flood and 4s's forward hops, B2 reversed's row
   over 4s's re-masks, B3's over 4b and 4s's ``mxu`` nodes; its sum
   entry's on the hybrid remainder over 4e's ``hybrid`` run, 4f, 4i's
   ``KCore(hybrid)``, 4n's Bracha, HITS and betweenness and 4p's SIR, on
   the blocked layout over 4e's ``pallas`` run, ``KCore(pallas)`` and
   4n's ``Bracha(pallas)``; threefry's over 4e-4g, 4i, 4l's restart run,
   4n, 4p's SIR, 4r's corrupt bits, 4s's churn draws and 4t; the row-sum
   kernel's gather entry over 4p's PageRank and its dense entry over 4p's
   batch recorder and 4t's totals over the shards; 4t's rows: B3's sum
   form, B1's stacked sum, B2 on f32, on i32 and on the lane words, the
   row sums at ``[8, 125008]`` and at gossip's ``[8, 12512]``; 4v's
   rows: B2's hop across ranks at worlds 2 and 8 (the re-mask's, the
   faulted floods' and the census's hops), the gather at worlds 2 and 8
   and on f32, i32 and the lane words, the pass kernel at worlds 2 and 8
   and its sum form, their launches summed over every rank; 4v's
   protocol runs' B1 sums, threefry draws and row sums join those rows;
   4w's hops, gathers and pass kernels join the cross-rank rows of their
   world, its B1 OR launches (with 4v's floods' and the traced flood's),
   corrupt-bit draws and lane gathers and row sums theirs), then the
   last line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import gc
import hashlib
import json
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

#: The JAX reference's run-to-0.99 summary on the 1M-node benchmark graph.
#: Every method returns it (the reference pins them bit-identical to
#: ``segment``), and so does its 8-shard ring in each layout. Regenerate on
#: the CPU with the JAX package:
#:   JAX_PLATFORMS=cpu python -c "import jax; from p2pnetwork_tpu.sim import graph as G, engine; from p2pnetwork_tpu.models import Flood; g = G.watts_strogatz(1_000_000, 10, 0.1, seed=0, blocked=True, hybrid=True, source_csr=True); print(engine.run_until_coverage(g, Flood(method='segment'), jax.random.key(0), coverage_target=0.99, max_rounds=64)[1])"
#: and, for the ring (add ``mxu=True`` or ``hybrid=True`` to shard_graph):
#:   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 python -c "from p2pnetwork_tpu.sim import graph as G; from p2pnetwork_tpu.parallel import mesh, sharded; m = mesh.ring_mesh(8); g = G.watts_strogatz(1_000_000, 10, 0.1, seed=0); print(sharded.flood_until_coverage(sharded.shard_graph(g, m), m, 0, coverage_target=0.99, max_rounds=64, comm='ppermute')[1])"
EXPECTED_1M = {"rounds": 11, "coverage": 0.9997529983520508,
               "messages": 9372400,
               "frontier_occupancy_mean": 0.09088654816150665}
N_NODES = 1_000_000
N_PAD = 1_000_064

#: ``Flood(method="frontier", bitset=True)`` on that graph: its budget
#: (294,117 nodes; ``max_out_span`` 17) holds the frontiers entering
#: rounds 1 to 9 (1 to 130,851 nodes), not those of rounds 10 and 11
#: (352,626 and 402,135), as the JAX package counts them on the CPU.
FRONTIER_ROUNDS_1M = {"sparse": 9, "dense": 2}

#: The JAX reference on phase 4c's churned graph and phase 4d's BA rung,
#: made on the CPU with its ``segment`` method (its ``frontier`` +
#: ``bitset``, ``AdaptiveFlood`` and ``skew`` runs give the same dicts).
#: Regenerate (about a minute; layouts left out: ``segment`` reads none):
#:   JAX_PLATFORMS=cpu python - <<'EOF'
#:   import jax, numpy as np
#:   from p2pnetwork_tpu.sim import graph as G, engine as E, topology as T, failures as F
#:   from p2pnetwork_tpu.models import Flood
#:   k, p, i = jax.random.key(0), Flood(method="segment"), np.arange(64)
#:   cov = dict(coverage_target=0.99, max_rounds=64)
#:   g = G.watts_strogatz(1_000_000, 10, 0.1, seed=0, source_csr=True)
#:   g = T.connect(T.with_capacity(g, extra_edges=256), i * 37 % 99_000, (i * 91 + 13) % 99_000)
#:   g = F.fail_nodes(g, np.arange(5_000, 15_000))
#:   print(E.run_until_coverage(g, p, k, **cov)[1])
#:   s, st = E.run_from(g, p, p.init(g, k), k, 3, donate=False)
#:   print({n: np.asarray(v).tolist() for n, v in st.items()}, E.run_until_coverage_from(g, p, s, k, donate=False, **cov)[1])
#:   b = G.barabasi_albert(1_000_000, 5, seed=0, build_neighbor_table=False, source_csr=True, skew_table=True)
#:   print(b.skew.width, b.skew.n_rows, b.max_out_span, E.run_until_coverage(b, p, k, **cov)[1])
#:   cut = np.random.default_rng(0).choice(b.n_edges, b.n_edges // 100, replace=False)
#:   print(E.run_until_coverage(F.fail_edges(b, cut), p, k, **cov)[1])
#:   EOF
EXPECTED_CHURN = {"rounds": 11, "coverage": 0.9998626112937927,
                  "messages": 9409791,
                  "frontier_occupancy_mean": 0.09089651703834534}
EXPECTED_CHURN_RUN_FROM = {
    "messages": [12, 125, 455], "frontier": [12, 45, 181],
    "coverage": [1.3131312698533293e-05, 5.858585791429505e-05,
                 0.0002414141345070675],
    "frontier_occupancy": [1.2121212421334349e-05, 4.545454430626705e-05,
                           0.00018282828386873007]}
EXPECTED_CHURN_RESUMED = {"rounds": 8, "coverage": 0.9998626112937927,
                          "messages": 9409199,
                          "frontier_occupancy_mean": 0.12495265156030655}
EXPECTED_BA_SHAPE = {"skew_width": 8, "skew_rows": 1603696,
                     "max_out_span": 6795}
EXPECTED_BA = {"rounds": 4, "coverage": 0.9999989867210388,
               "messages": 9274831,
               "frontier_occupancy_mean": 0.2499994933605194}
EXPECTED_BA_CUT = {"rounds": 4, "coverage": 0.9999979734420776,
                   "messages": 9150030,
                   "frontier_occupancy_mean": 0.2499992549419403}

#: The keys of every engine call: ``prng.key(0)``'s words, the reference's
#: ``jax.random.key(0)``.
KEY = np.array([0, 0], dtype=np.uint32)

#: The keyed protocols at full width (phases 4e-4g): the JAX package on
#: the CPU, ``method="segment"`` (SIR's pressure sums are integers, so
#: every method gives its bits; push-sum's and PageRank's f32 sums move
#: by rounding between methods, hence the tolerances below). PageRank's
#: threshold lies midway, in log scale, between the reference's residuals
#: after rounds 20 and 21 (7.0287310336425435e-06 and
#: 5.405229330790462e-06), since sums in another order move a residual
#: by ulps. Regenerate (~20 s):
#:   JAX_PLATFORMS=cpu python - <<'EOF'
#:   import hashlib, jax, numpy as np
#:   from p2pnetwork_tpu.sim import graph as G, engine as E
#:   from p2pnetwork_tpu.models import SIR, PushSum, PageRank, Gossip
#:   from p2pnetwork_tpu.models.base import draw_neighbor_slot
#:   k, g = jax.random.key(0), G.watts_strogatz(1_000_000, 10, 0.1, seed=0)
#:   s, st = E.run(g, SIR(beta=0.3, gamma=0.05, source=0, method="segment"), k, 30)
#:   print({n: np.asarray(v).tolist() for n, v in st.items()}, hashlib.sha256(np.asarray(s.status).tobytes()).hexdigest())
#:   print({n: np.asarray(v).tolist() for n, v in E.run(g, PushSum(method="segment"), k, 30)[1].items()})
#:   r = np.asarray(E.run(g, PageRank(method="segment"), k, 40)[1]["residual"]); thr = float(np.sqrt(r[19] * r[20]))
#:   s, o = E.run_until_converged(g, PageRank(method="segment"), k, stat="residual", threshold=thr)
#:   print(thr, o, float(np.asarray(s.ranks).sum()))
#:   b = G.barabasi_albert(100_000, 4, seed=0, max_degree=128)
#:   print({n: np.asarray(v).tolist() for n, v in E.run(b, Gossip(alpha=0.5), k, 30)[1].items()})
#:   k0 = jax.random.split(jax.random.fold_in(k, 1), 30)[0]
#:   print(hashlib.sha256(np.asarray(draw_neighbor_slot(b, k0)[1]).tobytes()).hexdigest())
#:   EOF
SIR_RUNG = {"beta": 0.3, "gamma": 0.05, "source": 0}
SIR_ROUNDS = PUSHSUM_ROUNDS = GOSSIP_ROUNDS = 30
EXPECTED_SIR = {
    "messages": [
        11, 63, 184, 429, 859, 1801, 3719, 7924, 17042, 36114, 76188, 157676,
        328108, 671165, 1336569, 2539644, 4419324, 6629429, 8207523, 8596659,
        8326723, 7928280, 7532864, 7155276, 6798883, 6456931, 6135664, 5828845,
        5536587, 5259808],
    "coverage": [
        6.000000212225132e-06, 1.8999999156221747e-05, 4.400000034365803e-05,
        9.100000170292333e-05, 0.0001849999971454963, 0.0003800000122282654,
        0.0008120000129565597, 0.0017519999528303742, 0.0037360000424087048,
        0.007871000096201897, 0.016326000913977623, 0.03397199884057045,
        0.0695509985089302, 0.13875100016593933, 0.2648189961910248,
        0.4645169973373413, 0.7075240015983582, 0.8998680114746094,
        0.9812250137329102, 0.9980930089950562, 0.9998739957809448,
        0.9999949932098389, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
    "s_frac": [
        0.9999939799308777, 0.9999809861183167, 0.9999560117721558,
        0.999908983707428, 0.9998149871826172, 0.9996200203895569,
        0.9991880059242249, 0.9982479810714722, 0.9962639808654785,
        0.9921290278434753, 0.9836739897727966, 0.9660279750823975,
        0.9304490089416504, 0.8612490296363831, 0.7351809740066528,
        0.5354830026626587, 0.29247599840164185, 0.10013200342655182,
        0.01877499930560589, 0.0019069999689236283, 0.00012599999899975955,
        4.999999873689376e-06, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    "i_frac": [
        6.000000212225132e-06, 1.8000000636675395e-05, 4.199999966658652e-05,
        8.399999933317304e-05, 0.00017699999443721026, 0.0003650000144261867,
        0.0007789999945089221, 0.0016830000095069408, 0.0035749999806284904,
        0.007540999911725521, 0.015599999576807022, 0.03249000012874603,
        0.06647700071334839, 0.13238400220870972, 0.2517879903316498,
        0.43885400891304016, 0.6600300073623657, 0.8193899989128113,
        0.8597699999809265, 0.8332390189170837, 0.7934070229530334,
        0.7538130283355713, 0.7160000205039978, 0.6803489923477173,
        0.6461349725723267, 0.6139919757843018, 0.5832740068435669,
        0.5540220141410828, 0.5263329744338989, 0.49985501170158386],
    "r_frac": [
        0.0, 9.999999974752427e-07, 1.9999999949504854e-06,
        7.000000096013537e-06, 7.999999979801942e-06, 1.4999999621068127e-05,
        3.300000025774352e-05, 6.900000153109431e-05, 0.0001610000035725534,
        0.00033000000985339284, 0.0007259999983943999, 0.0014819999923929572,
        0.0030739998910576105, 0.0063669998198747635, 0.013031000271439552,
        0.025662999600172043, 0.04749400168657303, 0.0804779976606369,
        0.12145499885082245, 0.1648540049791336, 0.20646700263023376,
        0.24618199467658997, 0.2840000092983246, 0.3196510076522827,
        0.35386499762535095, 0.38600799441337585, 0.4167259931564331,
        0.44597798585891724, 0.4736669957637787, 0.5001450181007385],
    "status_sha256": (
        "483f3f1eee67f095d0f5701a2a49f326e5dd03d36e32ec01a9c20977a0eb501c")}
EXPECTED_PUSHSUM = {
    "messages": [
        9999994, 9999994, 9999994, 9999994, 9999994, 9999994, 9999994, 9999994,
        9999994, 9999994, 9999994, 9999994, 9999994, 9999994, 9999994, 9999994,
        9999994, 9999994, 9999994, 9999994, 9999994, 9999994, 9999994, 9999994,
        9999994, 9999994, 9999994, 9999994, 9999994, 9999994],
    "s_total": [
        157.4434051513672, 157.4429931640625, 157.4433135986328,
        157.44338989257812, 157.44332885742188, 157.44309997558594,
        157.44337463378906, 157.4431915283203, 157.44320678710938,
        157.443359375, 157.4432373046875, 157.44326782226562, 157.443359375,
        157.44322204589844, 157.44325256347656, 157.44326782226562,
        157.4433135986328, 157.44329833984375, 157.44326782226562,
        157.44332885742188, 157.44334411621094, 157.44326782226562,
        157.44332885742188, 157.44329833984375, 157.44329833984375,
        157.44332885742188, 157.44332885742188, 157.44334411621094,
        157.44334411621094, 157.44338989257812],
    "w_total": [
        1000000.0, 1000000.1875, 1000000.0, 1000000.125, 1000000.125,
        1000000.3125, 1000000.125, 1000000.25, 1000000.1875, 1000000.3125,
        1000000.3125, 1000000.5625, 1000000.3125, 1000000.4375, 1000000.25,
        1000000.4375, 1000000.3125, 1000000.5, 1000000.5625, 1000000.5625,
        1000000.4375, 1000000.5, 1000000.625, 1000000.5, 1000000.75,
        1000000.6875, 1000000.6875, 1000000.6875, 1000000.6875, 1000000.8125],
    "variance": [
        0.09237845242023468, 0.04761618375778198, 0.03338276222348213,
        0.025163283571600914, 0.01962435431778431, 0.01563839241862297,
        0.012654215097427368, 0.010358442552387714, 0.008556576445698738,
        0.007120463997125626, 0.00596182607114315, 0.005017739720642567,
        0.004242104012519121, 0.003600410185754299, 0.0030663423240184784,
        0.0026195368263870478, 0.0022440259344875813, 0.0019271568162366748,
        0.0016588042490184307, 0.001430799369700253, 0.0012365051079541445,
        0.001070493133738637, 0.0009282976971007884, 0.0008062266861088574,
        0.0007012130809016526, 0.0006106983637437224, 0.0005325403180904686,
        0.0004649387556128204, 0.00040637553320266306, 0.0003555674629751593],
    "mean": [
        0.00013331579975783825, 0.0001522622478660196, 0.00015338088269345462,
        0.00015482593153137714, 0.00015564242494292557, 0.00015609068213962018,
        0.00015642796643078327, 0.00015669070126023144, 0.0001569313317304477,
        0.00015715706103947014, 0.0001573721965542063, 0.00015757433720864356,
        0.00015776119835209101, 0.00015793039347045124, 0.00015808027819730341,
        0.00015821022680029273, 0.0001583205594215542, 0.0001584118144819513,
        0.00015848511247895658, 0.00015854199591558427, 0.00015858365804888308,
        0.0001586120924912393, 0.00015862863801885396, 0.00015863482258282602,
        0.00015863205771893263, 0.00015862175496295094, 0.0001586051075719297,
        0.0001585830468684435, 0.0001585567370057106, 0.0001585269783390686]}
EXPECTED_PAGERANK = {
    "threshold": 6.16375722601741e-06,
    "rounds": 21,
    "messages": 209999874,
    "value": 5.405229330790462e-06,
    "rank_total": 1.0000001192092896}
EXPECTED_GOSSIP = {
    "messages": [
        200000, 200000, 200000, 200000, 200000, 200000, 200000, 200000, 200000,
        200000, 200000, 200000, 200000, 200000, 200000, 200000, 200000, 200000,
        200000, 200000, 200000, 200000, 200000, 200000, 200000, 200000, 200000,
        200000, 200000, 200000],
    "variance": [
        0.5022070407867432, 0.2889656126499176, 0.17356370389461517,
        0.10707402974367142, 0.06704597920179367, 0.04250214248895645,
        0.027301691472530365, 0.017428560182452202, 0.011235734447836876,
        0.0072490144520998, 0.004723094403743744, 0.0030730459839105606,
        0.002001167042180896, 0.0013217380037531257, 0.0008724357467144728,
        0.000574061123188585, 0.00037840212462469935, 0.00024819510872475803,
        0.0001634813379496336, 0.00010820919851539657, 7.122169336071238e-05,
        4.693190203397535e-05, 3.103880226262845e-05, 2.0503121049841866e-05,
        1.356362372462172e-05, 9.015850992000196e-06, 5.958348992862739e-06,
        3.951377948396839e-06, 2.6231041374558117e-06, 1.735616933729034e-06],
    "mean": [
        -0.0008120969287119806, 0.001167766167782247, 0.0020948858000338078,
        0.003614371409639716, 0.004366429056972265, 0.004799111746251583,
        0.005377727560698986, 0.005247979890555143, 0.005289474502205849,
        0.00548478402197361, 0.005677328445017338, 0.005378237459808588,
        0.005095393862575293, 0.005145453382283449, 0.005308592692017555,
        0.005344639997929335, 0.005377495661377907, 0.005339034367352724,
        0.005368947051465511, 0.0053900983184576035, 0.0053740087896585464,
        0.005361414980143309, 0.005362977273762226, 0.005360523238778114,
        0.005358944181352854, 0.005377057008445263, 0.00539065059274435,
        0.0053845117799937725, 0.005379116162657738, 0.0053769382648169994],
    "partners_sha256": (
        "157f65b5c4134b6c2b94a393249aed76fd01f310e81d89b67055d1bb281916e0")}
#: (rtol, atol) of each f32 stat against the reference. The port's sums
#: run in another order (B1's rows and atomics, the diagonals, torch's
#: reductions) and its normal draws are within 3 ulp of jax's; on the CPU
#: at these sizes the port is off by: push-sum s_total 3.1e-4 (of ~157,
#: a sum of 1M terms of size ~1), w_total 0.25 (of 1e6, ulp 0.0625),
#: variance 2.4e-7 and mean 3.3e-6 relative; PageRank's residual 8.4e-6
#: relative, rank_total 1.2e-7; gossip's variance 2.1e-7 and mean 8e-7
#: relative. The bounds leave a margin of 10x or more for the card's
#: other order.
PUSHSUM_TOL = {"s_total": (0.0, 1e-2), "w_total": (0.0, 2.0),
               "variance": (1e-4, 0.0), "mean": (0.0, 1e-8)}
PAGERANK_TOL = {"value": (1e-4, 0.0), "rank_total": (0.0, 1e-5)}
GOSSIP_TOL = {"variance": (1e-4, 0.0), "mean": (1e-4, 1e-8)}

#: The ladder's weighted routing rung (phase 4h) and the graph analytics
#: of phase 4i, by the JAX package on the CPU with ``method="segment"``
#: (every lowering gives the same bits: a max or min picks one of its
#: terms, and each min-plus term is the same f32 add). ``LeaderElection``
#: and ``ConnectedComponents`` end on the same array (one component, all
#: 999,999). ``KCore(k=10)`` peels the WS graph empty in 6 rounds.
#: Regenerate (~1 min):
#:   JAX_PLATFORMS=cpu python - <<'EOF'
#:   import hashlib, jax, numpy as np
#:   from p2pnetwork_tpu.sim import graph as G, engine as E
#:   from p2pnetwork_tpu.models import AdaptiveHopDistance, DistanceVector, HopDistance, LeaderElection, ConnectedComponents, SpanningTree, KCore, LubyMIS, color_via_mis
#:   from p2pnetwork_tpu.models.hopdist import diameter_bounds
#:   k, h = jax.random.key(0), lambda a: hashlib.sha256(np.asarray(a).tobytes()).hexdigest()
#:   def lat(s, r): return 1.0 + ((s.astype(np.uint32) * np.uint32(2654435761) + r.astype(np.uint32)) % 2048).astype(np.float32) / 1024.0
#:   conv = lambda g, p, stat: E.run_until_converged(g, p, k, stat=stat, threshold=1, max_rounds=256)
#:   for g in (G.watts_strogatz(1_000_000, 10, 0.1, seed=0, build_neighbor_table=False), G.barabasi_albert(1_000_000, 5, seed=0, build_neighbor_table=False)):
#:       g, p = g.with_weights(lat), DistanceVector(source=0, method="segment"); s, o = conv(g, p, "changed")
#:       print(o, h(s.dist), h(s.parent), h(p.next_hops(g, s)))
#:   s, o = conv(g, LeaderElection(method="segment"), "changed"); print(o, h(s.known))  # the BA rung
#:   g = G.watts_strogatz(1_000_000, 10, 0.1, seed=0)
#:   s, o = conv(g, HopDistance(method="segment"), "frontier"); print(o, h(s.dist))
#:   print(conv(g.with_source_csr(), AdaptiveHopDistance(method="segment", k=1024), "frontier")[1])
#:   print(diameter_bounds(g, k, 16, "segment"))
#:   for P, stat, f in ((LeaderElection, "changed", "known"), (ConnectedComponents, "changed", "label"), (SpanningTree, "frontier", "parent")):
#:       s, o = conv(g, P(method="segment"), stat); print(o, h(getattr(s, f)))
#:   s, o = conv(g, KCore(k=10, method="segment"), "removed"); print(o, h(s.in_core))
#:   s, o = conv(g, LubyMIS(method="segment", or_method="segment"), "undecided"); print(o, h(s.in_mis))
#:   c, n = color_via_mis(g, k, method="segment"); print(n, h(c))
#:   EOF
EXPECTED_ROUTE = {
    "ws": {"rounds": 17, "value": 0.0, "messages": 16546551,
           "dist_sha256": ("d5a72d7a2f44b7f0875dc4061a235267"
                           "552396b9eb8be10b5ef4a54b813d0e08"),
           "parent_sha256": ("4894ac7d8925631527847320da9b5c2c"
                             "b65a64e68a1cabd683dcaa580e0120a9"),
           "next_hops_sha256": ("f0afcbf1fd50ded0bcf6f5c3d34b9f98"
                                "70cb619876e8e32fbcf290bbf0202113")},
    "ba": {"rounds": 7, "value": 0.0, "messages": 12355126,
           "dist_sha256": ("62e8089c55cda5d215f9707685b2aca7"
                           "2d13a3e0173ec3919e1dca7f43b929a0"),
           "parent_sha256": ("2cda3bc17beb0446ff8dc1a0dd3c7758"
                             "e2947258f7d00176f94a08b21b611243"),
           "next_hops_sha256": ("bede07def0a321a0a1bf5c98d490c58d"
                                "a46d8f136fa74b9d7da30c16714218de")}}
#: Every live node ends holding 999,999, on either graph.
_ALL_999999 = ("a158d45205cf66f0edb98de9f75fbf5b"
               "647867192ee0ecbff0439c9d98c956f6")
_HOP_DIST = ("d84f8d9ba5301749b536e1cf138a6154"
             "7fae2dd54cdda43918a34e4c3cc8df66")
EXPECTED_ANALYTICS = {
    "hop": {"rounds": 13, "value": 0.0, "messages": 9999994,
            "sha256": _HOP_DIST},
    "adaptive_hop": {"rounds": 13, "value": 0.0, "messages": 9999994,
                     "frontier_occupancy_mean": 0.07692300528287888,
                     "sha256": _HOP_DIST},
    "diameter": {"lower": 13, "upper": 24, "radius_upper": 12,
                 "connected": True},
    "leader": {"rounds": 13, "value": 0.0, "messages": 105825236,
               "sha256": _ALL_999999},
    "leader_ba": {"rounds": 8, "value": 0.0, "messages": 57205697,
                  "sha256": _ALL_999999},
    "components": {"rounds": 13, "value": 0.0, "messages": 105825236,
                   "sha256": _ALL_999999},
    "spanning": {"rounds": 13, "value": 0.0, "messages": 9999994,
                 "sha256": ("24497e668dabf64cb92252dee1c5f9ef"
                            "6c305e810aaff20619fa35a8164ab728")},
    "kcore": {"rounds": 6, "value": 0.0, "messages": 9999994,
              "sha256": ("900740ec474a754ebed1c6220612bf1e"
                         "b0dff672575edbf9f965d80741322593")},
    "mis": {"rounds": 5, "value": 0.0, "messages": 13837552,
            "sha256": ("4f750a4ff241695563878bc74b42a255"
                       "9c0f4e9ad847879228414b3528bb2d71")},
    "coloring": {"n_colors": 10,
                 "sha256": ("4620bd53dbc28ec64fb4ba44a8eeb20d"
                            "d1ecdfb017d5565c07befad62a571dac")}}
KCORE_K = 10

#: Phase 4p: a churn epoch on phase 4's graph (``DELTA_PAIRS`` live
#: undirected pairs removed and as many random pairs added, drawn from
#: ``default_rng(DELTA_SEED)``), growth by ``GROW_NODES`` nodes wired to
#: ``GROW_FANOUT`` peers each (the same generator's next draws), the
#: recorder rings, the checkpoint cuts and the graph file. The reference
#: values (``EXPECTED_4P``) are the JAX package's on the CPU (its floods
#: by ``segment``: OR is exact, so every method gives the same bits);
#: regenerate with the recipe in the comment above ``EXPECTED_4P``.
DELTA_SEED, DELTA_PAIRS = 11, 50_000
GROW_NODES, GROW_FANOUT = 64, 2
REC_CAPACITY, BATCH_REC_CAPACITY = 8, 16
#: Runs with and without the recorder, taken in turns, for its cost: the
#: host clock spreads 30-50% between runs, more than the cost itself.
REC_PAIRS = 9
FLOOD_STOP, SIR_STOP = 5, 15
#: Regenerate (about 25 s; ``graph_digest`` and the constants above are
#: this script's):
#:   JAX_PLATFORMS=cpu python - <<'EOF'
#:   import hashlib, tempfile, jax, numpy as np
#:   from chip_smoke import *
#:   from p2pnetwork_tpu.sim import graph as G, engine as E, checkpoint as C, flightrec as R
#:   from p2pnetwork_tpu.models import Flood, SIR
#:   from p2pnetwork_tpu.models.messagebatch import BatchFlood
#:   h = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
#:   k, p, cov = jax.random.key(0), Flood(source=0, method="segment"), dict(coverage_target=0.99, max_rounds=64)
#:   def flood(gr): st, o = E.run_until_coverage(gr, p, k, **cov); return {**o, "seen_sha256": h(st.seen)}
#:   g = G.watts_strogatz(1_000_000, 10, 0.1, seed=0, blocked=True, hybrid=True, source_csr=True); print(graph_digest(g))
#:   rng = np.random.default_rng(DELTA_SEED); s, r = np.asarray(g.senders)[:g.n_edges], np.asarray(g.receivers)[:g.n_edges]
#:   pick = rng.choice(np.flatnonzero(s < r), DELTA_PAIRS, replace=False); a = rng.integers(0, g.n_nodes, DELTA_PAIRS)
#:   b = (a + rng.integers(1, g.n_nodes, DELTA_PAIRS)) % g.n_nodes
#:   gd = G.apply_delta(g, G.GraphDelta.undirected(add_senders=a, add_receivers=b, remove_senders=s[pick], remove_receivers=r[pick]))
#:   print(gd.n_edges, graph_digest(gd), flood(gd))
#:   new = np.arange(g.n_nodes, g.n_nodes + 2 * GROW_NODES); peers = rng.integers(0, g.n_nodes, new.size * GROW_FANOUT)
#:   gw = G.apply_delta(G.grow(G.grow(gd, GROW_NODES), GROW_NODES), G.GraphDelta.undirected(add_senders=np.repeat(new, GROW_FANOUT), add_receivers=peers))
#:   print(gw.n_nodes_padded, graph_digest(gw), flood(gw))
#:   for T in (1, 4): st, o = E.run_until_coverage_from(g, p, p.init(g, k), k, steps_per_round=T, recorder=R.FlightRecorder(REC_CAPACITY), donate=False, **cov); f = o.pop("flight_record"); print(o, f.dropped, h(f.rows))
#:   d = tempfile.mkdtemp(); dig = lambda f: bytes(np.load(f)["__sha256__"]).decode()
#:   st5, o5 = E.run_until_coverage_from(g, p, p.init(g, k), k, coverage_target=0.99, max_rounds=FLOOD_STOP, donate=False)
#:   C.save(d + "/f.npz", st5, k, o5["rounds"], o5["messages"])
#:   st, o = E.run_until_coverage_from(g, p, C.load(d + "/f.npz", p.init(g, k))[0], k, **cov); print(o5, dig(d + "/f.npz"), o, h(st.seen))
#:   sp = SIR(method="segment", **SIR_RUNG); s15, st15 = E.run_from(g, sp, sp.init(g, k), k, SIR_STOP, donate=False)
#:   C.save(d + "/s.npz", s15, jax.random.fold_in(k, SIR_STOP), SIR_STOP, int(np.asarray(st15["messages"]).sum()))
#:   sl, kl, _, ml = C.load(d + "/s.npz", sp.init(g, k)); s30, st30 = E.run_from(g, sp, sl, kl, SIR_STOP, donate=False)
#:   print(dig(d + "/s.npz"), ml, h(s30.status), np.asarray(st30["messages"]).tolist())
#:   bg = G.watts_strogatz(100_000, 10, 0.1, seed=0, source_csr=True); bp = BatchFlood(method="auto")
#:   src = np.random.default_rng(0).integers(0, bg.n_nodes, 1024).astype(np.int32)
#:   o = E.run_batch_until_coverage(bg, bp, bp.init(bg, src), k, max_rounds=64, donate=False, recorder=R.FlightRecorder(BATCH_REC_CAPACITY))[1]
#:   print(h(o["flight_record"].rows))
#:   EOF
EXPECTED_4P = {
    "graph_sha256": ("f705b2fe12777b2f26e49d9b229899cc"
                    "1a69f2c3b6e03543d4b5500062894438"),
    "delta": {"n_edges": 9999994, "rounds": 11,
              "coverage": 0.9999610185623169,
              "messages": 9733246,
              "frontier_occupancy_mean": 0.09090545773506165,
              "graph_sha256": ("76728b4881805f325772f0164bb95a95"
                    "449f3fdacef76389f5589c9352db2c48"),
              "seen_sha256": ("31418a3454261b4bcafb795f16dd8d83"
                    "9071c19a977079ca5f1ca934cdb0ed2c")},
    "grow": {"n_pad": 2000128, "rounds": 11,
             "coverage": 0.9999610185623169,
             "messages": 9733742,
             "frontier_occupancy_mean": 0.09090545773506165,
             "graph_sha256": ("75fc4f117475a408f56c28c3ad249bd7"
                    "0478ea4303591930eab4b22d37a96f3f"),
             "seen_sha256": ("c04264483cc0fcc9396ab0720548dff8"
                    "2c1782a5bf54c06e9ba4f886305fedab")},
    "rec_1": {"dropped": 3,
              "rows_sha256": ("b849a88d69b03d723312c71c5e008424"
                    "fcce1125d0d8b9898ac2b265b8fdc242")},
    "rec_4": {"dropped": 3,
              "rows_sha256": ("b849a88d69b03d723312c71c5e008424"
                    "fcce1125d0d8b9898ac2b265b8fdc242")},
    "ckpt_flood": {
        "stop": {'rounds': 5, 'coverage': 0.0033650000113993883, 'messages': 8857, 'frontier_occupancy_mean': 0.000672800000756979},
        "file_sha256": ("7af3cd60f455a7936a2df79a524006b9"
                    "8c7af13e10d81a3b395e45931d3ff189"),
        "resumed": {'rounds': 6, 'coverage': 0.9997529983520508, 'messages': 9363543, 'frontier_occupancy_mean': 0.16606466472148895}},
    "ckpt_sir": {
        "file_sha256": ("40a81d31a9829c71269c65da2708ae7d"
                    "4887a335935077f38cac163254bb00f1"),
        "messages_at_stop": 2637852,
        "status_sha256": ("79874a9376df937db5c0d468e10b619c"
                    "82b2d394c87a7157602e08d9227aed1e"),
        "messages": [2539644, 4418252, 6639477, 8213026, 8600120, 8334420, 7937582, 7543010, 7166840, 6807144, 6464770, 6145843, 5838978, 5546234, 5267499]},
    "batch_rec": {"rows_sha256": ("53081bc0472999efab88d18ea08672e1"
                    "f1d7b9f5bf7991504e4e6b6b60ad5005"),
                  "rows": [[1.0, 0.09757000207901001, 10278.0, 10278.0, 11302.0, 1024.0, 0.0], [2.0, 0.2535000145435333, 103944.0, 114222.0, 40887.0, 1024.0, 0.0], [3.0, 0.7205100059509277, 300405.0, 414627.0, 175613.0, 1024.0, 0.0], [4.0, 0.9841200113296509, 1365434.0, 1780061.0, 678768.0, 1024.0, 0.0], [5.0, 0.9999899864196777, 5097064.0, 6877125.0, 2668546.0, 1024.0, 0.0], [6.0, 1.0, 20150658.0, 27027784.0, 10020809.0, 1024.0, 0.0], [7.0, 1.0, 74403000.0, 101430768.0, 33417312.0, 1024.0, 0.0], [8.0, 1.0, 236135072.0, 337565824.0, 77573864.0, 1024.0, 0.0], [9.0, 1.0, 442073504.0, 779639360.0, 101054424.0, 414.0, 0.0], [10.0, 0.0, 126671256.0, 906310592.0, 102130432.0, 0.0, 0.0]]},
}

#: Phase 4j: bench.py's batched column (``time_batch_flood``, ``bench_batched``)
#: on its 100K WS class: B = 1,024 floods to 0.99 by ``BatchFlood``, the
#: sources its ``default_rng(0)``'s first ``integers(0, n, 1024)``; every
#: method returns the same result. Then every lane retired and the
#: generator's next 1,024 sources admitted into the same batch
#: (``second_wave``). The sha256s are of ``lane_done`` (bool),
#: ``lane_rounds`` and ``lane_messages`` (i32) and the final ``seen`` words
#: (the reference's uint32 bytes). Regenerate on the CPU (~20 s):
#:   JAX_PLATFORMS=cpu python - <<'EOF'
#:   import hashlib, jax, numpy as np
#:   from p2pnetwork_tpu.sim import graph as G, engine
#:   from p2pnetwork_tpu.models.messagebatch import BatchFlood, lane_messages
#:   h = lambda a, t: hashlib.sha256(np.asarray(a).astype(t).tobytes()).hexdigest()
#:   g = G.watts_strogatz(100_000, 10, 0.1, seed=0, source_csr=True)
#:   rng = np.random.default_rng(0); src = rng.integers(0, g.n_nodes, 1024)
#:   nxt = rng.integers(0, g.n_nodes, 1024); p = BatchFlood(method="auto")
#:   def show(st, o): print({k: o.get(k) for k in ("rounds", "completed", "active_lanes", "messages", "occupancy_mean", "completion_rounds_p50", "completion_rounds_p99")}, h(o["lane_done"], bool), h(o["lane_rounds"], np.int32), h(lane_messages(g, st), np.int32), h(st.seen, np.uint32))
#:   st, o = engine.run_batch_until_coverage(g, p, p.init(g, src.astype(np.int32)), jax.random.key(0), max_rounds=64, donate=False); show(st, o)
#:   st, _ = p.admit(g, p.retire(st), nxt.astype(np.int32))
#:   show(*engine.run_batch_until_coverage(g, p, st, jax.random.key(0), max_rounds=64, donate=False))
#:   EOF
BATCH_N, BATCH_B, BATCH_METHODS = 100_000, 1024, ("auto", "gather", "segment",
                                                   "frontier")
#: Lanes run again as single floods (``time_batch_flood``'s seq_sample).
BATCH_SAMPLE = 4
EXPECTED_BATCH = {
    "first": {"rounds": 10, "completed": 1024, "active_lanes": 0,
              "messages": 906310616, "occupancy_mean": 0.7055689692497253,
              "completion_rounds_p50": 9.0, "completion_rounds_p99": 10.0,
              "lane_done_sha256": ("5a648d8015900d89664e00e125df1796"
                                   "36301a2d8fa191c1aa2bd9358ea53a69"),
              "lane_rounds_sha256": ("b5abd337d96452a6eb967f5bc479ba98"
                                     "7767d3f3f52cdf0b95e71a85b1eda6e3"),
              "lane_messages_sha256": ("d89281ff2b54ae00bf92ba885893f418"
                                       "774dce4f7842781cb7d71dab92b8479e"),
              "seen_sha256": ("3ffbc438b48cdd790218133ec57f2ce2"
                              "62db1b265c07eaad5cbabcf64baed3ca")},
    "second_wave": {
        "rounds": 10, "completed": 1024, "active_lanes": 0,
        "messages": 909216814, "occupancy_mean": 0.7048779726028442,
        "completion_rounds_p50": 9.0, "completion_rounds_p99": 10.0,
        "lane_done_sha256": ("5a648d8015900d89664e00e125df1796"
                             "36301a2d8fa191c1aa2bd9358ea53a69"),
        "lane_rounds_sha256": ("aaa09eea0a8a11f18d6ec6cc6fe8c3ae"
                               "58835f44964bdcf35d0a8bbfe4dfaee8"),
        "lane_messages_sha256": ("fb2382e08a052b2718abef30ff636060"
                                 "3566b696823063fdf1c51dca3e9a6db3"),
        "seen_sha256": ("af964452d9edd9d713d0f4649194ac6b"
                        "c2bf51156c2874bc901c35d1a502df6d")}}

#: Phase 4k: bench.py's query column (``bench_queries``,
#: ``time_query_family``): one ``default_rng(0)`` draws 64 min-plus sources,
#: then 64 targets; push-sum's seeds are ``arange(32) * 7 + 1``
#: (threshold 1e-4, ``max_rounds=512``); then 2,048 DHT origins and 2,048
#: keys, used on ``chord(100_000)`` (``ring``, as the bench) and on
#: ``kademlia(100_000)`` (``xor``; its table is [100096, 31089]: node
#: 65,536 is the fallback contact of 31,072 nodes' top bucket). Min-plus
#: ``max_rounds=256`` by ``auto`` (gather) and ``segment``, DHT 128. The
#: sha256s are of ``lane_done``, ``lane_rounds`` and ``lane_values`` (f32
#: bits or i32). Regenerate on the CPU (~90 s, most of it kademlia's table):
#:   JAX_PLATFORMS=cpu python - <<'EOF'
#:   import hashlib, jax, numpy as np
#:   from p2pnetwork_tpu.sim import graph as G, engine
#:   from p2pnetwork_tpu.models.querybatch import MinPlusQueries, PushSumQueries, DhtLookups
#:   h = lambda a, t: hashlib.sha256(np.asarray(a).astype(t).tobytes()).hexdigest()
#:   def run(g, p, qb, r): o = engine.run_queries_until_done(g, p, qb, jax.random.key(0), max_rounds=r)[1]; print(o, h(o["lane_done"], bool), h(o["lane_rounds"], np.int32), h(o["lane_values"], o["lane_values"].dtype))
#:   g = G.watts_strogatz(100_000, 10, 0.1, seed=0, source_csr=True); rng = np.random.default_rng(0)
#:   s = rng.integers(0, g.n_nodes, 64).astype(np.int32); t = rng.integers(0, g.n_nodes, 64).astype(np.int32)
#:   for m in ("auto", "segment"): p = MinPlusQueries(method=m); run(g, p, p.init(g, s, t), 256)
#:   p = PushSumQueries(); run(g, p, p.init(g, (np.arange(32) * 7 + 1).astype(np.int32), threshold=1e-4), 512)
#:   o = rng.integers(0, 100_000, 2048).astype(np.int32); k = rng.integers(0, 100_000, 2048).astype(np.int32)
#:   for gd, m in ((G.chord(100_000), "ring"), (G.kademlia(100_000), "xor")): p = DhtLookups(metric=m); run(gd, p, p.init(gd, o, k), 128)
#:   EOF
_MINPLUS = {"rounds": 9, "completed": 64, "active_lanes": 0,
            "messages": 40849335, "occupancy_mean": 0.7465277910232544,
            "completion_rounds_p50": 8.0, "completion_rounds_p99": 9.0,
            "lane_done_sha256": ("7c8975e1e60a5c8337f28edf8c33c3b1"
                                 "80360b7279644a9bc1af3c51e6220bf5"),
            "lane_rounds_sha256": ("c1bfa85b16ac060f11fae62c806bed33"
                                   "8fcb4fec962d635cb39ba5d1f81cdfa7"),
            "lane_values_sha256": ("83ab8a01e5f163294f4cb0e1dee3ac1f"
                                   "6324c4d2127ed1ad2f18b4a4aa2ceb99")}
_DHT_FOUND = ("7425ce1f54610563648c34393c4cc1c6"
              "2badd9f1be3570d4a4f43d6f30326e28")
EXPECTED_QUERIES = {
    "minplus-auto": _MINPLUS,
    "minplus-segment": _MINPLUS,
    "pushsum": {
        "rounds": 42, "completed": 32, "active_lanes": 0,
        "messages": 1278000000, "occupancy_mean": 0.9508928656578064,
        "completion_rounds_p50": 40.0, "completion_rounds_p99": 41.0,
        "lane_done_sha256": ("72cd6e8422c407fb6d098690f1130b7d"
                             "ed7ec2f7f5e1d30bd9d521f015363793"),
        "lane_rounds": [40, 40, 40, 40, 40, 40, 41, 40, 40, 40, 39, 40, 40,
                        40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 39, 40, 40,
                        39, 39, 40, 40, 40, 41]},
    "dht-chord-ring": {
        "rounds": 14, "completed": 2048, "active_lanes": 0,
        "messages": 15909, "occupancy_mean": 0.4834333062171936,
        "completion_rounds_p50": 8.0, "completion_rounds_p99": 12.0,
        "lane_done_sha256": ("7c7d2eb358671b401d2a5e59bf56e716"
                             "3e16994a170d4788faad9be5d82363b2"),
        "lane_rounds_sha256": ("16df347a9be26e843499a9daa5dcc816"
                               "d576fd96697071e8e34a9a99ecc96bf1"),
        "lane_values_sha256": _DHT_FOUND, "found": 2048},
    "dht-kademlia-xor": {
        "rounds": 15, "completed": 2048, "active_lanes": 0,
        "messages": 16933, "occupancy_mean": 0.4845377504825592,
        "completion_rounds_p50": 8.0, "completion_rounds_p99": 13.0,
        "lane_done_sha256": ("7c7d2eb358671b401d2a5e59bf56e716"
                             "3e16994a170d4788faad9be5d82363b2"),
        "lane_rounds_sha256": ("f008d9abf2b1f384195a23d33f06532d"
                               "2503a8c54fee4ca4abddeb49cb27ce0e"),
        "lane_values_sha256": _DHT_FOUND, "found": 2048}}
#: Push-sum's answers (each lane's mean estimate, about 1e-3) against the
#: reference's: the seed fields are within 3 ulp of jax's and the means
#: and variances are f32 column sums in another order than XLA's GEMV
#: (the port's CPU run differs by at most 3.6e-8). Rounds, lane rounds
#: and messages are held exactly.
PUSHSUM_QUERY_TOL = (1e-4, 1e-6)
EXPECTED_PUSHSUM_VALUES = [
    -0.0039657424204051495, -0.000852118362672627, 0.003924625460058451,
    0.0003367922909092158, -0.0007090995786711574, 0.0012202756479382515,
    0.00341115053743124, 0.0013134179171174765, -0.0007324972539208829,
    0.00212390860542655, 0.0013795527629554272, -0.004416530951857567,
    0.00039637135341763496, 0.0027708150446414948, 0.0011217595310881734,
    -0.003395003965124488, -0.0029662884771823883, 5.3600408136844635e-05,
    -0.005888913758099079, 0.0027591586112976074, -0.003930926788598299,
    -0.006248841527849436, -0.0032334253191947937, -0.0005782926455140114,
    -0.0056971777230501175, -0.0004934812313877046, -0.0010143463732674718,
    0.0016288083279505372, -0.002188502112403512, 0.0021218545734882355,
    0.000312176562147215, -0.002690378110855818]

#: Phase 4l: the ladder's discovery rung (``benchmarks/ladder.py``
#: ``bench_discovery``): ``RandomWalks(n_walkers=4096)`` to 0.99 of the 1M
#: WS graph, ``key(0)``, ``max_rounds=8192``; then ``restart_p=0.02``. The
#: ladder builds the graph without a neighbor table, which the walk never
#: reads: phase 4's graph gives the same numbers. ``coverage_bits`` is the
#: f32 coverage's bit pattern; the sha256s are of the final ``visited``
#: (bool) and ``pos`` (i32). Regenerate (~15 s):
#:   JAX_PLATFORMS=cpu python - <<'EOF'
#:   import hashlib, jax, numpy as np
#:   from p2pnetwork_tpu.sim import graph as G, engine as E
#:   from p2pnetwork_tpu.models import RandomWalks
#:   h = lambda a: hashlib.sha256(np.asarray(a).tobytes()).hexdigest()
#:   g = G.watts_strogatz(1_000_000, 10, 0.1, seed=0, build_neighbor_table=False, source_csr=True)
#:   for rp in (0.0, 0.02):
#:       s, o = E.run_until_coverage(g, RandomWalks(n_walkers=4096, restart_p=rp), jax.random.key(0), coverage_target=0.99, max_rounds=8192)
#:       print(o, int(np.float32(o["coverage"]).view(np.int32)), h(s.visited), h(s.pos))
#:   EOF
WALKERS = 4096
EXPECTED_WALK = {
    "plain": {"rounds": 1721, "coverage": 0.9900140166282654,
              "messages": 7049216, "coverage_bits": 1065185679,
              "visited_sha256": ("6975a1e9fe6e789e7550a5fe6f393757"
                                 "0739a5e000751ef49f5c750ee53eb67a"),
              "pos_sha256": ("49acb773e88a8c5b1f3cd0ec7d71fcf8"
                             "32b222de3e0862ea6b296ad6dc369a99")},
    "restart": {"rounds": 2046, "coverage": 0.990011990070343,
                "messages": 8375530, "coverage_bits": 1065185645,
                "visited_sha256": ("558dd7c70b7508e1339c672aaab6b567"
                                   "983dce19b67d9093fb2a18abb2f86dd2"),
                "pos_sha256": ("af57cb37b01620920f7dce72e92dd778"
                               "ef0736cecf291cead390884e7b5e3bd4")}}

#: Phase 4m: the ladder's Plumtree rung (``bench_plumtree``) on phase 4h's
#: 1M WS rung (no neighbor table; its latency weights ride into the
#: tree): the first broadcast (a flood that prunes the eager set to a
#: tree), ``tree_graph(source_csr=True)`` and a flood over it to coverage
#: 1.0, then a second broadcast over the tree. ``coverage`` is by its f32
#: bits, ``eager_sha256`` of the eager set (bool). Regenerate (~10 s):
#:   JAX_PLATFORMS=cpu python - <<'EOF'
#:   import hashlib, jax, numpy as np
#:   from p2pnetwork_tpu.sim import graph as G, engine as E
#:   from p2pnetwork_tpu.models import Flood, Plumtree
#:   def lat(s, r): return 1.0 + ((s.astype(np.uint32) * np.uint32(2654435761) + r.astype(np.uint32)) % 2048).astype(np.float32) / 1024.0
#:   k, g = jax.random.key(0), G.watts_strogatz(1_000_000, 10, 0.1, seed=0, build_neighbor_table=False).with_weights(lat)
#:   p = Plumtree(source=0); st = p.init(g, k)
#:   for i in range(2):
#:       st, so = jax.jit(p.step)(g, st, k)
#:       print({n: int(v) if n != "coverage" else int(np.float32(v).view(np.int32)) for n, v in so.items()}, hashlib.sha256(np.asarray(st.eager).tobytes()).hexdigest())
#:       if i == 0:
#:           tg = p.tree_graph(g, st, source_csr=True); print(tg.n_edges, E.run_until_coverage(tg, Flood(source=0), k, coverage_target=1.0, max_rounds=256)[1])
#:   EOF
_EAGER_TREE = ("a85e077238ebcdc1cbfb841447855863"
               "237ff1224efc4bfe408721b84374fbd1")
EXPECTED_PLUMTREE = {
    "first": {"messages": 9999994, "ihave": 0, "duplicates": 8999994,
              "grafts": 0, "eager_edges": 999999, "coverage": 1065353216,
              "eager_sha256": _EAGER_TREE},
    "tree_edges": 999999,
    "tree_flood": {"rounds": 12, "coverage": 1.0, "messages": 999999,
                   "frontier_occupancy_mean": 0.08333325386047363},
    "second": {"messages": 999999, "ihave": 8999995, "duplicates": 0,
               "grafts": 0, "eager_edges": 999999, "coverage": 1065353216,
               "eager_sha256": _EAGER_TREE}}

#: Phase 4n: the protocol library on phase 4's graph, by the JAX package
#: on the CPU with ``method="segment"`` where a protocol takes one (the
#: port runs ``hybrid``/``pallas``: Bracha's and the centralities' counts
#: are integers or the same f32 terms, HITS's and betweenness's sums move
#: by rounding, hence the tolerances below). Bracha with ``byzantine=(1,
#: 2)`` does not quiesce on this graph: the two Byzantine nodes' READYs
#: reach ``f + 1 = 2`` at their common neighbors, and the amplification
#: creeps along the ring lattice ~14 nodes a round, so the run is held at
#: its 256-round cap (``value`` is the last round's ``changed``). HITS
#: stops at a residual threshold midway, in log scale, between the
#: reference's residuals after rounds 30 and 31. The centralities sample
#: sources ``125_000 i + 1``; their checks read the sum, the max and 16
#: nodes ``62_500 j + 7``. Borůvka and Vivaldi run on the routing rung's
#: latency made symmetric (the cost of the sorted endpoint pair:
#: Borůvka's minimality needs ``w(u, v) = w(v, u)``); Vivaldi's check is
#: the median relative error of its predicted latency over the first
#: 65,536 live edges after 30 rounds. The detector and anti-entropy follow
#: ``examples/membership_demo.py`` (keys 1 and 2, ``max_rounds=4096``)
#: with phase 4c's nodes 5,000-14,999 unresponsive or failed.
#: Regenerate (~2 min):
#:   JAX_PLATFORMS=cpu python - <<'EOF'
#:   import hashlib, jax, numpy as np
#:   from p2pnetwork_tpu.sim import graph as G, engine as E, failures as F
#:   from p2pnetwork_tpu import models as M
#:   from p2pnetwork_tpu.models import centrality as C, triangles as TR
#:   k, h = jax.random.key(0), lambda a: hashlib.sha256(np.asarray(a).tobytes()).hexdigest()
#:   def lat(s, r): return 1.0 + ((s.astype(np.uint32) * np.uint32(2654435761) + r.astype(np.uint32)) % 2048).astype(np.float32) / 1024.0
#:   sym = lambda s, r: lat(np.minimum(s, r), np.maximum(s, r))
#:   conv = lambda g, p, stat, thr=1, mr=256, key=k: E.run_until_converged(g, p, key, stat=stat, threshold=thr, max_rounds=mr)
#:   g = G.watts_strogatz(1_000_000, 10, 0.1, seed=0, source_csr=True)
#:   s, o = conv(g, M.Bracha(f=1, byzantine=(1, 2), method="segment"), "changed"); print(o, h(s.value), h(s.echo_sent), h(s.ready_sent))
#:   r = np.asarray(E.run(g, M.HITS(method="segment"), k, 31)[1]["residual"], np.float64); thr = float(np.sqrt(r[29] * r[30]))
#:   s, o = conv(g, M.HITS(method="segment"), "residual", thr); ids = np.arange(16) * 62_500 + 7
#:   print(thr, o, np.asarray(s.hub, np.float64).sum(), np.asarray(s.hub).max(), np.asarray(s.hub)[ids].tolist(), np.asarray(s.authority, np.float64).sum(), np.asarray(s.authority)[ids].tolist())
#:   srcs = np.arange(8, dtype=np.int32) * 125_000 + 1
#:   for x in (C.closeness_sample(g, srcs, "segment"), C.betweenness_sample(g, srcs, "segment")):
#:       x = np.asarray(x); print(x.astype(np.float64).sum(), x.max(), x[ids].tolist())
#:   s, o = conv(g, M.LabelPropagation(), "unsettled", mr=1024); print(o, h(s.label))
#:   p = M.BipartiteCheck(method="gather"); s, o = conv(g, p, "changed"); print(o, h(s.label), h(s.dist), int(p.odd_edges(g, s)), h(p.component_bipartite(g, s)))
#:   print(TR.count_triangles(g), TR.transitivity_sample(g, k, 65536))
#:   gw = g.with_weights(sym); s, o = conv(gw, M.Boruvka(), "changed", mr=64); print(o, h(s.comp), h(s.mst_edge), float(s.mst_weight))
#:   p = M.Vivaldi(dim=2); s, st = E.run(gw, p, k, 30); em = np.asarray(g.edge_mask)
#:   a, b, w = (np.asarray(x)[em][:65536] for x in (g.senders, g.receivers, gw.edge_weight))
#:   print(np.asarray(st["messages"]).tolist(), float(np.median(np.abs(np.asarray(p.predicted(s, a, b)) - w) / w)))
#:   dead = np.arange(5_000, 15_000)
#:   s, o = conv(F.mark_unresponsive(g, dead), M.FailureDetector(threshold=3, loss_prob=0.05), "undetected", mr=4096, key=jax.random.key(1)); print(o, h(s.declared), h(s.suspicion))
#:   s, o = conv(F.fail_nodes(g, dead), M.AntiEntropy(n_items=64), "missing", mr=4096, key=jax.random.key(2)); print(o, h(s.have))
#:   EOF
LIB_SOURCES = np.arange(8, dtype=np.int32) * 125_000 + 1
LIB_SAMPLE = np.arange(16) * 62_500 + 7
BRACHA = {"f": 1, "byzantine": (1, 2)}
HITS_THRESHOLD = 0.47715775356211615
VIVALDI_ROUNDS = 30
#: Live edges whose predicted latency Vivaldi's check reads.
VIVALDI_EDGES = 65536
DEAD = range(5_000, 15_000)
EXPECTED_LIBRARY = {
    "bracha": {"rounds": 256, "messages": 24676, "value": 14.0,
               "value_sha256": ("4efc1773f11f2359204bfe0a0711b540"
                                "d675f4d22a2743329cee8856e890e7fc"),
               "echo_sha256": ("54a43a5eec2521c6d18638c69dd43770"
                               "ddc0d120e4bd968ab0887b6959c5b586"),
               "ready_sha256": ("5a88fff817177cd8ccb5b1f3e17dbd6f"
                                "77321c52da08adfa9a2be2baf7f453a2")},
    "hits": {"rounds": 31, "messages": 619999628},
    "labelprop": {"rounds": 23, "messages": 229999862, "value": 0.0,
                  "sha256": ("2baa7d3229ad86efb6500e0f0f49f520"
                             "e9c0162b23113fca4120a4651578287d")},
    "bipartite": {"rounds": 13, "messages": 105825236, "value": 0.0,
                  "label_sha256": _ALL_999999,
                  "dist_sha256": ("cfbc3c6ca60d7a24f3cd5ec55d2fa8d9"
                                  "b717dfdeba773eb9bf58fdeeb89d6003"),
                  "odd_edges": 5085358,
                  "component_sha256": ("900740ec474a754ebed1c6220612bf1e"
                                       "b0dff672575edbf9f965d80741322593")},
    "triangles": {"triangles": 7289240,
                  "transitivity_sample": 0.47991943359375},
    "boruvka": {"rounds": 9, "messages": 29831824, "value": 0.0,
                "mst_edges": 999999,
                "comp_sha256": ("129256ee3ec90174b1ffc2f481b0ff34"
                                "e820de704487d52322c0cb1d8d772637"),
                "mst_edge_sha256": ("09d0284aa57a06d3fc0c4155cc83f5a1"
                                    "e2732f8127b95248cad8cb3bd05b932a")},
    "vivaldi_messages": [1_000_000] * VIVALDI_ROUNDS,
    "detector": {"rounds": 177, "messages": 341540121, "value": 0.0,
                 "declared_sha256": ("b3c52a4ba017bd09e54db2bb33152999"
                                     "088cea6ef045bbc12bea03cba8d192aa"),
                 "suspicion_sha256": ("01d8a018a3460ebf474b95cd8a4228ea"
                                      "8b084fdc6d3bc23a19c2b758a0d1f9a3")},
    "antientropy": {"rounds": 33, "messages": 65340000, "value": 0.0,
                    "have_sha256": ("f844119ca2a02a3606a8395b1f283df2"
                                    "91feed4fea405c64d23af597d14ca094")}}
#: The float results, each with its (rtol, atol) and the reference's
#: values. HITS: scores near 1e-3 after 31 f32 power steps whose sums
#: add in another order; closeness adds the same terms in the same order
#: as the reference (its bits are expected equal); betweenness: f32 sums
#: of path-count ratios; Borůvka's weight: an f32 sum of 999,999
#: committed weights; Vivaldi: the median over 65,536 edges of a state
#: iterated 30 rounds from normal draws within 3 ulp of jax's.
EXPECTED_LIBRARY_FLOATS = {
    "hits": ((1e-4, 1e-8), {
        "hub_sum": 977.3579617162759, "hub_max": 0.0028476035222411156,
        "authority_sum": 977.3771591353288,
        "hub_sample": [
            0.0011057478841394186, 0.000860877800732851,
            0.0012578595196828246, 0.0008134879171848297,
            0.0008973577641882002, 0.0008778611663728952,
            0.0007524826214648783, 0.0006757494411431253,
            0.0008168506319634616, 0.0005914267967455089,
            0.0012579361209645867, 0.0008122157887555659,
            0.0005513183423317969, 0.00098920869641006,
            0.0012128808302804828, 0.0007962094969116151],
        "authority_sample": [
            0.0011057411320507526, 0.0008609223878011107,
            0.0012579933973029256, 0.0008136109099723399,
            0.0008975202799774706, 0.0008778548217378557,
            0.0007525185937993228, 0.0006758029921911657,
            0.0008169093634933233, 0.0005914429202675819,
            0.0012580124894157052, 0.0008122373837977648,
            0.0005513849901035428, 0.0009894507238641381,
            0.0012128792004659772, 0.0007962441886775196]}),
    "closeness": ((1e-6, 0.0), {
        "sum": 853615.7341533899, "max": 1.8138889074325562,
        "sample": [
            1.2381314039230347, 0.9135642051696777, 1.2873016595840454,
            0.8055556416511536, 1.1949496269226074, 0.8333333730697632,
            1.2333333492279053, 0.8242424130439758, 1.258333444595337,
            0.838131308555603, 1.2242425680160522, 0.8928571939468384,
            1.2242424488067627, 0.8805555701255798, 1.2555556297302246,
            0.878210723400116]}),
    "betweenness": ((1e-5, 1e-6), {
        "sum": 67993915.23050727, "max": 254300.640625,
        "sample": [
            350.6018981933594, 52.11689376831055, 67069.75,
            2.373340606689453, 32084.646484375, 7.1289777755737305,
            1116.7283935546875, 0.5469104051589966, 2536.771240234375,
            1.503929853439331, 4243.4482421875, 79.14372253417969,
            1234.9468994140625, 30.711227416992188, 282.8295593261719,
            36.5506591796875]}),
    "boruvka": ((1e-6, 0.0), {"mst_weight": 1217238.0}),
    "vivaldi": ((1e-3, 0.0), {"median_rel_err": 0.16674786806106567}),
}

#: Phase 4o: the reordered builds of phase 4j's 100K WS class (with the
#: source-CSR view and the hybrid layout), by ``graph_digest`` over every
#: field, the relabeling included; both packages build the same bytes.
#: Regenerate (~10 s):
#:   JAX_PLATFORMS=cpu python -c "import chip_smoke as c; from p2pnetwork_tpu.sim import graph as G; print([c.graph_digest(G.watts_strogatz(100_000, 10, 0.1, seed=0, reorder=s, source_csr=True, hybrid=True)) for s in ('rcm', 'degree')])"
EXPECTED_REORDER = {
    "rcm": ("e0557df75fb90801a8261abdb3733622"
            "d998a6211ff8703b70fb29e21e1db42e"),
    "degree": ("26c59d0fab9000f8cc2c9b5dd37ba256"
               "1e8e46fc73687d103c77d83b91f56f3a")}

#: Phase 4q: bench.py's serving column (``bench_serving`` at its defaults:
#: capacity and queue depth 1,024, 4 rounds a tick, 16 ticks of
#: ``SERVE_PATTERN`` drawn by ``generate(..., seed=0)``) on phase 4j's 100K
#: WS class, by the JAX package's ``SimService`` on the CPU with
#: ``record_seen_hash=True``. ``tickets_sha256`` is the sha256 of the
#: canonical JSON (sorted keys, no spaces) of every harvested ticket's
#: ``SERVE_FIELDS``, ``seen_sha256`` of its ``seen_sha256`` by ticket,
#: ``shed_sha256`` of the shed list, ``retained_sha256`` of the service's
#: retained table (``done_retention`` 4,096) with the seen hashes; the
#: percentiles are ``stats()``'s (its rolling window). Regenerate (~30 s):
#:   JAX_PLATFORMS=cpu python - <<'EOF'
#:   import chip_smoke as c
#:   from p2pnetwork_tpu.sim import graph as G
#:   from p2pnetwork_tpu.serve import SimService, TrafficPattern, drive, generate
#:   g = G.watts_strogatz(100_000, 10, 0.1, seed=0, source_csr=True)
#:   svc = SimService(g, capacity=1024, queue_depth=1024, chunk_rounds=4, seed=0, record_seen_hash=True)
#:   out = drive(svc, generate(TrafficPattern(**c.SERVE_PATTERN), g.n_nodes, seed=0))
#:   print(c.serve_summary(out, svc.stats()), c.canon_sha(c.serve_table(svc.tickets(), ("seen_sha256",))))
#:   EOF
SERVE_PATTERN = dict(ticks=16, rate=1024 / 3.0, hot_fraction=0.5,
                     hot_keys=32, diurnal_amplitude=0.3, diurnal_period=8.0,
                     burst_prob=0.125, burst_mult=3.0, coverage_target=0.99)
SERVE_FIELDS = ("status", "source", "lane", "rounds", "latency_rounds",
                "submitted_round", "admitted_round", "seen_count")
#: The tick at which 4q's stored drive is preempted.
SERVE_PREEMPT_TICK = 8
EXPECTED_SERVE = {
    "submitted": 6144, "completed": 6144, "shed": 758, "drain_ticks": 4,
    "executed_rounds": 78, "peak_concurrent_lanes": 1024,
    "completion_rounds_p50": 17.0, "completion_rounds_p99": 18.0,
    "tickets_sha256": ("d5c9d85730c43960f6751f28a366e185"
                       "02c9f075eb3d840d7426c6e505a0a6d6"),
    "shed_sha256": ("50a766e8219595fa15ad47490ea844a7"
                    "48d22b9d2501081b29b800f1498c0131")}
EXPECTED_SERVE_RETAINED = ("57bf9fb007dd1640d7274c062f614ad3"
                           "1ca3e133b8883f20488c32ca8274ffa8")
#: Phase 4q's supervised flood: phase 4's hybrid flood in 4-round chunks,
#: preempted at round 8 (its round-4 checkpoint is the last durable one)
#: and resumed; rounds, coverage and messages are ``EXPECTED_1M``'s.
SUPERVISE_CHUNK, SUPERVISE_PREEMPT = 4, 8
#: 4q's supervised and unsupervised floods timed in turns, and the
#: unsupervised flood's back-to-back runs before them.
SUPERVISE_PAIRS, SUPERVISE_ALONE = 9, 5
#: The journal calls whose host seconds 4q's stored drive adds up.
JOURNAL_CALLS = ("append", "tick_barrier", "rotate", "compact")
#: Tickets of 4q's background driver (sources every n // this nodes).
SERVE_BACKGROUND = 100

#: Phase 4r (slice 10): the self-healing and chaos plane. Every healed run
#: takes this retry policy and the healed drives these one-shot dispatch
#: faults (the reference's 100k soak's own, tests/test_graftchurn.py).
HEAL_POLICY = dict(max_attempts=4, backoff_base_s=0.0)
SERVE_FAULTS = dict(preempt_at=(1,), wedge_at=(3,))
#: 4r(a): 4q's drive without and with ``heal=`` (no fault), in turns.
HEAL_PAIRS = 5
#: 4r(b): the healed, faulted drive with ``slo=SLOEngine(serve_objectives(
#: slo_rounds=SLO_ROUNDS))``, the other objectives at their defaults (24
#: is the reference's own test value). 4q's drive completes at p99 18
#: rounds, so the admission objective holds and the drive is
#: ``EXPECTED_SERVE``'s, while the shed-rate objective (758 of 6,902
#: arrivals shed, over its 5% budget) fires and resolves; the admission
#: path is held to the reference on the CPU (tests/test_torch_slo.py).
#: The reference's numbers (``serve_summary``,
#: the final admit budget, the alerts as (objective, transition, tick));
#: regenerate (~30 s):
#:   JAX_PLATFORMS=cpu python - <<'EOF'
#:   import chip_smoke as c
#:   from p2pnetwork_tpu import telemetry as T
#:   from p2pnetwork_tpu.sim import graph as G
#:   from p2pnetwork_tpu.serve import SimService, TrafficPattern, drive, generate
#:   from p2pnetwork_tpu.supervise.heal import RetryPolicy
#:   from p2pnetwork_tpu.telemetry.slo import SLOEngine, serve_objectives
#:   from p2pnetwork_tpu.chaos.device import DispatchChaos, install_dispatch_chaos
#:   g = G.watts_strogatz(100_000, 10, 0.1, seed=0, source_csr=True)
#:   reg = T.Registry()
#:   slo = SLOEngine(serve_objectives(slo_rounds=c.SLO_ROUNDS), registry=reg)
#:   install_dispatch_chaos(DispatchChaos(registry=reg, **c.SERVE_FAULTS))
#:   svc = SimService(g, capacity=1024, queue_depth=1024, chunk_rounds=4, seed=0, heal=RetryPolicy(**c.HEAL_POLICY), slo=slo, registry=reg)
#:   out = drive(svc, generate(TrafficPattern(**c.SERVE_PATTERN), g.n_nodes, seed=0))
#:   print(c.slo_summary(out, svc, slo))
#:   EOF
SLO_ROUNDS = 24
EXPECTED_SERVE_SLO = dict(
    EXPECTED_SERVE, admit_budget=1024,
    alerts=[["shed_rate", "fire", 9], ["shed_rate", "resolve", 12],
            ["shed_rate", "fire", 15]])
#: 4r(c): the reference's acceptance soak (tests/test_graftchurn.py
#: ``TestChurnSoak``) as it stands: ``watts_strogatz(100_000, 6, 0.1,
#: seed=0)`` grown to 1 << 17 slots, this storm (seed 11) and traffic
#: (seed 13), capacity 32, chunk 4, seed 1, seen hashes on, healed. The
#: reference's drive (``soak_summary``; ``tickets_sha256`` over every
#: record, seen hashes included); regenerate (~20 s):
#:   JAX_PLATFORMS=cpu python - <<'EOF'
#:   import chip_smoke as c
#:   from p2pnetwork_tpu import telemetry as T
#:   from p2pnetwork_tpu.sim import graph as G
#:   from p2pnetwork_tpu.serve import SimService, TrafficPattern, generate
#:   from p2pnetwork_tpu.chaos import storm as S
#:   from p2pnetwork_tpu.supervise.heal import RetryPolicy
#:   g = G.grow(G.watts_strogatz(100_000, 6, 0.1, seed=0), 0, node_capacity=1 << 17)
#:   churn = S.generate(S.ChurnPattern(**c.SOAK_STORM), g.n_nodes, seed=11)
#:   tr = generate(TrafficPattern(**c.SOAK_TRAFFIC), g.n_nodes, seed=13)
#:   svc = SimService(g, capacity=32, chunk_rounds=4, seed=1, record_seen_hash=True, heal=RetryPolicy(**c.HEAL_POLICY), registry=T.Registry())
#:   print(c.soak_summary(S.drive(svc, churn, traffic=tr)))
#:   EOF
SOAK_STORM = dict(ticks=10, join_prob=0.5, join_batch=8, fanout=3,
                  leave_prob=0.3, grow_prob=0.2, grow_batch=16)
SOAK_TRAFFIC = dict(ticks=10, rate=2.0, hot_fraction=0.5, hot_keys=4,
                    coverage_target=0.95)
EXPECTED_SOAK = {
    "submitted": 22, "completed": 22, "drain_ticks": 3,
    "executed_rounds": 46, "peak_concurrent_lanes": 12,
    "events": {"grow": 3, "join": 7, "leave": 5}, "graph_nodes": 100104,
    "graph_capacity": 131072, "replayed": 0, "shed": 0,
    "tickets_sha256": ("9c8075cfb2630c44487cacf5bcb35c85"
                       "ff63c62004e6d22d3d8b974c8b7934af")}
#: 4r(e): the reference's faulted-flood schedule
#: (tests/test_graftquake.py ``test_cross_backend_faulted_parity``) on the
#: 1M ring, S = 8. The reference's dict, the sha256 of its final ``seen``
#: (``[8, 125008]`` bool) and its fault counts; the sites do not depend
#: on the layout, so its ``segment`` ring on ``ppermute`` (which it pins
#: bit-identical to its Pallas hop) gives them. Regenerate (~10 s):
#:   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 python - <<'EOF'
#:   import hashlib, numpy as np, chip_smoke as c
#:   from p2pnetwork_tpu import telemetry as T
#:   from p2pnetwork_tpu.sim import graph as G
#:   from p2pnetwork_tpu.parallel import mesh, sharded
#:   from p2pnetwork_tpu.chaos.device import FaultSchedule, FaultSpec
#:   m = mesh.ring_mesh(8)
#:   sg = sharded.shard_graph(G.watts_strogatz(1_000_000, 10, 0.1, seed=0), m)
#:   seen, out = sharded.flood_until_coverage(sg, m, 0, coverage_target=0.99, max_rounds=64, comm=FaultSpec(FaultSchedule(**c.RING_FAULTS), "ppermute"))
#:   print(out, hashlib.sha256(np.asarray(seen).tobytes()).hexdigest(), {k: T.default_registry().value("chaos_device_faults_total", kind=k) for k in ("corrupt", "zero", "delay")})
#:   EOF
RING_FAULTS = dict(seed=5, corrupt=0.05, zero=0.1, delay=0.1)
EXPECTED_RING_FAULTED = {
    "rounds": 7, "coverage": 0.9998120069503784, "messages": 9699142,
    "frontier_occupancy_mean": 0.14283014833927155,
    "seen_sha256": ("9294d3b7fac5cf3b9e3ddf761105118f"
                    "4782eec43d9dc22f112bacbdd7ea7933"),
    "faults": {"corrupt": 19, "zero": 32, "delay": 42}}
#: 4r(e)'s faulted and bare floods, timed in turns.
RING_FAULT_REPS = 3
#: 4r(f): the reference's crash-storm acceptance campaign
#: (tests/test_graftdur.py ``TestCrashStormAcceptance``), its children on
#: the card.
CAMPAIGN_KILLS = dict(n_kills=5, seed=3, ticks=24)
CAMPAIGN_CONFIG = {"n_nodes": 100_000, "capacity": 64, "rate": 8.0,
                   "chunk_rounds": 8, "checkpoint_every_ticks": 4}

#: 4s: the user bridge (slice 11). ``TorchSimNode`` on phase 4's graph,
#: driven through the Node API by :func:`simnode_sequence`: a real socket
#: on 127.0.0.1, a plain ``Node`` peer and ``SIMNODE_PINGS`` dict round
#: trips, then ``run_rounds(SIMNODE_ROUNDS)``, ``fail_sim_nodes`` of
#: ``SIMNODE_DEAD``, ``inject_sim_churn(SIMNODE_CHURN)``,
#: ``connect_sim_nodes(*SIMNODE_PAIRS)``, ``save_checkpoint`` and
#: ``run_until_coverage(SIMNODE_TARGET)``; a fresh node loads the file and
#: runs to the target (:func:`simnode_resume`). The single-device node
#: floods ``hybrid`` with ``SIMNODE_DYN`` runtime-link slots on the graph,
#: the ring nodes flood the 8-shard ring (``mxu``, ``hybrid``, then
#: ``segment``) with ``dynamic_edges=SIMNODE_DYN``.
SIMNODE_SEED = 11
SIMNODE_DYN = 64
SIMNODE_ROUNDS = 3
SIMNODE_DEAD = (5_000, 15_000)
SIMNODE_CHURN = 0.01
SIMNODE_PAIRS = (
    [int(v) for v in (np.arange(32) * 30_011 + 20_000) % N_NODES],
    [int(v) for v in (np.arange(32) * 17_389 + 500_000) % N_NODES])
SIMNODE_PINGS = 20
SIMNODE_TARGET = 0.99
SIMNODE_HOST = "127.0.0.1"
SIMNODE_RING_LAYOUTS = ("mxu", "hybrid", "segment")
#: 4s(c): the ChaosPlane's seed and the peers' reconnect cadence.
SIMNODE_CHAOS_SEED = 5
SIMNODE_FAST = dict(reconnect_interval=0.05, reconnect_backoff_base=0.1,
                    reconnect_backoff_max=0.5)
#: The reference's records of 4s: ``JaxSimNode`` with the JAX package's
#: ``Node`` through the same :func:`simnode_sequence` and
#: :func:`simnode_resume` (event-list digests, summaries, final ``seen``
#: digests, checkpoint payload digests). Regenerate on the CPU (~6 min,
#: most of it the ``mxu`` ring's one-hot sums in the Pallas interpreter;
#: the single-device flood runs ``segment``, whose events are every
#: method's):
#:   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 python - <<'EOF'
#:   import tempfile, chip_smoke as c
#:   from p2pnetwork_tpu import node as N
#:   from p2pnetwork_tpu.models import Flood
#:   from p2pnetwork_tpu.parallel import mesh
#:   from p2pnetwork_tpu.sim import graph as G, topology as T
#:   from p2pnetwork_tpu.sim.simnode import JaxSimNode
#:   g = G.watts_strogatz(1_000_000, 10, 0.1, seed=0, blocked=True, hybrid=True, source_csr=True)
#:   d, p, m = tempfile.mkdtemp(), Flood(source=0, method="segment"), mesh.ring_mesh(8)
#:   runs = [("single", T.with_capacity(g, extra_edges=c.SIMNODE_DYN), None, {})]
#:   runs += [(lay, g, m, dict(layout=lay, dynamic_edges=c.SIMNODE_DYN)) for lay in c.SIMNODE_RING_LAYOUTS]
#:   for name, gr, mm, kw in runs:
#:       rec, _, (node, peer, _, _) = c.simnode_sequence(JaxSimNode, N.Node, gr, p, f"{d}/{name}.npz", mesh=mm, **kw)
#:       node.stop(); peer.stop(); node.join(); peer.join()
#:       res, _ = c.simnode_resume(JaxSimNode, gr, p, f"{d}/{name}.npz", mesh=mm, **kw)
#:       print(name, {**rec, "resumed_events_sha256": res["events_sha256"]})
#:   EOF
_SIMNODE_SUMMARY = {"rounds": 8, "coverage": 0.9995561242103577,
                    "messages": 8980949,
                    "frontier_occupancy_mean": 0.12491735070943832}
_SIMNODE_COMMON = {
    "n_events": 28, "summary": _SIMNODE_SUMMARY, "alive_nodes": 980043,
    "seen_sha256": ("7be25c53ad6729147d2e07b22fbd3e15"
                    "50a88fc1d0cb7214142c1655a4118d60"),
    "sim_round": 11, "sim_messages": 8981459,
    "peer_events_sha256": ("8e94e1a1484254b5d0cdbf7866567ee0"
                           "a84534ad30683aaef948fcd3529fad34"),
    "resumed_events_sha256": ("b139b605ae986f43f851fcc2d58b3065"
                              "acd517c2be80a8f0a591b95bce46150b")}
EXPECTED_SIMNODE = {
    **_SIMNODE_COMMON,
    "events_sha256": ("225a387fb6cc840103f1563e6e74af1a"
                      "95fdf2520316a83f41fdd335f853e028"),
    "payload_sha256": ("0e1c9242cc13fe88a5a762b745024c59"
                       "e7473a8cd14368c6bd18354ca5d9bceb")}
#: The ring nodes' events carry the ring's round stats (messages and
#: coverage), so their digest is not the single-device node's; the two
#: layouts differ only in the checkpoint's masks.
_RING_EVENTS = ("af5d82615ce2bc6f631d75cb89bc7377"
                "8c96fde23feb741304babcfa8d653951")
EXPECTED_SIMNODE_RING = {
    "mxu": {**_SIMNODE_COMMON, "events_sha256": _RING_EVENTS,
            "payload_sha256": ("2dc87b7927b31ae0f21ad60c0ea2727c"
                               "cee9e4377e6635aa37da099045b1b970")},
    "hybrid": {**_SIMNODE_COMMON, "events_sha256": _RING_EVENTS,
               "payload_sha256": ("e7e496e83663402361f1803c71862edc"
                                  "fb76ea9084b8ed40169b56fb51bbe85e")},
    "segment": {**_SIMNODE_COMMON, "events_sha256": _RING_EVENTS,
                "payload_sha256": ("17fccaf4dc3212102f4c55a5820ae130"
                                   "980c4e978650bce067a1b9f0d4ea3e37")}}


#: 4t: the ring's other protocols (slice 12) on phase 4's graph, 8 shards
#: on the card, in each of ``RING_LAYOUTS``: SIR (4e's rung) with
#: ``exact_rng=True`` (then the single device's run, ``EXPECTED_SIR``),
#: with the default draws (``"fold"``: the block, 125,008, is not a
#: multiple of 128) and to ``RING_SIR_TARGET``; PageRank
#: (``RING_PR_ROUNDS``, then to the residual ``RING_PR_TOL``) and push-sum
#: (``RING_PS_ROUNDS``, then to the variance ``RING_PS_TOL``) under
#: ``RING_CONSENSUS_LAYOUTS``; hop distance to the end and leader election
#: to quiescence under ``segment`` (``EXPECTED_ANALYTICS``: the ring's
#: integer results are the single device's). Then the ladder's sharded
#: gossip rung (``benchmarks/ladder.py`` ``bench_gossip_sharded``) and
#: ``TorchSimNode`` on the ``mxu`` ring: ``examples/mesh_simnode_demo.py``'s
#: story at phase 4's width (``MESH_DEMO``) and a PageRank node.
RING_SIR_TARGET = 0.5
RING_PR_ROUNDS = 21
RING_PS_ROUNDS = 30
RING_CONSENSUS_LAYOUTS = ("hybrid", "mxu")
RING_GOSSIP_GRAPH = dict(n=100_000, m=4, seed=0, max_degree=128)
RING_WALK_ROUNDS = 64
MESH_DEMO = {"seed": 1, "sir": dict(beta=0.3, gamma=0.1, source=0),
             "dyn": 16, "rounds": (8, 4), "churn": 0.1,
             "links": ([4, 9], [15_000, 18_000]), "target": 0.6,
             "max_rounds": 128}
#: The reference's records of 4t: the JAX package's ring on the 8-device
#: virtual CPU mesh, ``segment`` buckets (SIR's draws and sums of 0/1
#: terms give every layout's bits; PageRank's and push-sum's f32 sums add
#: in each layout's order, so the port's ``mxu`` and ``hybrid`` runs are
#: held to ``RING_TOL``), the same :func:`ring_runs`,
#: :func:`ring_gossip_run`, :func:`mesh_demo` and :func:`mesh_pagerank` on
#: its classes. ``RING_PR_TOL`` and ``RING_PS_TOL`` are midway, in log
#: scale, between the reference's residuals of rounds 16 and 17 and its
#: variances of rounds 20 and 21, so the tolerance cannot move a stopping
#: round. Regenerate on the CPU (~65 s):
#:   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 python - <<'EOF'
#:   import tempfile, numpy as np, jax, chip_smoke as c
#:   from p2pnetwork_tpu import models as M
#:   from p2pnetwork_tpu.parallel import mesh, sharded as S
#:   from p2pnetwork_tpu.sim import graph as G
#:   from p2pnetwork_tpu.sim.simnode import JaxSimNode
#:   k, m = jax.random.key(0), mesh.ring_mesh(8)
#:   g = G.watts_strogatz(1_000_000, 10, 0.1, seed=0)
#:   sg, out = S.shard_graph(g, m), {}
#:   for name in ("sir_fold", "sir_coverage", "pagerank", "pushsum"):
#:       run, rec = c.ring_runs(S, M, sg, m, k, "hybrid")[name]; out[name] = rec(run())
#:   r, v = (np.asarray(out[n][s], np.float64) for n, s in (("pagerank", "residual"), ("pushsum", "variance")))
#:   c.RING_PR_TOL, c.RING_PS_TOL = float(np.sqrt(r[15] * r[16])), float(np.sqrt(v[19] * v[20]))
#:   for name in ("pagerank_until", "pushsum_until"):
#:       run, rec = c.ring_runs(S, M, sg, m, k, "hybrid")[name]; out[name] = rec(run())
#:   gba = G.barabasi_albert(**c.RING_GOSSIP_GRAPH)
#:   run, rec = c.ring_gossip_run(S, M.Gossip, S.shard_graph(gba, m), m, k)
#:   out["gossip"] = rec(run())
#:   out["mesh_demo"] = c.mesh_demo(JaxSimNode, g, M.SIR, m, tempfile.mkdtemp() + "/d.npz", layout="segment")[0]
#:   out["mesh_pagerank"] = c.mesh_pagerank(JaxSimNode, g, M.PageRank, m, layout="segment")
#:   print(c.RING_PR_TOL, c.RING_PS_TOL, out)
#:   EOF
RING_PR_TOL = 1.7984312582749665e-05
RING_PS_TOL = 0.0013301095341140222
EXPECTED_RING = {
    "sir_fold": {
        "coverage": [
            6.000000212225132e-06, 1.5999999959603883e-05,
            3.400000059627928e-05, 7.200000254670158e-05,
            0.00019099999917671084, 0.00041199999395757914,
            0.0008370000286959112, 0.0017190000507980585, 0.003656999906525016,
            0.007734999991953373, 0.016001999378204346, 0.03308799862861633,
            0.06799600273370743, 0.13646499812602997, 0.26202699542045593,
            0.4607450067996979, 0.7040780186653137, 0.8970159888267517,
            0.9804139733314514, 0.9978700280189514, 0.9998559951782227,
            0.9999949932098389, 0.9999979734420776, 1.0, 1.0, 1.0, 1.0, 1.0,
            1.0, 1.0],
        "i_frac": [
            6.000000212225132e-06, 1.5999999959603883e-05,
            3.300000025774352e-05, 6.900000153109431e-05,
            0.0001829999964684248, 0.00039900001138448715,
            0.0008019999950192869, 0.0016459999606013298,
            0.0035000001080334187, 0.007402999792248011, 0.015302999876439571,
            0.031617000699043274, 0.06499399989843369, 0.13018499314785004,
            0.24918299913406372, 0.4353339970111847, 0.6568949818611145,
            0.8169649839401245, 0.8596190214157104, 0.833670973777771,
            0.7939550280570984, 0.754593014717102, 0.7167530059814453,
            0.6809369921684265, 0.6466479897499084, 0.6142299771308899,
            0.5835999846458435, 0.554623007774353, 0.5268980264663696,
            0.500698983669281],
        "messages": [
            11, 61, 165, 344, 716, 1865, 4045, 8112, 16617, 35286, 74617,
            154501, 319415, 656503, 1314025, 2513368, 4383880, 6598780,
            8184003, 8595288, 8331209, 7933595, 7539914, 7161612, 6803666,
            6461106, 6137294, 5830963, 5541495, 5264392],
        "r_frac": [
            0.0, 0.0, 9.999999974752427e-07, 3.000000106112566e-06,
            7.999999979801942e-06, 1.2999999853491317e-05,
            3.5000000934815034e-05, 7.300000288523734e-05,
            0.00015700000221841037, 0.0003319999959785491,
            0.0006990000256337225, 0.001471000025048852, 0.003002000041306019,
            0.006279999855905771, 0.01284400001168251, 0.025411000475287437,
            0.047182999551296234, 0.0800509974360466, 0.12079499661922455,
            0.16419899463653564, 0.20590099692344666, 0.245401993393898,
            0.2832449972629547, 0.3190630078315735, 0.35335201025009155,
            0.3857699930667877, 0.4163999855518341, 0.445376992225647,
            0.47310200333595276, 0.4993009865283966],
        "s_frac": [
            0.9999939799308777, 0.9999840259552002, 0.999966025352478,
            0.9999279975891113, 0.9998090267181396, 0.9995880126953125,
            0.9991629719734192, 0.9982810020446777, 0.9963430166244507,
            0.992264986038208, 0.9839980006217957, 0.9669119715690613,
            0.9320039749145508, 0.8635349869728088, 0.7379729747772217,
            0.5392550230026245, 0.29592201113700867, 0.1029840037226677,
            0.019586000591516495, 0.0021299999207258224,
            0.00014400000509340316, 4.999999873689376e-06,
            1.9999999949504854e-06, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        "status_sha256": ("9058d9c8ed4f80443093c5bb81c871d3"
                          "0a240348716fea302022e4b78188cc6b")},
    "sir_coverage": {
        "rounds": 17,
        "coverage": 0.5880200266838074,
        "messages": 7129503,
        "status_sha256": ("15d4da606089b5f5ddb692c3c450917c"
                          "8a0978bf73f2daa235f6ec60c659625e")},
    "pagerank": {
        "messages": [
            9999994, 9999994, 9999994, 9999994, 9999994, 9999994, 9999994,
            9999994, 9999994, 9999994, 9999994, 9999994, 9999994, 9999994,
            9999994, 9999994, 9999994, 9999994, 9999994, 9999994, 9999994],
        "rank_max": [
            1.5765403986733872e-06, 1.5480181900784373e-06,
            1.5855230230954476e-06, 1.5817565781617304e-06,
            1.5859216091484996e-06, 1.58566660957149e-06,
            1.586197868164163e-06, 1.5861700148889213e-06,
            1.5862091231610975e-06, 1.5861736528677284e-06,
            1.586146822774026e-06, 1.5861143083384377e-06,
            1.5860878193052486e-06, 1.5860649682508665e-06,
            1.5860471194173442e-06, 1.5860325675021159e-06,
            1.5860213125051814e-06, 1.5860126723055146e-06,
            1.5860061921557644e-06, 1.5860013036217424e-06,
            1.5859975519560976e-06],
        "rank_total": [
            1.000000238418579, 1.0000001192092896, 1.0, 1.0000001192092896,
            1.0000001192092896, 1.0000001192092896, 1.0000001192092896,
            1.0000001192092896, 1.0000001192092896, 1.0000001192092896,
            1.000000238418579, 1.000000238418579, 1.0000001192092896,
            1.0000001192092896, 1.000000238418579, 1.0000001192092896,
            1.0000001192092896, 1.000000238418579, 1.0000001192092896,
            1.0000001192092896, 1.000000238418579],
        "residual": [
            0.06651322543621063, 0.014935850165784359, 0.004464610945433378,
            0.0017085449071601033, 0.0008201882592402399,
            0.0004874782171100378, 0.0003242874226998538,
            0.00022633076878264546, 0.000162176598678343,
            0.00011791347787948325, 8.670488750794902e-05,
            6.428981578210369e-05, 4.800388705916703e-05,
            3.604989615269005e-05, 2.7206962840864435e-05,
            2.0619918359443545e-05, 1.568558582221158e-05,
            1.197051187773468e-05, 9.161031812254805e-06,
            7.028780146356439e-06, 5.405140200309688e-06]},
    "pagerank_until": {"rounds": 17, "messages": 169999898, "value": 1.568558582221158e-05},
    "pushsum": {
        "mean": [
            0.00013331585796549916, 0.0001522625534562394,
            0.0001533810718683526, 0.00015482629532925785,
            0.00015564245404675603, 0.0001560906966915354,
            0.00015642817015759647, 0.00015669084677938372,
            0.00015693155000917614, 0.00015715695917606354,
            0.00015737215289846063, 0.00015757422079332173,
            0.00015776118380017579, 0.000157930378918536,
            0.00015808013267815113, 0.0001582101540407166,
            0.00015832063218113035, 0.00015841179993003607,
            0.00015848503971938044, 0.00015854198136366904,
            0.00015858380356803536, 0.00015861215069890022,
            0.00015862863801885396, 0.00015863479347899556,
            0.00015863210137467831, 0.00015862179861869663,
            0.0001586051075719297, 0.0001585831050761044,
            0.00015855676610954106, 0.00015852694923523813],
        "messages": [
            9999994, 9999994, 9999994, 9999994, 9999994, 9999994, 9999994,
            9999994, 9999994, 9999994, 9999994, 9999994, 9999994, 9999994,
            9999994, 9999994, 9999994, 9999994, 9999994, 9999994, 9999994,
            9999994, 9999994, 9999994, 9999994, 9999994, 9999994, 9999994,
            9999994, 9999994],
        "s_total": [
            157.44332885742188, 157.4430389404297, 157.4430694580078,
            157.44320678710938, 157.44342041015625, 157.44308471679688,
            157.4434814453125, 157.44345092773438, 157.44326782226562,
            157.443359375, 157.44332885742188, 157.44332885742188,
            157.4432830810547, 157.44338989257812, 157.44334411621094,
            157.44332885742188, 157.44329833984375, 157.44325256347656,
            157.4433135986328, 157.44338989257812, 157.44332885742188,
            157.44332885742188, 157.443359375, 157.443359375,
            157.44338989257812, 157.44338989257812, 157.4434051513672,
            157.4434051513672, 157.44332885742188, 157.44342041015625],
        "variance": [
            0.09237843751907349, 0.04761618748307228, 0.03338276222348213,
            0.025163279846310616, 0.01962435245513916, 0.01563839055597782,
            0.012654215097427368, 0.010358444415032864, 0.008556576445698738,
            0.007120463997125626, 0.005961827002465725, 0.005017738789319992,
            0.004242104943841696, 0.003600410185754299, 0.0030663427896797657,
            0.0026195368263870478, 0.0022440264001488686, 0.001927157281897962,
            0.0016588042490184307, 0.0014307994861155748, 0.00123650545720011,
            0.0010704932501539588, 0.0009282978717237711,
            0.0008062266279011965, 0.0007012129644863307,
            0.0006106983637437224, 0.0005325403762981296,
            0.0004649386974051595, 0.0004063755623064935, 0.0003555675211828202],
        "w_total": [
            1000000.0, 1000000.0625, 1000000.0625, 1000000.125, 1000000.25,
            1000000.125, 1000000.25, 1000000.25, 1000000.25, 1000000.25,
            1000000.25, 1000000.25, 1000000.375, 1000000.3125, 1000000.3125,
            1000000.375, 1000000.4375, 1000000.5, 1000000.375, 1000000.5,
            1000000.5625, 1000000.5, 1000000.5625, 1000000.625, 1000000.625,
            1000000.6875, 1000000.625, 1000000.6875, 1000000.6875, 1000000.8125]},
    "pushsum_until": {"rounds": 21, "messages": 209999874, "value": 0.00123650545720011}}
EXPECTED_RING_GOSSIP = {
    "mean": [
        0.0030395605135709047, 0.0047042411752045155, 0.007507409900426865,
        0.009023258462548256, 0.008777610957622528, 0.008666769601404667,
        0.008878462947905064, 0.008586831390857697, 0.008293570950627327,
        0.008358314633369446, 0.008258913643658161, 0.008164326660335064,
        0.008072528056800365, 0.008058162406086922, 0.008053564466536045,
        0.007971355691552162, 0.007943978533148766, 0.008003068156540394,
        0.008061734028160572, 0.008070528507232666, 0.008099461905658245,
        0.008126797154545784, 0.008096510544419289, 0.008103225380182266,
        0.008109411224722862, 0.00810911227017641, 0.008107979781925678,
        0.00811090786010027, 0.008105511777102947, 0.008106157183647156],
    "messages": [
        200000, 200000, 200000, 200000, 200000, 200000, 200000, 200000, 200000,
        200000, 200000, 200000, 200000, 200000, 200000, 200000, 200000, 200000,
        200000, 200000, 200000, 200000, 200000, 200000, 200000, 200000, 200000,
        200000, 200000, 200000],
    "variance": [
        0.5023915767669678, 0.28681084513664246, 0.17299900949001312,
        0.10631242394447327, 0.06708265095949173, 0.04245483875274658,
        0.026887008920311928, 0.017116615548729897, 0.0110307103022933,
        0.007130569312721491, 0.004589305259287357, 0.0029744186904281378,
        0.0019324647728353739, 0.0012621531495824456, 0.0008257279987446964,
        0.0005404214607551694, 0.00035404725349508226, 0.0002321419888176024,
        0.00015368910680990666, 0.00010195614595431834, 6.812311039539054e-05,
        4.551235178951174e-05, 3.0123841497697867e-05, 1.9994378817500547e-05,
        1.3224840586190112e-05, 8.744607839616947e-06, 5.8301352510170545e-06,
        3.882892542605987e-06, 2.586204800536507e-06, 1.730086182760715e-06],
    "values_sha256": ("d38c82742c51ce8b97bf6c321ae1bc36"
                      "480a69de97444bae186704b381c544b9")}
EXPECTED_MESH_DEMO = {
    "events_sha256": ("6802ba353e31b0433921a4c71089cfdc"
                      "7fb7f921927051fec746714264111426"),
    "n_events": 15,
    "summary": {"rounds": 7, "coverage": 0.7298459410667419, "messages": 8919679},
    "alive_nodes": 899657,
    "status_sha256": ("1c7d1890b076a8fc48319d4083bd6548"
                      "93cca9caa434ed9adf5958e185af785f"),
    "sim_round": 19,
    "sim_messages": 9035661,
    "resumed_equal": True}
EXPECTED_MESH_PAGERANK = [
    {
        "sim_round": 1,
        "messages": 9999994,
        "rank_max": 1.5765403986733872e-06,
        "rank_total": 1.000000238418579,
        "residual": 0.06651322543621063},
    {
        "sim_round": 2,
        "messages": 9999994,
        "rank_max": 1.5480181900784373e-06,
        "rank_total": 1.0000001192092896,
        "residual": 0.014935850165784359},
    {
        "sim_round": 3,
        "messages": 9999994,
        "rank_max": 1.5855230230954476e-06,
        "rank_total": 1.0,
        "residual": 0.004464610945433378},
    {
        "sim_run": True,
        "rounds": 14,
        "messages": 139999916,
        "value": 1.568558582221158e-05}]
#: 4t's walk (the JAX package's ring, ``source_csr=True``, the same
#: :func:`ring_walk_run`; ~40 s on the CPU):
#:   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 python - <<'EOF'
#:   import jax, chip_smoke as c
#:   from p2pnetwork_tpu import models as M
#:   from p2pnetwork_tpu.parallel import mesh, sharded as S
#:   from p2pnetwork_tpu.sim import graph as G
#:   m, g = mesh.ring_mesh(8), G.watts_strogatz(1_000_000, 10, 0.1, seed=0)
#:   run, rec = c.ring_walk_run(S, M.RandomWalks, S.shard_graph(g, m, source_csr=True), m, jax.random.key(0))
#:   print(rec(run()))
#:   EOF
EXPECTED_RING_WALK = {
    "coverage": [
        0.008187999948859215, 0.011877000331878662, 0.01537800021469593,
        0.018724000081419945, 0.021963000297546387, 0.02504800073802471,
        0.028108999133110046, 0.031165000051259995, 0.03413400053977966,
        0.03701300173997879, 0.039877999573946, 0.0427279993891716,
        0.045485999435186386, 0.04828700050711632, 0.051061999052762985,
        0.05377399921417236, 0.05647600069642067, 0.05917400121688843,
        0.061847999691963196, 0.06447599828243256, 0.06708099693059921,
        0.06969200074672699, 0.07234500348567963, 0.07501400262117386,
        0.07762499898672104, 0.08022800087928772, 0.08281700313091278,
        0.08541599661111832, 0.08802399784326553, 0.09059900045394897,
        0.09309600293636322, 0.09556400030851364, 0.09803999960422516,
        0.10050000250339508, 0.1029760017991066, 0.10546299815177917,
        0.1079069972038269, 0.11038800328969955, 0.1128230020403862,
        0.11525300145149231, 0.11769499629735947, 0.12011600285768509,
        0.12247800081968307, 0.1249219998717308, 0.12735900282859802,
        0.12976600229740143, 0.13221000134944916, 0.13458199799060822,
        0.13702300190925598, 0.13940100371837616, 0.1418139934539795,
        0.14412400126457214, 0.1464959979057312, 0.14884600043296814,
        0.1511249989271164, 0.1534470021724701, 0.15573999285697937,
        0.1580740064382553, 0.16040000319480896, 0.16272799670696259,
        0.16501100361347198, 0.16726499795913696, 0.16956299543380737,
        0.1717900037765503],
    "messages": [
        4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
        4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
        4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
        4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
        4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096, 4096,
        4096, 4096, 4096, 4096],
    "stuck": [
        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    "pos_sha256": ("6c81cf33466c350788426ac5ee97379d"
                   "06100f62e143951160af2605d37ca97f"),
    "visited_sha256": ("045b37133a9bbbcebe136c645ae5b93e"
                       "5ae1df5ae337e82debcefebfee855cd7")}
#: 4t's f32 tolerances, (rtol, atol) by stat: the port's ``mxu`` and
#: ``hybrid`` rings against the reference's ``segment`` ring (its sums of
#: f32 terms in other orders; ``PUSHSUM_TOL``'s and ``PAGERANK_TOL``'s
#: orders of magnitude), the gossip rung's (exact on the CPU, the psum
#: order kept) as 4g's.
RING_TOL = {
    "pagerank": {"residual": (1e-3, 0.0), "rank_total": (0.0, 1e-5),
                 "rank_max": (1e-5, 0.0)},
    "pagerank_until": {"value": (1e-3, 0.0)},
    "pushsum": PUSHSUM_TOL,
    "pushsum_until": {"value": (1e-4, 0.0)},
    "gossip": GOSSIP_TOL,
    "mesh_pagerank": {"residual": (1e-3, 0.0), "rank_total": (0.0, 1e-5),
                      "rank_max": (1e-5, 0.0), "value": (1e-3, 0.0)}}

#: Phase 4u (slice 13): the JAX ring's records on phase 4's graph sharded
#: 8 ways with ``source_csr=True`` (``segment``: the reference's results
#: do not depend on the layout or on ``adaptive_k``), and on 4j's graph's
#: ``segment`` ring. Regenerate on the CPU (~25 s):
#:   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 python - <<'EOF'
#:   import hashlib, numpy as np
#:   from p2pnetwork_tpu.sim import graph as G, flightrec as FR
#:   from p2pnetwork_tpu.parallel import mesh, sharded as S
#:   from p2pnetwork_tpu.models import HopDistance
#:   from p2pnetwork_tpu.models.messagebatch import BatchFlood
#:   sha = lambda a: hashlib.sha256(np.ascontiguousarray(np.asarray(a)).tobytes()).hexdigest()
#:   m = mesh.ring_mesh(8); g = G.watts_strogatz(1_000_000, 10, 0.1, seed=0)
#:   sg = S.shard_graph(g, m, source_csr=True); cov = dict(coverage_target=0.99, comm="ppermute")
#:   seen, out = S.flood_until_coverage(sg, m, 0, max_rounds=64, adaptive_k=1024, **cov); print(out, sha(seen))
#:   seen, out = S.flood_until_coverage(sg, m, 0, max_rounds=64, recorder=FR.FlightRecorder(64), **cov)
#:   fr = out.pop("flight_record"); print(out, sha(seen), sha(fr.rows), fr.rows[0, -1])
#:   (d, f, r), out = S.hopdist_until_coverage(sg, m, HopDistance(source=0), adaptive_k=1024, **cov); print(out, sha(d), sha(f), r)
#:   bg = G.watts_strogatz(100_000, 10, 0.1, seed=0, source_csr=True); src = np.random.default_rng(0).integers(0, bg.n_nodes, size=1024).astype(np.int32)
#:   p = BatchFlood(method="segment"); b, out = S.run_batch_until_coverage(S.shard_graph(bg, m), m, p, p.init(bg, src, coverage_target=0.99), max_rounds=64, comm="ppermute", donate=False, recorder=FR.FlightRecorder(64))
#:   print(sha(out["flight_record"].rows), out["flight_record"].rows[0, -1])
#:   EOF
ADAPTIVE_K = 1024
EXPECTED_RING_SEEN = ("250d7db019667ea8ee45e2a0dd392c29"
                      "1b1b6c2d8082df5cc718a9d8a2fdf982")
EXPECTED_ADAPTIVE_HOP = {
    "summary": {"rounds": 11, "coverage": 0.9997529983520508,
                "messages": 9372400},
    "dist": ("e1b12f68e47e12baa07c814170201ab9"
             "4479da4a0fa05e48f00db1b2875333b4"),
    "frontier": ("1bf5cafa50cdb942796d9529a9c97ec7"
                 "fbe8fb0d6d4c0ea5a2fea737175a2551"),
    "round": 11}
#: The recorded rows (f32 ``[11, 7]``) and ``ici_bytes`` (the reference's
#: per-round census: 4 scalar ``psum``s and 7 hops of the ``bool[125008]``
#: frontier), and the lane ring's (``[10, 7]``; 4 ``psum``s and 7 hops of
#: the ``u32[32, 12512]`` words).
EXPECTED_RING_REC = {"rows": ("b885ca64c791d464d473faa1073a37c6"
                              "c7cd4fad4d7b08143900a7640aa5e19b"),
                     "ici": 875_084, "rounds": 11}
EXPECTED_LANE_REC = {"rows": ("054ed423ff8b3475311a852179a5c799"
                              "04d1fd68e18b4105fb0e621ea54e1201"),
                     "ici": 11_218_158, "rounds": 10}
#: Kernel launches of one dense ring OR pass, by layout.
DENSE_PASS = {"hybrid": {"segsum": 8, "ring_shift": 7},
              "mxu": {"ring_segsum": 7, "segsum": 1},
              "segment": {"ring_shift": 7}}
#: 4u(f): nodes a budgeted service is asked to grow by (4j's graph doubled).
PLAN_GROW = 100_000

#: (layout, rows, width, block, share of live slots) of the main path's
#: two kernel layouts at 1M nodes; the live shares are those of the real
#: layouts (0.80 and 0.91 at 100K nodes, measured on the CPU build).
LAYOUTS = [("hybrid-remainder", 1954, 640, 512, 0.8),
           ("blocked", 7813, 1408, 128, 0.9)]

#: The ring at 1M nodes and 8 shards: the shard block, and (layout, NB, W,
#: live share) of one ring step's buckets ``[8, NB, W]``, block 512. Live
#: shares are the whole layouts' (9,999,994 of 8·8·245·4864 slots for
#: ``mxu``; 999,700 of 8·8·245·128 for ``hybrid``), from the JAX package's
#: shard_graph at 1M on the CPU.
RING_SHARDS = 8
RING_BLOCK = 125_008
#: The 100K gossip rung's shard block (``RING_GOSSIP_GRAPH`` on 8 shards).
RING_GOSSIP_BLOCK = 12_512
RING_MXU = ("mxu", 245, 4864, 0.131)
RING_HYBRID = ("hybrid", 245, 128, 0.498)
RING_LAYOUTS = [("segment", {}), ("mxu", {"mxu": True}),
                ("hybrid", {"hybrid": True})]

#: H100 SXM data-sheet peaks: HBM bytes/s and non-tensor f32 ops/s.
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12

RTOL = ATOL = 1e-5

#: B1's edge geometries (label, NB, W, block, offset in elements of the
#: rows into their buffers). At block 1 a row's ~26 live slots all sum
#: into one element, about the blocked layout's 10 terms per output: a
#: row of hundreds of N(0, 1) terms would leave f32 rounding of an
#: unordered sum above rtol = atol = 1e-5 on either side. Row counts 2 * 132 * m - 1 leave the
#: persistent grid's last block one row whatever the residency m (blocks
#: per SM, at most 8) on 132 SMs; 132 * m + 1 give its first block one row
#: more than the others.
B1_EDGES = [("odd-width", 300, 1407, 128, 0),
            ("rows-unaligned", 300, 1408, 128, 1),
            ("mask-unaligned", 300, 1408, 128, 4),
            ("narrow-128", 245, 128, 512, 0),
            ("narrow-32", 245, 32, 512, 0),
            ("block-1", 64, 32, 1, 0),
            ("block-max", 64, 640, None, 0),
            ("block-max-narrow", 64, 128, None, 0),
            *[(f"grid-last-one-{m}", 2 * 132 * m - 1, 640, 128, 0)
              for m in range(1, 9)],
            *[(f"grid-first-extra-{m}", 132 * m + 1, 640, 128, 0)
              for m in range(1, 9)]]
#: B2's per-shard payloads that are not multiples of 16 bytes.
B2_EDGES = [(torch.bool, (RING_SHARDS, RING_BLOCK - 1)),
            (torch.uint8, (RING_SHARDS, 17)),
            (torch.int32, (RING_SHARDS, 3, 31))]


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_times(fn, reps: int, flush: torch.Tensor) -> float:
    """Mean device ms of ``fn()`` over ``reps`` launches, each after an L2
    flush. All launches are enqueued behind a device sleep, so host-side
    launch overhead leaves no gaps between the timed events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def back_to_back_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn()`` over ``reps`` launches enqueued back to
    back between two events, with no flush between them: each launch's
    fixed start overlaps the previous one's run, so against
    :func:`cuda_times` this shows how much of a short kernel's time is its
    body."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(slots, live_slots, in_bytes, out_bytes):
    """Least device time in ms and what sets it: the mask byte of each of
    the ``slots`` the function must read, the src and destination of each
    live slot, the other inputs (``in_bytes``) and the output once over
    the HBM rate, or one operation per slot read over the vector rate."""
    by_bytes = (slots + 8 * live_slots + in_bytes + out_bytes) \
        / HBM_BYTES_PER_S
    by_ops = slots / VECTOR_OPS_PER_S
    if by_bytes >= by_ops:
        return 1e3 * by_bytes, "bytes"
    return 1e3 * by_ops, "operations"


def ring_buckets(gen, nb, w, block, live):
    """Seeded random buckets of one ring step, as the ring passes them:
    the strided slice ``[:, 1]`` of ``[8, 2, NB, W]`` arrays."""
    dev = torch.device("cuda")
    shape = (RING_SHARDS, 2, nb, w)
    src = torch.randint(0, RING_BLOCK, shape, generator=gen, device=dev,
                        dtype=torch.int32)
    dst = torch.randint(0, block, shape, generator=gen, device=dev,
                        dtype=torch.int32)
    mask = torch.rand(shape, generator=gen, device=dev) < live
    return src[:, 1], dst[:, 1], mask[:, 1]


def ring_signals(gen):
    """Bool, f32 and integer-valued f32 ``rot [8, 125008]``."""
    shape, dev = (RING_SHARDS, RING_BLOCK), torch.device("cuda")
    return (torch.rand(shape, generator=gen, device=dev) < 0.1,
            torch.randn(shape, generator=gen, device=dev),
            torch.randint(0, 16, shape, generator=gen,
                          device=dev).to(torch.float32))


def pregathered(sig, src, mask):
    """The terms a ``scatter_add_`` yardstick sums, gathered up front."""
    flat = src.reshape(src.shape[0], -1).long()
    terms = sig.gather(1, flat).reshape(src.shape).to(torch.float32)
    return (terms * mask).reshape(-1, src.shape[-1])


def poison(x, src, mask, at_zero=True):
    """``x`` (``[B]`` or ``[S, B]``) with NaN, +inf and -inf at the sources
    of three live slots of each shard's buckets ``src``/``mask`` and, with
    ``at_zero``, +inf at source 0, the address padding slots read."""
    bad = x.clone()
    rows = bad if bad.dim() == 2 else bad[None]
    srcs = src if src.dim() == 3 else src[None]
    masks = mask if mask.dim() == 3 else mask[None]
    for d in range(rows.shape[0]):
        live = srcs[d][masks[d]]
        picks = live[torch.linspace(0, live.numel() - 1, 3,
                                    device=live.device).long()].long()
        rows[d, picks] = torch.tensor([float("nan"), float("inf"),
                                       float("-inf")], device=x.device)
        if at_zero:
            rows[d, 0] = float("inf")
    return bad


def check_nonfinite(label, got, want):
    """C1: the kernel's NaN set must equal its plain version's, every
    other output within tolerance. Returns the count of NaN outputs."""
    if not torch.equal(got.isnan(), want.isnan()) or not torch.allclose(
            got, want, rtol=RTOL, atol=ATOL, equal_nan=True):
        fail(f"{label}: non-finite terms spread differently from the plain "
             f"version")
    n_nan = int(want.isnan().sum().item())
    if n_nan == 0:
        fail(f"{label}: the non-finite check put no NaN anywhere")
    return n_nan


def ring_kernel_phase(ring, segsum, flush):
    """Phase 3, the ring's kernels: B1's stacked entry, B2 and B3 against
    their plain versions at the 1M/S=8 shapes."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = torch.device("cuda")
    flags, x, xi = ring_signals(gen)
    rows, max_err = [], {"segsum": 0.0, "ring_shift": 0.0,
                         "ring_segsum": 0.0}

    # B2: the hop.
    for sig, tag in ((flags, "bool"), (x, "f32")):
        for reverse in (False, True):
            if not torch.equal(ring.ring_shift(sig, reverse=reverse),
                               ring.ring_shift_plain(sig, reverse=reverse)):
                fail(f"ring_shift differs from its plain version ({tag}, "
                     f"reverse={reverse})")
        nbytes = sig.numel() * sig.element_size()
        rows.append({
            "kernel": "ring_shift", "entry": tag,
            "shape": list(sig.shape),
            "ms": cuda_times(lambda: ring.ring_shift(sig), 50, flush),
            "plain_ms": cuda_times(lambda: ring.ring_shift_plain(sig), 50,
                                   flush),
            "library_ms": cuda_times(lambda: torch.roll(sig, 1, 0), 50,
                                     flush),
            "bound_ms": 1e3 * 2 * nbytes / HBM_BYTES_PER_S,
            "bound_by": "bytes"})

    # B1 stacked (hybrid buckets) and B3 (mxu buckets), block 512.
    block = 512
    for kernel, (layout, nb, w, live) in (("segsum", RING_HYBRID),
                                          ("ring_segsum", RING_MXU)):
        src, dst, mask = ring_buckets(gen, nb, w, block, live)
        args = (src, dst, mask, block)
        live_slots = int(mask.sum().item())
        lib_out = torch.zeros(RING_SHARDS * nb, block, device=dev)
        dst64 = dst.reshape(-1, w).long()
        for entry, sig in (("or", flags), ("sum", x)):
            if kernel == "segsum":
                fn = getattr(segsum, f"segsum_{entry}")
                plain = getattr(segsum, f"segsum_{entry}_plain")
                got, want = fn(sig, *args), plain(sig, *args)
                exact = entry == "or" or torch.equal(
                    fn(xi, *args), plain(xi, *args))
            else:
                fn = getattr(ring, f"ring_segment_sum_{entry}")
                plain = getattr(ring, f"ring_segment_sum_{entry}_plain")
                (rot_next, got), (want_next, want) = (fn(sig, *args),
                                                      plain(sig, *args))
                if not torch.equal(rot_next, want_next):
                    fail(f"ring_segment_sum_{entry}: rot_next differs")
                exact = entry == "or" or torch.equal(
                    fn(xi, *args)[1], plain(xi, *args)[1])
            if entry == "or" and not torch.equal(got, want):
                fail(f"{kernel} OR differs from its plain version")
            if not exact:
                fail(f"{kernel} sum inexact on integer values")
            err = (got.float() - want.float()).abs().max().item()
            max_err[kernel] = max(max_err[kernel], err)
            if not torch.allclose(got.float(), want.float(), rtol=RTOL,
                                  atol=ATOL):
                fail(f"{kernel} {entry} outside rtol=atol={RTOL}: {err}")
            torch.cuda.synchronize()
            sig_bytes = sig.numel() * sig.element_size()
            out_bytes = RING_SHARDS * nb * block * sig.element_size()
            if kernel == "ring_segsum":  # the hop writes rot_next too
                out_bytes += sig_bytes
            least, bound_by = bound(RING_SHARDS * nb * w, live_slots,
                                    sig_bytes, out_bytes)
            terms = pregathered(sig, src, mask)
            rows.append({
                "kernel": kernel, "layout": layout, "entry": entry,
                "shape": [RING_SHARDS, nb, w], "block": block,
                "live_slots": live_slots,
                "ms": cuda_times(lambda: fn(sig, *args), 50, flush),
                "plain_ms": cuda_times(lambda: plain(sig, *args), 20, flush),
                "library_ms": cuda_times(
                    lambda: lib_out.scatter_add_(1, dst64, terms), 50, flush),
                "bound_ms": least, "bound_by": bound_by})
            if kernel == "ring_segsum":
                # The same rows on the extent path, every extent W: slower
                # here than the full-width paths a launch without extents
                # takes (PERF.md), which is why those stay.
                full = torch.full(src.shape[:-1], w, dtype=torch.int32,
                                  device=dev)
                nxt, got = fn(sig, *args, extent=full)
                if not torch.equal(nxt, want_next) or not (
                        torch.equal(got, want) if entry == "or" else
                        torch.allclose(got, want, rtol=RTOL, atol=ATOL)):
                    fail(f"ring_segment_sum_{entry} with extents W differs "
                         f"from its plain version")
                rows[-1]["extent_w_ms"] = cuda_times(
                    lambda: fn(sig, *args, extent=full), 50, flush)
    return rows, max_err


#: The ring steps phase 3b times B3 on: the dense first and one of the
#: sparse ones (steps 1 to S - 2 are alike; S - 1 is peeled, run by B1).
REAL_STEPS = (0, 1)


def real_step_phase(ring, sg) -> tuple:
    """Phase 3b: B3 on the ring ``mxu`` layout's real buckets of
    ``REAL_STEPS``, sliced ``[:, t]`` as the ring pass slices them, with
    each row's extent (``ms``; ``bound_ms`` counts the slots up to each
    row's extent and the extents) and at full width (``full_width_ms``,
    the path of a launch without extents, beside ``full_width_bound_ms``
    over every slot), against its plain version: OR and
    ``rot_next`` bit-equal, sum within tolerance, integer sum exact; after
    the timed rows, C1: the sum with NaN and +-inf at live slots, and at
    ``rot[d, 0]``, with the plain version's NaN set.
    ``launch_floor_ms`` is a one-element fill timed the same way: the
    least any launch shows here. Returns the rows and the sum's max abs
    error."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    dev = torch.device("cuda")
    flags, x, xi = ring_signals(gen)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    # What any one launch takes under this timing: a one-element fill.
    tiny = torch.zeros(1, device=dev)
    floor_ms = cuda_times(lambda: tiny.fill_(1.0), 50, flush)
    block = sg.mxu_block
    rows, max_err, nan_outputs = [], 0.0, {}
    for t in REAL_STEPS:
        src, dst, mask = (a[:, t] for a in (sg.mxu_src, sg.mxu_dst,
                                            sg.mxu_mask))
        extent = sg.mxu_extent[:, t]
        s, nb, w = src.shape
        args = (src, dst, mask, block)
        live_slots = int(mask.sum().item())
        slots = int(extent.sum().item())
        extent_bytes = extent.numel() * extent.element_size()
        lib_out = torch.zeros(s * nb, block, device=dev)
        dst64 = dst.reshape(-1, w).long()
        for entry, sig in (("or", flags), ("sum", x)):
            fn = getattr(ring, f"ring_segment_sum_{entry}")
            plain = getattr(ring, f"ring_segment_sum_{entry}_plain")
            want_next, want = plain(sig, *args)
            for ext in (extent, None):
                nxt, got = fn(sig, *args, extent=ext)
                label = f"ring_segment_sum_{entry} on real step {t} " \
                        f"({'extents' if ext is not None else 'full width'})"
                if not torch.equal(nxt, want_next):
                    fail(f"{label}: rot_next differs")
                if entry == "or" and not torch.equal(got, want):
                    fail(f"{label}: OR differs from its plain version")
                if entry == "sum":
                    err = (got - want).abs().max().item()
                    max_err = max(max_err, err)
                    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
                        fail(f"{label}: outside rtol=atol={RTOL}: {err}")
                    if not torch.equal(fn(xi, *args, extent=ext)[1],
                                       plain(xi, *args)[1]):
                        fail(f"{label}: inexact on integer values")
            torch.cuda.synchronize()
            sig_bytes = sig.numel() * sig.element_size()
            out_bytes = s * nb * block * sig.element_size() + sig_bytes
            # With extents the function reads each row only up to its
            # extent, plus the extents themselves; at full width, every slot.
            least, bound_by = bound(slots, live_slots,
                                    sig_bytes + extent_bytes, out_bytes)
            full_least, _ = bound(s * nb * w, live_slots, sig_bytes,
                                  out_bytes)
            terms = pregathered(sig, src, mask)
            rows.append({
                "kernel": "ring_segsum", "layout": "mxu", "step": t,
                "entry": entry, "shape": [s, nb, w], "block": block,
                "live_slots": live_slots,
                "extent_mean": extent.float().mean().item(),
                "extent_max": int(extent.max().item()),
                "ms": cuda_times(lambda: fn(sig, *args, extent=extent), 50,
                                 flush),
                "full_width_ms": cuda_times(lambda: fn(sig, *args), 50, flush),
                "plain_ms": cuda_times(lambda: plain(sig, *args), 20, flush),
                "library_ms": cuda_times(
                    lambda: lib_out.scatter_add_(1, dst64, terms), 50, flush),
                "bound_ms": least, "bound_by": bound_by,
                "full_width_bound_ms": full_least,
                "launch_floor_ms": floor_ms})
            print(json.dumps({"phase": "kernel-real-step", **rows[-1]}),
                  flush=True)
    # C1, after the timed rows: the sum with NaN and +-inf at live slots
    # (rot[d, 0] finite), then with NaN or +inf at rot[d, 0], which every
    # row's padding reads (those rows go all NaN).
    for t in REAL_STEPS:
        src, dst, mask = (a[:, t] for a in (sg.mxu_src, sg.mxu_dst,
                                            sg.mxu_mask))
        args = (src, dst, mask, block)
        x_live = poison(x, src, mask, at_zero=False)
        x_live[:, 0] = x[:, 0]
        x_pad = x.clone()
        x_pad[0::2, 0], x_pad[1::2, 0] = torch.nan, torch.inf
        for ext in (sg.mxu_extent[:, t], None):
            for tag, bad in (("live", x_live), ("pad", x_pad)):
                label = (f"ring_segment_sum_sum on real step {t} ("
                         f"{'extents' if ext is not None else 'full width'}"
                         f"), non-finite {tag}")
                nan_outputs[f"step{t}-{tag}-" + (
                    "extents" if ext is not None else "full")] = \
                    check_nonfinite(label,
                                    ring.ring_segment_sum_sum(
                                        bad, *args, extent=ext)[1],
                                    ring.ring_segment_sum_sum_plain(
                                        bad, *args)[1])
    print(json.dumps({"phase": "c1", "kernel": "ring_segsum",
                      "nan_outputs": nan_outputs}), flush=True)
    return rows, max_err


#: Sources drawn from this many nodes only, for ``local_src_ms``: the
#: same rows with gathers that stay in L1/L2.
LOCAL_SOURCES = 4096


def kernel_phase(segsum, flush):
    """Phase 3: kernel vs plain version at the main path's layouts."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    rows, max_err = [], 0.0
    for layout, nb, w, block, live in LAYOUTS:
        src = torch.randint(0, N_PAD, (nb, w), generator=gen, device=dev,
                            dtype=torch.int32)
        dst = torch.randint(0, block, (nb, w), generator=gen, device=dev,
                            dtype=torch.int32)
        mask = torch.rand(nb, w, generator=gen, device=dev) < live
        flags = torch.rand(N_PAD, generator=gen, device=dev) < 0.1
        x = torch.randn(N_PAD, generator=gen, device=dev)
        xi = torch.randint(0, 16, (N_PAD,), generator=gen,
                           device=dev).to(torch.float32)
        args = (src, dst, mask)

        if not torch.equal(segsum.segsum_or(flags, *args, block),
                           segsum.segsum_or_plain(flags, *args, block)):
            fail(f"segsum_or differs from its plain version ({layout})")
        got = segsum.segsum_sum(x, *args, block)
        want = segsum.segsum_sum_plain(x, *args, block)
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            fail(f"segsum_sum outside rtol=atol={RTOL} ({layout}): {err}")
        if not torch.equal(segsum.segsum_sum(xi, *args, block),
                           segsum.segsum_sum_plain(xi, *args, block)):
            fail(f"segsum_sum inexact on integer values ({layout})")
        torch.cuda.synchronize()

        contrib_or = (flags[src] & mask).to(torch.float32)
        contrib_sum = x[src] * mask.to(torch.float32)
        lib_out = torch.zeros(nb, block, device=dev)
        dst64 = dst.long()
        local_src = src % LOCAL_SOURCES
        live_slots = int(mask.sum().item())
        for entry, sig, sig_bytes, out_bytes, contrib in (
                ("or", flags, N_PAD, nb * block, contrib_or),
                ("sum", x, 4 * N_PAD, 4 * nb * block, contrib_sum)):
            kernel = getattr(segsum, f"segsum_{entry}")
            plain = getattr(segsum, f"segsum_{entry}_plain")
            least, bound_by = bound(nb * w, live_slots, sig_bytes,
                                    out_bytes)
            rows.append({
                "layout": layout, "entry": entry, "shape": [nb, w],
                "block": block, "live_slots": live_slots,
                "ms": cuda_times(lambda: kernel(sig, *args, block), 50, flush),
                "plain_ms": cuda_times(lambda: plain(sig, *args, block), 20,
                                       flush),
                "library_ms": cuda_times(
                    lambda: lib_out.scatter_add_(1, dst64, contrib), 50,
                    flush),
                "local_src_ms": cuda_times(
                    lambda: kernel(sig, local_src, dst, mask, block), 50,
                    flush),
                "bound_ms": least, "bound_by": bound_by,
            })
    return rows, max_err


def c1_phase(segsum):
    """Phase 3, C1 (after the timed rows, which then see the parent's
    allocations): B1's sum on both layouts with NaN, +inf and -inf at live
    slots and +inf at source 0, which padding slots read (the last 4
    slots of every 7th row: source 0 behind a False mask)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    dev = torch.device("cuda")
    nan_outputs = {}
    for layout, nb, w, block, live in LAYOUTS:
        src = torch.randint(0, N_PAD, (nb, w), generator=gen, device=dev,
                            dtype=torch.int32)
        dst = torch.randint(0, block, (nb, w), generator=gen, device=dev,
                            dtype=torch.int32)
        mask = torch.rand(nb, w, generator=gen, device=dev) < live
        x = torch.randn(N_PAD, generator=gen, device=dev)
        bad = poison(x, src, mask)
        src[::7, -4:], mask[::7, -4:] = 0, False
        args = (bad, src, dst, mask, block)
        nan_outputs[layout] = check_nonfinite(
            f"segsum_sum ({layout}, non-finite terms)",
            segsum.segsum_sum(*args), segsum.segsum_sum_plain(*args))
    print(json.dumps({"phase": "c1", "kernel": "segsum",
                      "nan_outputs": nan_outputs}), flush=True)


def check_b1(segsum, label, flags, x, xi, src, dst, mask, block) -> float:
    """B1 (single or stacked) against its plain version on one geometry:
    OR bit-equal, f32 sum within tolerance, integer-valued sum exact.
    Returns the sum's max abs error."""
    args = (src, dst, mask, block)
    if not torch.equal(segsum.segsum_or(flags, *args),
                       segsum.segsum_or_plain(flags, *args)):
        fail(f"segsum_or differs from its plain version ({label})")
    got, want = segsum.segsum_sum(x, *args), segsum.segsum_sum_plain(x, *args)
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        fail(f"segsum_sum outside rtol=atol={RTOL} ({label}): {err}")
    if not torch.equal(segsum.segsum_sum(xi, *args),
                       segsum.segsum_sum_plain(xi, *args)):
        fail(f"segsum_sum inexact on integer values ({label})")
    return err


def edge_phase(ring, segsum) -> dict:
    """Phase 3, the row engine's edge geometries and B2's odd payloads,
    each against its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    dev = torch.device("cuda")
    flags = torch.rand(N_PAD, generator=gen, device=dev) < 0.1
    x = torch.randn(N_PAD, generator=gen, device=dev)
    xi = torch.randint(-8, 8, (N_PAD,), generator=gen,
                       device=dev).to(torch.float32)
    errs = {}
    for label, nb, w, block, offset in B1_EDGES:
        block = block or segsum.MAX_BLOCK

        def rows(t):  # contiguous [nb, w] rows `offset` elements in
            flat = torch.empty(offset + nb * w, dtype=t.dtype, device=dev)
            flat[offset:] = t.reshape(-1)
            return flat[offset:].view(nb, w)

        src = rows(torch.randint(0, N_PAD, (nb, w), generator=gen,
                                 device=dev, dtype=torch.int32))
        dst = rows(torch.randint(0, block, (nb, w), generator=gen,
                                 device=dev, dtype=torch.int32))
        mask = rows(torch.rand(nb, w, generator=gen, device=dev) < 0.8)
        errs[label] = check_b1(segsum, label, flags, x, xi, src, dst, mask,
                               block)

    # A stacked step slice [:, 1] of [3, 3, 5, 130] buckets: W = 130 and
    # the slice 650 elements in, so no row is 16-byte aligned. B1's
    # stacked entry and B3.
    s, nb, w, block, b = 3, 5, 130, 128, 300
    shape = (s, s, nb, w)
    src = torch.randint(0, b, shape, generator=gen, device=dev,
                        dtype=torch.int32)[:, 1]
    dst = torch.randint(0, block, shape, generator=gen, device=dev,
                        dtype=torch.int32)[:, 1]
    mask = (torch.rand(shape, generator=gen, device=dev) < 0.7)[:, 1]
    rot = torch.rand(s, b, generator=gen, device=dev) < 0.3
    rx = torch.randn(s, b, generator=gen, device=dev)
    rxi = torch.randint(-8, 8, (s, b), generator=gen,
                        device=dev).to(torch.float32)
    errs["stacked-unaligned"] = check_b1(segsum, "stacked-unaligned", rot,
                                         rx, rxi, src, dst, mask, block)
    for entry, sig in (("or", rot), ("sum", rx), ("sum", rxi)):
        fn = getattr(ring, f"ring_segment_sum_{entry}")
        plain = getattr(ring, f"ring_segment_sum_{entry}_plain")
        (nxt, got), (want_nxt, want) = (fn(sig, src, dst, mask, block),
                                        plain(sig, src, dst, mask, block))
        exact = entry == "or" or sig is rxi
        if not torch.equal(nxt, want_nxt) or (
                exact and not torch.equal(got, want)) or not torch.allclose(
                    got.float(), want.float(), rtol=RTOL, atol=ATOL):
            fail(f"ring_segment_sum_{entry} differs from its plain version "
                 f"(stacked-unaligned)")

    for dtype, shape in B2_EDGES:
        xs = torch.randint(0, 100, shape, generator=gen,
                           device=dev).to(dtype)
        for reverse in (False, True):
            if not torch.equal(ring.ring_shift(xs, reverse=reverse),
                               ring.ring_shift_plain(xs, reverse=reverse)):
                fail(f"ring_shift differs from its plain version on "
                     f"{dtype} {list(shape)} (reverse={reverse})")
    torch.cuda.synchronize()
    print(json.dumps({"phase": "edges", "b1_sum_max_abs_err": errs,
                      "b2": [[str(d), list(sh)] for d, sh in B2_EDGES]}),
          flush=True)
    return errs


def bool_seen(state, n_pad):
    """A flood state's ``seen`` as bool (packed states unpacked)."""
    from p2pnetwork_tpu_torch.ops import bitset

    seen = state.seen
    return bitset.unpack_bits(seen, n_pad) if seen.dtype == torch.int32 \
        else seen


def main_path(engine, segsum, device_mod, graph_mod, models, frontier_ops):
    """Phase 4: the 1M-node flood contest through the port's entry points.
    Returns the kernel launches counted over the checked runs, the graph
    and the final ``seen`` every method reached."""
    Flood, AdaptiveFlood = models
    t0 = time.perf_counter()
    g = graph_mod.watts_strogatz(N_NODES, 10, 0.1, seed=0, blocked=True,
                                 hybrid=True, source_csr=True)
    torch.cuda.synchronize()
    rem = g.hybrid.remainder
    print(json.dumps({"phase": "graph", "build_s": time.perf_counter() - t0,
                      "n_pad": g.n_nodes_padded, "e_pad": g.n_edges_padded,
                      "diagonals": len(g.hybrid.offsets),
                      "hybrid_remainder": list(rem.src.shape),
                      "blocked": list(g.blocked.src.shape),
                      "max_out_span": g.max_out_span}), flush=True)
    contest = [("pallas", Flood(source=0, method="pallas")),
               ("hybrid", Flood(source=0, method="hybrid")),
               ("adaptive-1024", AdaptiveFlood(source=0, method="hybrid",
                                               k=1024)),
               ("adaptive-2048", AdaptiveFlood(source=0, method="hybrid",
                                               k=2048)),
               ("frontier", Flood(source=0, method="frontier", bitset=True))]
    runs, total_launches, seen = flood_runs(
        "main-path", g, contest, EXPECTED_1M, engine, segsum, device_mod,
        frontier_ops, kernel_free=("frontier",))
    if runs[-1]["frontier_rounds"] != FRONTIER_ROUNDS_1M:
        fail(f"frontier took {runs[-1]['frontier_rounds']} sparse/dense "
             f"rounds, the reference's budget gives {FRONTIER_ROUNDS_1M}")
    steady_state(runs, contest, g, engine, "main-path")
    return total_launches, g, seen


def flood_runs(phase, g, contest, expected, engine, segsum, device_mod,
               frontier_ops, kernel_free=()):
    """One checked run per method: each must return ``expected`` and
    reach the same final ``seen``; each but ``kernel_free`` must launch
    B1. Counts are set to 0 just before each run and read just after.
    Returns the per-method records, B1's launches over them and the final
    ``seen``."""
    n_live = g.node_mask.sum()
    runs, total, seen = [], 0, None
    for name, proto in contest:
        segsum.LAUNCHES = device_mod.SYNCS = 0
        frontier_ops.ROUNDS.update(sparse=0, dense=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = engine.run_until_coverage(g, proto, KEY,
                                               coverage_target=0.99,
                                               max_rounds=64)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = segsum.LAUNCHES
        if out != expected:
            fail(f"{phase} {name} returned {out}, the reference gives "
                 f"{expected}")
        final = bool_seen(state, g.n_nodes_padded)
        cov = ((final & g.node_mask).sum().to(torch.float32)
               / n_live.to(torch.float32)).item()
        if cov != out["coverage"] or final.shape != (g.n_nodes_padded,):
            fail(f"{phase} {name}: final state disagrees with its summary")
        if seen is not None and not torch.equal(final, seen):
            fail(f"{phase} {name}: final seen differs from "
                 f"{contest[0][0]}'s")
        seen = final
        if launches == 0 and name not in kernel_free:
            fail(f"{phase} {name} never launched the segment-sum kernel")
        total += launches
        runs.append({"method": name, "first_run_s": wall,
                     "launches": launches, "syncs": device_mod.SYNCS,
                     "frontier_rounds": dict(frontier_ops.ROUNDS)})
    return runs, total, seen


def paired_walls(with_run, without_run, pairs=REC_PAIRS) -> dict:
    """Medians of ``pairs`` walls of each run, taken in turns, and the
    median of the pairs' differences: the cost of what ``with_run`` adds."""
    walls = {"with": [], "without": []}
    for _ in range(pairs):
        for name, run in (("with", with_run), ("without", without_run)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    diffs = [a - b for a, b in zip(walls["with"], walls["without"])]
    return {"wall_s": statistics.median(walls["with"]),
            "wall_s_without": statistics.median(walls["without"]),
            "recorder_cost_s": statistics.median(diffs),
            "walls_with": walls["with"], "walls_without": walls["without"]}


def timed_runs(run, reps=5) -> dict:
    """Steady-state wall of ``run()`` (median of ``reps``, the checked run
    before them the warm-up) and one run under the profiler
    (:func:`profile_run`)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"wall_s": sorted(times)[reps // 2], "wall_s_all": times,
            "profile": profile_run(run)}


def steady_state(runs, contest, g, engine, phase):
    """Each method's steady-state wall and one profiled run
    (:func:`timed_runs`), outside the counted runs; prints a line each."""
    for run, (_, proto) in zip(runs, contest):
        run.update(timed_runs(lambda: engine.run_until_coverage(
            g, proto, KEY, coverage_target=0.99, max_rounds=64)))
        print(json.dumps({"phase": phase, **run}), flush=True)


def churn_path(g, engine, segsum, device_mod, models, frontier_ops,
               topology, failures):
    """Phase 4c: phase 4's graph under churn — 256 slots of dynamic
    region, the ladder's 64-link connect batch (undirected), nodes 5,000
    to 14,999 failed — flooded by five methods, then resumed: ``hybrid``
    by ``run_from`` for 3 rounds and ``run_until_coverage_from``. Returns
    B1's launches over the checked runs."""
    Flood, AdaptiveFlood = models
    t0 = time.perf_counter()
    gc = topology.with_capacity(g, extra_edges=256)
    gc = topology.connect(gc, [(i * 37) % 99_000 for i in range(64)],
                          [(i * 91 + 13) % 99_000 for i in range(64)])
    gc = failures.fail_nodes(gc, range(5_000, 15_000))
    torch.cuda.synchronize()
    print(json.dumps({
        "phase": "churn-graph", "build_s": time.perf_counter() - t0,
        "live_nodes": int(gc.node_mask.sum().item()),
        "live_edges": int(gc.edge_mask.sum().item()),
        "dynamic_links": int(gc.dyn_mask.sum().item()),
        "blocked_live_slots": int(gc.blocked.mask.sum().item()),
        "remainder_live_slots": int(gc.hybrid.remainder.mask.sum().item())}),
        flush=True)
    contest = [("pallas", Flood(source=0, method="pallas")),
               ("hybrid", Flood(source=0, method="hybrid")),
               ("adaptive-1024", AdaptiveFlood(source=0, method="hybrid",
                                               k=1024)),
               ("frontier", Flood(source=0, method="frontier", bitset=True)),
               ("segment", Flood(source=0, method="segment"))]
    runs, launches, seen = flood_runs(
        "churn-path", gc, contest, EXPECTED_CHURN, engine, segsum,
        device_mod, frontier_ops, kernel_free=("frontier", "segment"))

    # The resumed run: 3 rounds, then to coverage; the dict counts the
    # resumed rounds only, as the reference's does.
    proto = contest[1][1]
    segsum.LAUNCHES = device_mod.SYNCS = 0
    mid, stats = engine.run_from(gc, proto, proto.init(gc, KEY), KEY, 3)
    end, out = engine.run_until_coverage_from(gc, proto, mid, KEY,
                                              coverage_target=0.99,
                                              max_rounds=64)
    torch.cuda.synchronize()
    resumed = {"method": "hybrid-resumed", "launches": segsum.LAUNCHES,
               "syncs": device_mod.SYNCS,
               "run_from": {k: v.tolist() for k, v in stats.items()},
               "resumed": out}
    if resumed["run_from"] != EXPECTED_CHURN_RUN_FROM:
        fail(f"churn run_from gave {resumed['run_from']}, the reference "
             f"gives {EXPECTED_CHURN_RUN_FROM}")
    if out != EXPECTED_CHURN_RESUMED:
        fail(f"churn resumed run gave {out}, the reference gives "
             f"{EXPECTED_CHURN_RESUMED}")
    if not torch.equal(end.seen, seen):
        fail("churn resumed run ends elsewhere than the direct runs")
    if segsum.LAUNCHES == 0:
        fail("churn resumed run never launched the segment-sum kernel")
    launches += segsum.LAUNCHES
    print(json.dumps({"phase": "churn-path", **resumed}), flush=True)
    steady_state(runs, contest, gc, engine, "churn-path")
    return launches


def skew_path(engine, device_mod, models, graph_mod, failures):
    """Phase 4d: the ladder's 1M Barabási–Albert rung, flooded to 0.99 by
    ``skew``, ``auto`` (which must route to ``skew``), ``segment`` and the
    adaptive flood, then with a seeded 1% of its edges cut, by ``skew``
    and ``segment``. No kernel runs here: the skew table, segment and the
    sparse rounds are gathers and scatters."""
    from p2pnetwork_tpu_torch.ops import segment

    Flood, AdaptiveFlood = models
    t0 = time.perf_counter()
    g = graph_mod.barabasi_albert(N_NODES, 5, seed=0,
                                  build_neighbor_table=False,
                                  source_csr=True, skew_table=True)
    torch.cuda.synchronize()
    shape = {"skew_width": g.skew.width, "skew_rows": g.skew.n_rows,
             "max_out_span": g.max_out_span}
    print(json.dumps({"phase": "skew-graph",
                      "build_s": time.perf_counter() - t0,
                      "n_edges": g.n_edges, **shape}), flush=True)
    if shape != EXPECTED_BA_SHAPE:
        fail(f"BA skew table {shape}, the reference builds "
             f"{EXPECTED_BA_SHAPE}")
    if segment._auto_method(g) != "skew":
        fail(f"auto routes the BA graph to {segment._auto_method(g)}, "
             f"not skew")
    ids = np.random.default_rng(0).choice(g.n_edges, g.n_edges // 100,
                                          replace=False)
    cut = failures.fail_edges(g, ids)
    for graph, expected, contest in (
            (g, EXPECTED_BA, [
                ("skew", Flood(source=0, method="skew")),
                ("auto", Flood(source=0, method="auto")),
                ("segment", Flood(source=0, method="segment")),
                ("adaptive-2048", AdaptiveFlood(source=0, method="segment",
                                                k=2048))]),
            (cut, EXPECTED_BA_CUT, [
                ("skew-cut", Flood(source=0, method="skew")),
                ("segment-cut", Flood(source=0, method="segment"))])):
        seen = None
        for name, proto in contest:
            device_mod.SYNCS = 0
            state, out = engine.run_until_coverage(
                graph, proto, KEY, coverage_target=0.99, max_rounds=64)
            syncs = device_mod.SYNCS
            if out != expected:
                fail(f"BA {name} returned {out}, the reference gives "
                     f"{expected}")
            if seen is not None and not torch.equal(state.seen, seen):
                fail(f"BA {name}: final seen differs from {contest[0][0]}'s")
            seen = state.seen
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.run_until_coverage(graph, proto, KEY,
                                          coverage_target=0.99,
                                          max_rounds=64)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            print(json.dumps({
                "phase": "skew-path", "method": name, "syncs": syncs,
                "wall_s": sorted(times)[2], "wall_s_all": times,
                "profile": profile_run(lambda: engine.run_until_coverage(
                    graph, proto, KEY, coverage_target=0.99,
                    max_rounds=64))}),
                flush=True)


#: Phase 3c's draw sizes: around the kernel's 256-thread block and its 4
#: counters a thread, the restart draw of the walk rung (4,096), gossip's
#: 100,096, one past a wave of a counter a thread (132 SMs x 8 blocks of
#: 256), an odd count past 2**20, and ``N_PAD`` (each of SIR's two draws a
#: round at 1M); and a 2-D shape (row-major flat counters).
THREEFRY_SIZES = [1, 3, 31, 33, 255, 257, 4096, 100_096, 132 * 8 * 256 + 1,
                  2**20 + 7, N_PAD]
THREEFRY_SHAPE_2D = (1000, 1001)
#: Draws from a counter offset across 2**32 (two launches; the second
#: stores from 8 bytes past a 16-byte boundary).
THREEFRY_OFFSETS = [(2**32 - 6, 4103), (2**32 - 2**19, 2**20 + 3)]
#: The sizes phase 3c times: SIR's 1M draw, gossip's and the walk's.
THREEFRY_TIMED = [N_PAD, 100_096, 4096]
#: Per-lane issue rates of one H100 SXM at its 1,980 MHz boost clock
#: (the clock of the data sheet's f32 rate, ``VECTOR_OPS_PER_S``: 132 SMs
#: x 128 FP32 lanes x 2): the ALU pipe takes 64 lanes per SM per clock
#: (NVIDIA's Hopper architecture white paper: 64 INT32 units per SM), and
#: an SM issues 128 lanes' instructions per clock (4 schedulers x 32).
ALU_LANES_PER_S = 132 * 64 * 1.98e9
ISSUE_LANES_PER_S = 132 * 128 * 1.98e9
#: SASS opcodes by pipe, as phase 3c sorts the threefry loop: the value
#: ops only the ALU pipe takes (funnel shift, logic, min/max, a
#: shift-or), the adds (IADD3 on the ALU pipe, any IMAD on the FMA pipe),
#: the f32 ones (FMA pipe). ``alu_pipe`` and ``fma_pipe`` count every
#: instruction each pipe issues, the loop's own (compares, address
#: forms, moves) included; the rest (stores, branches) is neither.
SASS_ALU = ("SHF", "LOP3", "FMNMX", "LEA.HI")
SASS_ADD = ("IADD3", "IMAD")
SASS_FP = ("FADD", "FFMA", "FMUL")
SASS_ALU_PIPE = ("SHF", "LOP3", "FMNMX", "LEA", "IADD3", "ISETP", "SEL",
                 "MOV", "PRMT", "IMNMX", "IABS")
SASS_FMA_PIPE = ("IMAD",) + SASS_FP


def threefry_sass(build_mod, per_pass: int) -> dict:
    """The built threefry kernels' persistent loops, from ``cuobjdump
    -sass`` of the library: per entry, the opcode counts of one pass
    (``per_pass`` counters, one 16-byte store), their sums by
    ``SASS_ALU``/``SASS_ADD``/``SASS_FP`` and by pipe, and those sums per
    counter."""
    tool = Path(build_mod._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", build_mod.LAST_BUILD["path"]],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for func in text.split("Function : ")[1:]:
        name = func.split("\n", 1)[0]
        if "threefry_kernel" not in name or f"Li{per_pass}E" not in name:
            continue
        ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
            r"([^;]*);", func)]
        # The loop: from a backward branch's target to the branch, the one
        # that holds the 16-byte store.
        loops = [(int(t, 16), a) for a, op, rest in ins if op == "BRA"
                 for t in re.findall(r"0x([0-9a-f]+)", rest)
                 if int(t, 16) < a]
        start, end = next(
            (lo, hi) for lo, hi in loops
            if any(lo <= a <= hi and op.startswith("STG") and ".128" in op
                   for a, op, _ in ins))
        ops = collections.Counter(op for a, op, _ in ins
                                  if start <= a <= end)

        def total(names, values=True):
            # LEA.HI.X forms an address, not a value.
            return sum(n for op, n in ops.items()
                       if not (values and op == "LEA.HI.X") and
                       any(op == k or op.startswith(k + ".") for k in names))
        row = {"ops": dict(sorted(ops.items())), "all": sum(ops.values()),
               "alu_only": total(SASS_ALU), "adds": total(SASS_ADD),
               "fp": total(SASS_FP),
               "alu_pipe": total(SASS_ALU_PIPE, values=False),
               "fma_pipe": total(SASS_FMA_PIPE, values=False)}
        row["per_counter"] = {k: row[k] / per_pass for k in (
            "all", "alu_only", "adds", "fp", "alu_pipe", "fma_pipe")}
        out["uniform" if "ILb1E" in name else "bits"] = row
    if sorted(out) != ["bits", "uniform"]:
        fail(f"threefry kernels not found in the SASS: {sorted(out)}")
    return out


def launch_floor_ms(build_mod, flush) -> float:
    """Device ms of an empty kernel (``p2p_noop``) timed as
    :func:`cuda_times` times kernels: the part of a short kernel's time
    that no design of its body removes."""
    lib = build_mod.library()
    lib.p2p_noop.argtypes = [ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream

    def noop():
        rc = lib.p2p_noop(torch.cuda.current_device(), stream)
        if rc:
            fail(f"the empty kernel failed to launch: CUDA error {rc}")
    return cuda_times(noop, 50, flush)


def threefry_phase(prng, threefry, build_mod, flush):
    """Phase 3c: the threefry kernel against its plain version, bits and
    the f32 uniform epilogue (unit range and a general one), bit for bit,
    at ``THREEFRY_SIZES``, ``THREEFRY_OFFSETS`` and ``THREEFRY_SHAPE_2D``
    for three keys; then timed at ``THREEFRY_TIMED`` as phase 3 times
    kernels, beside the launch floor. Bound: the work's least
    instructions per counter (``threefry.ALU_OPS`` etc.) over the ALU
    pipe's rate for those only it takes, and over the issue rate for all;
    the built loop's SASS must hold at least those per counter. Returns
    the timed rows and the largest difference from the plain version (0
    or a failure)."""
    dev = torch.device("cuda")
    ranges = [(0.0, 1.0), (float(np.float32(-3.3)),
                           float(np.float32(7.1) - np.float32(-3.3)))]
    max_err = 0.0
    draws = [(n, 0) for n in THREEFRY_SIZES] + \
        [(n, off) for off, n in THREEFRY_OFFSETS]
    for k in (prng.key(0), prng.fold_in(prng.key(0), 1), prng.key(-1)):
        k0, k1 = int(k[0]), int(k[1])
        for n, off in draws:
            got = threefry.threefry_bits(k0, k1, n, dev, offset=off)
            want = threefry.threefry_bits_plain(k0, k1, n, dev, offset=off)
            if n:
                max_err = max(max_err, float(
                    (got.long() - want.long()).abs().max()))
            if not torch.equal(got, want):
                fail(f"threefry bits differ from the plain version "
                     f"(key {list(k)}, n={n}, offset={off})")
            for lo, scale in ranges:
                got = threefry.threefry_uniform(k0, k1, n, lo, scale, dev,
                                                offset=off)
                want = threefry.threefry_uniform_plain(k0, k1, n, lo, scale,
                                                       dev, offset=off)
                if n:
                    max_err = max(max_err, (got - want).abs().max().item())
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    fail(f"threefry uniform differs from the plain version "
                         f"(key {list(k)}, n={n}, offset={off}, "
                         f"minval={lo})")
        got = prng.random_bits(k, THREEFRY_SHAPE_2D, device=dev)
        want = threefry.threefry_bits_plain(
            k0, k1, got.numel(), dev).reshape(THREEFRY_SHAPE_2D)
        if not torch.equal(got, want):
            fail(f"threefry bits over {THREEFRY_SHAPE_2D} differ")
    torch.cuda.synchronize()
    sass = threefry_sass(build_mod, threefry.COUNTERS_PER_THREAD)
    floor_ms = launch_floor_ms(build_mod, flush)
    k = prng.key(0)
    k0, k1 = int(k[0]), int(k[1])
    rows = []
    for n in THREEFRY_TIMED:
        for entry, alu, other, kernel, plain in (
                ("bits", threefry.ALU_OPS, threefry.ADD_OPS,
                 lambda: threefry.threefry_bits(k0, k1, n, dev),
                 lambda: threefry.threefry_bits_plain(k0, k1, n, dev)),
                ("uniform", threefry.ALU_OPS + threefry.UNIFORM_ALU_OPS,
                 threefry.ADD_OPS + threefry.UNIFORM_FMA_OPS,
                 lambda: threefry.threefry_uniform(k0, k1, n, 0.0, 1.0, dev),
                 lambda: threefry.threefry_uniform_plain(k0, k1, n, 0.0,
                                                         1.0, dev))):
            built = sass[entry]["per_counter"]
            if built["alu_only"] < alu or built["alu_only"] + \
                    built["adds"] + built["fp"] < alu + other:
                fail(f"threefry {entry}: the built loop {sass[entry]} does "
                     f"less a counter than the bound counts ({alu} "
                     f"ALU-only, {alu + other} in all)")
            by_bytes = 1e3 * 4 * n / HBM_BYTES_PER_S
            by_alu = 1e3 * alu * n / ALU_LANES_PER_S
            by_issue = 1e3 * (alu + other) * n / ISSUE_LANES_PER_S
            by_ops = max(by_alu, by_issue)
            row = {"entry": entry, "n": n, "alu_ops_per_counter": alu,
                   "other_ops_per_counter": other,
                   "ms": cuda_times(kernel, 50, flush),
                   "plain_ms": cuda_times(plain, 10, flush),
                   "library_ms": None,
                   "bound_ms": max(by_bytes, by_ops),
                   "bound_by": "bytes" if by_bytes >= by_ops
                   else "operations",
                   "bytes_bound_ms": by_bytes, "alu_bound_ms": by_alu,
                   "issue_bound_ms": by_issue, "launch_floor_ms": floor_ms,
                   "back_to_back_ms": back_to_back_ms(kernel, 50),
                   "sass": sass[entry]}
            rows.append(row)
            print(json.dumps({"phase": "kernel-threefry", **row}),
                  flush=True)
    return rows, max_err


def counted(run, segsum, threefry, device_mod):
    """``run()`` once with every count set to 0 just before it; returns
    its result, its wall and the counts read just after."""
    from p2pnetwork_tpu_torch.ops import rowsum

    segsum.LAUNCHES = threefry.LAUNCHES = device_mod.SYNCS = 0
    rowsum.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = run()
    torch.cuda.synchronize()
    return result, {"first_run_s": time.perf_counter() - t0,
                    "segsum_launches": segsum.LAUNCHES,
                    "threefry_launches": threefry.LAUNCHES,
                    "rowsum_launches": rowsum.LAUNCHES,
                    "syncs": device_mod.SYNCS}


def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes."""
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def sir_path(g, engine, prng, segsum, threefry, device_mod, SIR) -> dict:
    """Phase 4e: the ladder's SIR rung (benchmarks/ladder.py,
    ``bench_sir_1m``) on phase 4's graph by ``engine.run``, under
    ``hybrid`` (B1's sum on the remainder) and ``pallas`` (B1's sum on the
    blocked layout). The ladder builds its graph without a neighbor table;
    phase 4's has one, which SIR's ``hybrid`` and ``pallas`` never read
    (they read the edges' layouts only), so the result is the same. Each
    must return ``EXPECTED_SIR`` exactly and launch B1's sum entry once a
    round and the threefry kernel twice. Returns the launches: B1's sum
    per method (layout), threefry over both runs."""
    launches = {"hybrid": 0, "pallas": 0, "threefry": 0}
    for method in ("hybrid", "pallas"):
        proto = SIR(method=method, **SIR_RUNG)
        run = lambda: engine.run(g, proto, KEY, SIR_ROUNDS)  # noqa: E731
        (state, stats), rec = counted(run, segsum, threefry, device_mod)
        got = {k: v.tolist() for k, v in stats.items()}
        got["status_sha256"] = digest(state.status)
        if got != EXPECTED_SIR:
            bad = sorted(k for k in EXPECTED_SIR if got.get(k) !=
                         EXPECTED_SIR[k])
            fail(f"SIR {method} differs from the reference in {bad}: "
                 f"{ {k: got.get(k) for k in bad} }")
        if rec["segsum_launches"] != SIR_ROUNDS:
            fail(f"SIR {method} launched B1's sum {rec['segsum_launches']} "
                 f"times in {SIR_ROUNDS} rounds")
        if rec["threefry_launches"] != 2 * SIR_ROUNDS:
            fail(f"SIR {method} launched threefry "
                 f"{rec['threefry_launches']} times in {SIR_ROUNDS} rounds")
        launches[method] += rec["segsum_launches"]
        launches["threefry"] += rec["threefry_launches"]
        timed = timed_runs(run)
        print(json.dumps({"phase": "sir-path", "method": method,
                          "rounds": SIR_ROUNDS, **rec, **timed,
                          "wall_per_round_ms":
                              1e3 * timed["wall_s"] / SIR_ROUNDS,
                          "final": {k: got[k][-1] for k in
                                    ("coverage", "s_frac", "i_frac",
                                     "r_frac")}}), flush=True)
    return launches


def assert_close(label, got, want, rtol, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.allclose(got, want, rtol=rtol,
                                                  atol=atol):
        fail(f"{label}: {got.tolist()} not within rtol={rtol}, atol={atol} "
             f"of the reference's {want.tolist()}")
    return float(np.abs(got - want).max())


def consensus_path(g, engine, prng, segsum, threefry, device_mod, PushSum,
                   PageRank) -> dict:
    """Phase 4f: push-sum (30 rounds by ``engine.run``) and PageRank (by
    ``run_until_converged`` to ``EXPECTED_PAGERANK``'s threshold) on
    phase 4's graph under ``hybrid``, B1's sum entry on arbitrary f32
    terms: two launches a round for push-sum, one for PageRank.
    ``messages`` and ``rounds`` exact, the sums within ``PUSHSUM_TOL`` /
    ``PAGERANK_TOL``; each line prints its largest difference from the
    reference. Returns the launches."""
    launches = {"segsum": 0, "threefry": 0}
    proto = PushSum(method="hybrid")
    run = lambda: engine.run(g, proto, KEY, PUSHSUM_ROUNDS)  # noqa: E731
    (state, stats), rec = counted(run, segsum, threefry, device_mod)
    if stats["messages"].tolist() != EXPECTED_PUSHSUM["messages"]:
        fail(f"push-sum messages {stats['messages'].tolist()}, the "
             f"reference gives {EXPECTED_PUSHSUM['messages']}")
    err = max(assert_close(f"push-sum {name}", stats[name].tolist(),
                           EXPECTED_PUSHSUM[name], rtol, atol)
              for name, (rtol, atol) in PUSHSUM_TOL.items())
    if (rec["segsum_launches"], rec["threefry_launches"]) != (
            2 * PUSHSUM_ROUNDS, 1):
        fail(f"push-sum launched B1's sum {rec['segsum_launches']} and "
             f"threefry {rec['threefry_launches']} times")
    launches["segsum"] += rec["segsum_launches"]
    launches["threefry"] += rec["threefry_launches"]
    print(json.dumps({"phase": "consensus-path", "protocol": "push-sum",
                      "rounds": PUSHSUM_ROUNDS, **rec, **timed_runs(run),
                      "max_abs_err_vs_reference": err,
                      "final": {k: stats[k][-1].item() for k in stats}}),
          flush=True)

    proto = PageRank(method="hybrid")
    thr = EXPECTED_PAGERANK["threshold"]
    run = lambda: engine.run_until_converged(  # noqa: E731
        g, proto, KEY, stat="residual", threshold=thr)
    (state, out), rec = counted(run, segsum, threefry, device_mod)
    rank_total = state.ranks.sum().item()
    for k in ("rounds", "messages"):
        if out[k] != EXPECTED_PAGERANK[k]:
            fail(f"PageRank {k} {out[k]}, the reference gives "
                 f"{EXPECTED_PAGERANK[k]}")
    err = max(assert_close("PageRank value", out["value"],
                           EXPECTED_PAGERANK["value"],
                           *PAGERANK_TOL["value"]),
              assert_close("PageRank rank_total", rank_total,
                           EXPECTED_PAGERANK["rank_total"],
                           *PAGERANK_TOL["rank_total"]))
    if rec["segsum_launches"] != out["rounds"] or rec["threefry_launches"]:
        fail(f"PageRank launched B1's sum {rec['segsum_launches']} times in "
             f"{out['rounds']} rounds, threefry {rec['threefry_launches']}")
    launches["segsum"] += rec["segsum_launches"]
    print(json.dumps({"phase": "consensus-path", "protocol": "pagerank",
                      "threshold": thr, **out, "rank_total": rank_total,
                      **rec, **timed_runs(run),
                      "max_abs_err_vs_reference": err}), flush=True)
    return launches


def gossip_path(engine, prng, base, threefry, segsum, device_mod, graph_mod,
                Gossip) -> int:
    """Phase 4g: the ladder's gossip rung (``bench_gossip_100k``): BA
    100K (``m = 4``, table capped at 128), ``Gossip(alpha=0.5)``, 30
    rounds. The first round's partners (sha256) and every round's
    ``messages`` exact, ``variance`` and ``mean`` within ``GOSSIP_TOL``.
    Returns the threefry launches (one normal draw, two bit draws a
    round)."""
    t0 = time.perf_counter()
    b = graph_mod.barabasi_albert(100_000, 4, seed=0, max_degree=128)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    first = prng.split(prng.fold_in(KEY, 1), GOSSIP_ROUNDS)[0]
    partners = digest(base.draw_neighbor_slot(b, first)[1])
    if partners != EXPECTED_GOSSIP["partners_sha256"]:
        fail("gossip's first-round partners differ from the reference's")
    proto = Gossip(alpha=0.5)
    run = lambda: engine.run(b, proto, KEY, GOSSIP_ROUNDS)  # noqa: E731
    (state, stats), rec = counted(run, segsum, threefry, device_mod)
    if stats["messages"].tolist() != EXPECTED_GOSSIP["messages"]:
        fail(f"gossip messages {stats['messages'].tolist()}, the reference "
             f"gives {EXPECTED_GOSSIP['messages']}")
    err = max(assert_close(f"gossip {name}", stats[name].tolist(),
                           EXPECTED_GOSSIP[name], rtol, atol)
              for name, (rtol, atol) in GOSSIP_TOL.items())
    if rec["threefry_launches"] != 1 + 2 * GOSSIP_ROUNDS:
        fail(f"gossip launched threefry {rec['threefry_launches']} times")
    print(json.dumps({"phase": "gossip-path", "build_s": build_s,
                      "rounds": GOSSIP_ROUNDS, **rec, **timed_runs(run),
                      "max_abs_err_vs_reference": err,
                      "final_variance": stats["variance"][-1].item()}),
          flush=True)
    return rec["threefry_launches"]


def latency(s, r):
    """The routing rung's link cost (``benchmarks/ladder.py``
    ``bench_routing``): an id hash of the endpoints, 1 to 3 in steps of
    1/1024, on the host arrays ``Graph.with_weights`` passes."""
    h = s.astype(np.uint32) * np.uint32(2654435761) + r.astype(np.uint32)
    return 1.0 + (h % 2048).astype(np.float32) / 1024.0


def check_run(label, got, want):
    """Fail unless ``got`` equals the reference's ``want``."""
    if got != want:
        bad = sorted(k for k in set(got) | set(want)
                     if got.get(k) != want.get(k))
        fail(f"{label} differs from the reference in {bad}: "
             f"{ {k: got.get(k) for k in bad} } (want "
             f"{ {k: want.get(k) for k in bad} })")


def timed_line(phase, name, run, rec, extra=None, reps=5):
    """Wall (median of ``reps``) and a profile of ``run``, printed with
    the checked run's counts ``rec`` and the script's time ``t_s``."""
    print(json.dumps({"phase": phase, "run": name, **rec, **(extra or {}),
                      **timed_runs(run, reps),
                      "t_s": time.perf_counter() - T_START}), flush=True)


def routing_path(g, engine, segsum, threefry, device_mod, graph_mod,
                 frontier_ops, DistanceVector):
    """Phase 4h: the ladder's weighted routing rung, then the same weights
    on phase 4's graph under ``gather`` and ``frontier`` and on the 1M BA
    rung under ``skew``; each must give ``EXPECTED_ROUTE`` (so the same
    ``dist`` bits on one graph whatever the method). Returns the weighted
    BA rung, which phase 4i's skew election reuses, and the weighted WS
    rung, phase 4m's graph."""
    t0 = time.perf_counter()
    rung = graph_mod.watts_strogatz(N_NODES, 10, 0.1, seed=0,
                                    build_neighbor_table=False)
    rung = rung.with_weights(latency)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ba = graph_mod.barabasi_albert(N_NODES, 5, seed=0,
                                   build_neighbor_table=False,
                                   source_csr=True, skew_table=True)
    ba = ba.with_weights(latency)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "routing-graph", "ws_build_s": build_s,
                      "ba_build_s": time.perf_counter() - t0,
                      "ws_edges": rung.n_edges, "ba_edges": ba.n_edges,
                      "ba_skew_width": ba.skew.width}), flush=True)
    gw = g.with_weights(latency)
    for name, graph, method, want in (
            ("rung-segment", rung, "segment", EXPECTED_ROUTE["ws"]),
            ("gather", gw, "gather", EXPECTED_ROUTE["ws"]),
            ("frontier", gw, "frontier", EXPECTED_ROUTE["ws"]),
            ("ba-skew", ba, "skew", EXPECTED_ROUTE["ba"])):
        proto = DistanceVector(source=0, method=method)
        run = lambda: engine.run_until_converged(  # noqa: E731
            graph, proto, KEY, stat="changed", threshold=1, max_rounds=256)
        frontier_ops.ROUNDS.update(sparse=0, dense=0)
        (state, out), rec = counted(run, segsum, threefry, device_mod)
        rec["frontier_rounds"] = dict(frontier_ops.ROUNDS)
        got = dict(out, dist_sha256=digest(state.dist),
                   parent_sha256=digest(state.parent),
                   next_hops_sha256=digest(proto.next_hops(graph, state)))
        check_run(f"routing {name}", got, want)
        if rec["segsum_launches"] or rec["threefry_launches"]:
            fail(f"routing {name} launched a kernel: {rec}")
        timed_line("routing-path", name, run, rec, {
            "method": method, "rounds": out["rounds"],
            "messages": out["messages"]})
    return ba, rung


def analytics_path(g, ba, engine, prng, segsum, threefry, device_mod,
                   models) -> dict:
    """Phase 4i: hop distance (plain and adaptive), diameter bounds,
    leader election, components, spanning tree, k-core, MIS and coloring
    at 1M, each equal to ``EXPECTED_ANALYTICS``, each kernel path
    launching its kernels. Returns the launches of B1's OR, its sum entry
    on the remainder and on the blocked layout, and threefry's."""
    M = models
    launches = {"or": 0, "sum": 0, "sum_blocked": 0, "threefry": 0}

    def conv(graph, proto, stat):
        return lambda: engine.run_until_converged(  # noqa: E731
            graph, proto, KEY, stat=stat, threshold=1, max_rounds=256)

    # (name, run, expected entry, state field hashed, launches it must
    # make: {launch key: exact count, or None for more than 0}).
    kcore_rounds = EXPECTED_ANALYTICS["kcore"]["rounds"]
    mis_rounds = EXPECTED_ANALYTICS["mis"]["rounds"]
    runs = [
        ("hop-hybrid", conv(g, M.HopDistance(source=0, method="hybrid"),
                            "frontier"), "hop", "dist",
         {"or": EXPECTED_ANALYTICS["hop"]["rounds"]}),
        ("adaptive-hop-1024", conv(g, M.AdaptiveHopDistance(
            source=0, method="hybrid", k=1024), "frontier"), "adaptive_hop",
         "dist",
         {"or": None}),
        ("leader-gather", conv(g, M.LeaderElection(method="gather"),
                               "changed"), "leader", "known", {}),
        ("leader-ba-skew", conv(ba, M.LeaderElection(method="skew"),
                                "changed"), "leader_ba", "known", {}),
        ("components-gather", conv(g, M.ConnectedComponents(
            method="gather"), "changed"), "components", "label", {}),
        ("spanning-gather", conv(g, M.SpanningTree(source=0,
                                                   method="gather"),
                                 "frontier"), "spanning", "parent", {}),
        ("kcore-hybrid", conv(g, M.KCore(k=KCORE_K, method="hybrid"),
                              "removed"), "kcore", "in_core",
         {"sum": kcore_rounds}),
        ("kcore-pallas", conv(g, M.KCore(k=KCORE_K, method="pallas"),
                              "removed"), "kcore", "in_core",
         {"sum_blocked": kcore_rounds}),
        ("mis-gather-hybrid", conv(g, M.LubyMIS(method="gather",
                                                or_method="hybrid"),
                                   "undecided"), "mis", "in_mis",
         {"or": mis_rounds, "threefry": 2 * mis_rounds}),
    ]
    for name, run, key, field, must in runs:
        (state, out), rec = counted(run, segsum, threefry, device_mod)
        got = dict(out, sha256=digest(getattr(state, field)))
        check_run(f"analytics {name}", got, EXPECTED_ANALYTICS[key])
        n_b1 = rec["segsum_launches"]
        counts = {"or": 0, "sum": 0, "sum_blocked": 0,
                  "threefry": rec["threefry_launches"]}
        entry = next((e for e in ("or", "sum", "sum_blocked") if e in must),
                     None)
        if entry:
            counts[entry] = n_b1
        elif n_b1:
            fail(f"analytics {name} launched B1 {n_b1} times")
        for k, n in must.items():
            if counts[k] == 0 or (n is not None and counts[k] != n):
                fail(f"analytics {name}: {counts[k]} launches of {k}, "
                     f"want {n if n is not None else '> 0'}")
        if "threefry" not in must and counts["threefry"]:
            fail(f"analytics {name} launched threefry")
        for k in launches:
            launches[k] += counts[k]
        timed_line("analytics-path", name, run, rec,
                   {"rounds": out["rounds"], "messages": out["messages"]})

    # diameter_bounds: 16 BFS waves from live nodes drawn by
    # prng.choice (two rounds of threefry bits over the 1M live ids).
    run = lambda: M.diameter_bounds(g, KEY, samples=16,  # noqa: E731
                                    method="hybrid")
    got, rec = counted(run, segsum, threefry, device_mod)
    check_run("analytics diameter", got, EXPECTED_ANALYTICS["diameter"])
    if rec["segsum_launches"] == 0 or rec["threefry_launches"] != 2:
        fail(f"diameter_bounds launched B1 {rec['segsum_launches']} and "
             f"threefry {rec['threefry_launches']} times")
    launches["or"] += rec["segsum_launches"]
    launches["threefry"] += rec["threefry_launches"]
    timed_line("analytics-path", "diameter-bounds-16", run, rec, got)

    # color_via_mis: a LubyMIS run (gather, two bit draws a round) per
    # color class.
    run = lambda: M.color_via_mis(g, KEY)  # noqa: E731
    (colors, n_colors), rec = counted(run, segsum, threefry, device_mod)
    got = {"n_colors": n_colors, "sha256": digest(colors)}
    check_run("analytics coloring", got, EXPECTED_ANALYTICS["coloring"])
    if rec["segsum_launches"] or rec["threefry_launches"] < 2 * n_colors:
        fail(f"color_via_mis launched B1 {rec['segsum_launches']} and "
             f"threefry {rec['threefry_launches']} times")
    launches["threefry"] += rec["threefry_launches"]
    timed_line("analytics-path", "color-via-mis", run, rec, got)
    return launches


def lane_summary(out, extra=()) -> dict:
    """The checked part of a batched run's dict: its numbers and the
    sha256s of its per-lane vectors (``extra`` names more of them)."""
    got = {k: out.get(k) for k in (
        "rounds", "completed", "active_lanes", "messages", "occupancy_mean",
        "completion_rounds_p50", "completion_rounds_p99")}
    for k in ("lane_done", "lane_rounds", *extra):
        got[f"{k}_sha256"] = hashlib.sha256(
            np.ascontiguousarray(out[k]).tobytes()).hexdigest()
    return got


def no_launch(label, rec, **want):
    """Fail unless B1, threefry and the row sum launched as ``want`` says:
    an exact count, or None for more than 0 (absent: 0)."""
    for key, counter in (("segsum", "segsum_launches"),
                         ("threefry", "threefry_launches"),
                         ("rowsum", "rowsum_launches")):
        n, w = rec[counter], want.get(key, 0)
        if (w is None and n == 0) or (w is not None and n != w):
            fail(f"{label} launched {key} {n} times, want "
                 f"{'> 0' if w is None else w}")


def batch_path(engine, segsum, threefry, device_mod, graph_mod,
               frontier_ops, Flood, MB):
    """Phase 4j: bench.py's batched column at its width, B = 1,024 floods
    on the 100K WS class by each method, equal to ``EXPECTED_BATCH``; 4
    lanes against single ``Flood`` runs of the port, timed as
    ``time_batch_flood`` times them; then the second admit wave."""
    t0 = time.perf_counter()
    g = graph_mod.watts_strogatz(BATCH_N, 10, 0.1, seed=0, source_csr=True)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "batch-graph",
                      "build_s": time.perf_counter() - t0,
                      "n_pad": g.n_nodes_padded, "e_pad": g.n_edges_padded,
                      "table": list(g.neighbors.shape),
                      "budget_slots_lanes": frontier_ops.budget_slots_lanes(
                          g, None, BATCH_B // 32)}), flush=True)
    rng = np.random.default_rng(0)
    sources = rng.integers(0, g.n_nodes, size=BATCH_B).astype(np.int32)
    second = rng.integers(0, g.n_nodes, size=BATCH_B).astype(np.int32)
    walls = {}
    for method in BATCH_METHODS:
        proto = MB.BatchFlood(method=method)
        run = lambda: engine.run_batch_until_coverage(  # noqa: E731
            g, proto, proto.init(g, sources, coverage_target=0.99), KEY,
            max_rounds=64)
        frontier_ops.ROUNDS.update(sparse=0, dense=0)
        (state, out), rec = counted(run, segsum, threefry, device_mod)
        rec["frontier_rounds"] = dict(frontier_ops.ROUNDS)
        out["lane_messages"] = MB.lane_messages(g, state).cpu().numpy()
        out["seen"] = state.seen.cpu().numpy()
        check_run(f"batch {method}", lane_summary(
            out, ("lane_messages", "seen")), EXPECTED_BATCH["first"])
        no_launch(f"batch {method}", rec)
        timed = timed_runs(run)
        walls[method] = timed["wall_s"]
        print(json.dumps({"phase": "batch-path", "run": method, **rec,
                          **timed, "rounds": out["rounds"],
                          "messages": out["messages"],
                          "lanes": BATCH_B}), flush=True)
        if method == "auto":
            first = state

    # Four lanes against the port's single floods from their sources,
    # timed as time_batch_flood times its sequential sample: one untimed
    # run, then one timed, each.
    seq = []
    for lane, src in enumerate(sources[:BATCH_SAMPLE]):
        proto = Flood(source=int(src))
        single = lambda: engine.run_until_coverage(  # noqa: E731
            g, proto, KEY, coverage_target=0.99, max_rounds=64)
        state, _ = single()
        if not torch.equal(MB.lane_seen(first, lane), state.seen):
            fail(f"batch lane {lane} (source {src}) differs from its "
                 f"single flood")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single()
        torch.cuda.synchronize()
        seq.append(time.perf_counter() - t0)
    seq_per_run = sum(seq) / len(seq)
    print(json.dumps({"phase": "batch-vs-sequential",
                      "sample_sources": sources[:BATCH_SAMPLE].tolist(),
                      "seq_per_run_s": seq_per_run,
                      "seq_estimate_s": seq_per_run * BATCH_B,
                      "batched_wall_s": walls["auto"],
                      "aggregate_speedup_vs_sequential":
                          seq_per_run * BATCH_B / walls["auto"]}),
          flush=True)

    # The serving seam: every lane retired, the next 1,024 admitted.
    proto = MB.BatchFlood(method="auto")
    wave, lanes = proto.admit(g, proto.retire(first), second,
                              coverage_target=0.99)
    if MB.free_lane_count(wave) != 0 or lanes.tolist() != list(
            range(BATCH_B)):
        fail("batch: the second wave did not take every lane")
    run = lambda: engine.run_batch_until_coverage(  # noqa: E731
        g, proto, wave, KEY, max_rounds=64)
    (state, out), rec = counted(run, segsum, threefry, device_mod)
    out["lane_messages"] = MB.lane_messages(g, state).cpu().numpy()
    out["seen"] = state.seen.cpu().numpy()
    check_run("batch second wave", lane_summary(
        out, ("lane_messages", "seen")), EXPECTED_BATCH["second_wave"])
    no_launch("batch second wave", rec)
    timed_line("batch-path", "auto-second-wave", run, rec, {
        "rounds": out["rounds"], "messages": out["messages"],
        "lanes": BATCH_B})
    return g


def query_path(g, engine, segsum, threefry, device_mod, graph_mod, QB):
    """Phase 4k: bench.py's query column at its widths on phase 4j's
    graph — min-plus (K = 64, ``auto`` and ``segment``), push-sum (K = 32)
    — and DHT lookups (K = 2,048) on ``chord(100_000)`` and
    ``kademlia(100_000)``, each equal to ``EXPECTED_QUERIES`` (push-sum's
    answers within ``PUSHSUM_QUERY_TOL``). Each timed run admits its
    batch, as the bench's."""
    rng = np.random.default_rng(0)
    srcs = rng.integers(0, g.n_nodes, 64).astype(np.int32)
    tgts = rng.integers(0, g.n_nodes, 64).astype(np.int32)
    seeds = (np.arange(32) * 7 + 1).astype(np.int32)
    orgs = rng.integers(0, BATCH_N, 2048).astype(np.int32)
    keys = rng.integers(0, BATCH_N, 2048).astype(np.int32)

    def check(name, graph, proto, make, max_rounds, draws=0):
        run = lambda: engine.run_queries_until_done(  # noqa: E731
            graph, proto, make(), KEY, max_rounds=max_rounds)
        (_, out), rec = counted(run, segsum, threefry, device_mod)
        if name == "pushsum":
            got = lane_summary(out)
            del got["lane_rounds_sha256"]
            got["lane_rounds"] = out["lane_rounds"].tolist()
            rec["max_abs_err"] = assert_close(
                "pushsum lane_values", out["lane_values"],
                EXPECTED_PUSHSUM_VALUES, *PUSHSUM_QUERY_TOL)
        else:
            got = lane_summary(out, ("lane_values",))
            if name.startswith("dht"):
                got["found"] = int((out["lane_values"] == keys).sum())
        check_run(f"queries {name}", got, EXPECTED_QUERIES[name])
        no_launch(f"queries {name}", rec, threefry=draws)
        timed_line("query-path", name, run, rec, {
            "rounds": out["rounds"], "messages": out["messages"],
            "lanes": int(out["lane_done"].size)})

    for method in ("auto", "segment"):
        mp = QB.MinPlusQueries(method)
        check(f"minplus-{method}", g, mp, lambda: mp.init(g, srcs, tgts),
              256)
    # The seed fields: one normal draw (a threefry launch) per lane.
    ps = QB.PushSumQueries("auto")
    check("pushsum", g, ps, lambda: ps.init(g, seeds, threshold=1e-4), 512,
          draws=len(seeds))
    for name, metric, build in (("dht-chord-ring", "ring", graph_mod.chord),
                                ("dht-kademlia-xor", "xor",
                                 graph_mod.kademlia)):
        t0 = time.perf_counter()
        gd = build(BATCH_N)
        torch.cuda.synchronize()
        print(json.dumps({"phase": "query-graph", "graph": name,
                          "build_s": time.perf_counter() - t0,
                          "table": list(gd.neighbors.shape)}), flush=True)
        dht = QB.DhtLookups(metric=metric)
        check(name, gd, dht, lambda: dht.init(gd, orgs, keys), 128)
        del gd
        torch.cuda.empty_cache()


#: Timed repeats of the phases new in slice 7 (5 in the earlier ones), to
#: keep the script's time.
NEW_REPS = 3


def f32_bits(x: float) -> int:
    """The bit pattern of ``x`` as an f32."""
    return int(np.float32(x).view(np.int32))


def graph_digest(g) -> str:
    """sha256 over every field of a graph of either package (tensors or
    JAX arrays), by sorted field name: array dtype, shape and bytes (packed
    ``uint32`` words as ``int32``), static values by ``repr``, nested
    layouts field by field."""
    h = hashlib.sha256()

    def put(name, v):
        if v is None or isinstance(v, (bool, int, float, str)):
            h.update(f"{name}={v!r};".encode())
        elif isinstance(v, tuple):
            h.update(f"{name}={tuple(int(x) for x in v)!r};".encode())
        elif dataclasses.is_dataclass(v):
            for f in sorted(f.name for f in dataclasses.fields(v)):
                put(f"{name}.{f}", getattr(v, f))
        else:
            a = (v.cpu().numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v))
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            h.update(f"{name}:{a.dtype}{list(a.shape)};".encode())
            h.update(np.ascontiguousarray(a).tobytes())

    put("graph", g)
    return h.hexdigest()


def discovery_path(g, engine, segsum, threefry, device_mod,
                   RandomWalks) -> int:
    """Phase 4l: the ladder's discovery rung on phase 4's graph at one and
    32 steps per super-step (bit-equal: the freeze rule), then with
    ``restart_p=0.02``; each equal to ``EXPECTED_WALK``. Only the restart
    draws a random number (one ``uniform`` per step, frozen sub-steps
    too). Returns the threefry launches."""
    launches = 0
    for name, T, restart_p, want in (
            ("walk-T1", 1, 0.0, EXPECTED_WALK["plain"]),
            ("walk-T32", 32, 0.0, EXPECTED_WALK["plain"]),
            ("walk-restart-T32", 32, 0.02, EXPECTED_WALK["restart"])):
        proto = RandomWalks(n_walkers=WALKERS, restart_p=restart_p)
        run = lambda: engine.run_until_coverage(  # noqa: E731
            g, proto, KEY, coverage_target=0.99, max_rounds=8192,
            steps_per_round=T)
        (state, out), rec = counted(run, segsum, threefry, device_mod)
        check_run(f"discovery {name}", dict(
            out, coverage_bits=f32_bits(out["coverage"]),
            visited_sha256=digest(state.visited),
            pos_sha256=digest(state.pos)), want)
        steps = -(-out["rounds"] // T) * T  # sub-steps, frozen ones too
        no_launch(f"discovery {name}", rec,
                  threefry=steps if restart_p else 0)
        launches += rec["threefry_launches"]
        timed_line("discovery-path", name, run, rec, {
            "steps_per_round": T, "rounds": out["rounds"],
            "messages": out["messages"]}, reps=NEW_REPS)
    return launches


def plumtree_path(rung, engine, segsum, threefry, device_mod, M) -> None:
    """Phase 4m: the ladder's Plumtree rung on phase 4h's WS rung: the
    first broadcast, the tree's extraction (host seconds printed) and a
    flood over it, then a second broadcast over the learned tree; each
    equal to ``EXPECTED_PLUMTREE``. No kernel runs."""
    p = M.Plumtree(source=0)
    st0 = p.init(rung, KEY)

    def broadcast(label, state, want):
        run = lambda: p.step(rung, state, KEY)  # noqa: E731
        (st, stats), rec = counted(run, segsum, threefry, device_mod)
        got = {n: v.item() for n, v in stats.items()}
        got["coverage"] = f32_bits(got["coverage"])
        got["eager_sha256"] = digest(st.eager)
        check_run(f"plumtree {label}", got, want)
        no_launch(f"plumtree {label}", rec)
        timed_line("plumtree-path", label, run, rec, {
            "messages": got["messages"], "duplicates": got["duplicates"]},
            reps=NEW_REPS)
        return st

    st1 = broadcast("first-broadcast", st0, EXPECTED_PLUMTREE["first"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tg = p.tree_graph(rung, st1, source_csr=True)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    if tg.n_edges != EXPECTED_PLUMTREE["tree_edges"] or \
            tg.edge_weight is None:
        fail(f"plumtree tree has {tg.n_edges} edges (weights "
             f"{tg.edge_weight is not None})")
    run = lambda: engine.run_until_coverage(  # noqa: E731
        tg, M.Flood(source=0), KEY, coverage_target=1.0, max_rounds=256)
    (_, out), rec = counted(run, segsum, threefry, device_mod)
    check_run("plumtree tree flood", out, EXPECTED_PLUMTREE["tree_flood"])
    no_launch("plumtree tree flood", rec)
    timed_line("plumtree-path", "tree-flood", run, rec, {
        "extract_s": extract_s, "tree_edges": tg.n_edges,
        "rounds": out["rounds"], "messages": out["messages"]},
        reps=NEW_REPS)
    broadcast("second-broadcast", st1, EXPECTED_PLUMTREE["second"])


def summary(x: torch.Tensor) -> dict:
    """The sum (f64), max and ``LIB_SAMPLE`` entries of a float node
    vector."""
    return {"sum": x.double().sum().item(), "max": x.max().item(),
            "sample": x[torch.from_numpy(LIB_SAMPLE).to(x.device)].tolist()}


def check_floats(label, got: dict, entry: str) -> float:
    """Each float of ``got`` within the tolerance of
    ``EXPECTED_LIBRARY_FLOATS[entry]``; returns the largest relative
    difference."""
    (rtol, atol), want = EXPECTED_LIBRARY_FLOATS[entry]
    worst = 0.0
    for k, w in want.items():
        assert_close(f"{label} {k}", got[k], w, rtol, atol)
        gv, wv = np.asarray(got[k], np.float64), np.asarray(w, np.float64)
        worst = max(worst, float((np.abs(gv - wv)
                                  / np.maximum(np.abs(wv), 1e-30)).max()))
    return worst


def symmetric_latency(s, r):
    """The routing rung's latency of the sorted endpoint pair: the same
    cost both ways, as Borůvka's minimality needs."""
    return latency(np.minimum(s, r), np.maximum(s, r))


def library_path(g, engine, prng, segsum, threefry, device_mod, M) -> dict:
    """Phase 4n: Bracha (``hybrid``, ``pallas``), HITS (``hybrid``),
    closeness and betweenness (``hybrid``), label propagation and the
    bipartiteness check (``gather``), the triangle counts, Borůvka and
    Vivaldi on the symmetric latency, the failure detector and
    anti-entropy on phase 4c's failures — on phase 4's graph at 1M, each
    against ``EXPECTED_LIBRARY`` (and ``EXPECTED_LIBRARY_FLOATS`` within
    their tolerances), each kernel path launching its kernels. Returns the
    launches of B1's OR entry, its sum entry on the remainder and on the
    blocked layout, and threefry's."""
    from p2pnetwork_tpu_torch.models import centrality, triangles
    from p2pnetwork_tpu_torch.sim import failures

    launches = {"or": 0, "sum": 0, "sum_blocked": 0, "threefry": 0}
    want = EXPECTED_LIBRARY

    def conv(graph, proto, stat, threshold=1, max_rounds=256, key=KEY):
        return lambda: engine.run_until_converged(  # noqa: E731
            graph, proto, key, stat=stat, threshold=threshold,
            max_rounds=max_rounds)

    def record(name, run, rec, entry, extra):
        """Add the run's launches (B1's to ``entry``) and print its
        timed line."""
        if entry:
            launches[entry] += rec["segsum_launches"]
        launches["threefry"] += rec["threefry_launches"]
        timed_line("library-path", name, run, rec, extra, reps=NEW_REPS)

    # Bracha: two sums at init, four a round (ECHO and READY per value).
    for method, entry in (("hybrid", "sum"), ("pallas", "sum_blocked")):
        run = conv(g, M.Bracha(method=method, **BRACHA), "changed")
        (s, out), rec = counted(run, segsum, threefry, device_mod)
        check_run(f"library bracha-{method}", dict(
            out, value_sha256=digest(s.value),
            echo_sha256=digest(s.echo_sent),
            ready_sha256=digest(s.ready_sent)), want["bracha"])
        no_launch(f"bracha {method}", rec, segsum=2 + 4 * out["rounds"])
        record(f"bracha-{method}", run, rec, entry, {
            "rounds": out["rounds"], "messages": out["messages"]})

    run = lambda: engine.run_until_converged(  # noqa: E731
        g, M.HITS(method="hybrid"), KEY, stat="residual",
        threshold=HITS_THRESHOLD)
    (s, out), rec = counted(run, segsum, threefry, device_mod)
    check_run("library hits", {k: out[k] for k in ("rounds", "messages")},
              want["hits"])
    hub, auth = summary(s.hub), summary(s.authority)
    err = check_floats("hits", {
        "hub_sum": hub["sum"], "hub_max": hub["max"],
        "hub_sample": hub["sample"], "authority_sum": auth["sum"],
        "authority_sample": auth["sample"]}, "hits")
    no_launch("hits", rec, segsum=out["rounds"])
    record("hits-hybrid", run, rec, "sum", {
        "rounds": out["rounds"], "residual": out["value"],
        "max_rel_err_vs_reference": err})

    for name, fn, entry in (("closeness", centrality.closeness_sample, "or"),
                            ("betweenness", centrality.betweenness_sample,
                             "sum")):
        run = lambda: fn(g, LIB_SOURCES, "hybrid")  # noqa: E731
        x, rec = counted(run, segsum, threefry, device_mod)
        err = check_floats(name, summary(x), name)
        no_launch(name, rec, segsum=None)
        record(f"{name}-hybrid-8", run, rec, entry,
               {"max_rel_err_vs_reference": err})

    run = conv(g, M.LabelPropagation(), "unsettled", max_rounds=1024)
    (s, out), rec = counted(run, segsum, threefry, device_mod)
    check_run("library labelprop", dict(out, sha256=digest(s.label)),
              want["labelprop"])
    no_launch("labelprop", rec)
    record("labelprop-gather", run, rec, None, {
        "rounds": out["rounds"], "messages": out["messages"]})

    bp = M.BipartiteCheck(method="gather")
    run = conv(g, bp, "changed")
    (s, out), rec = counted(run, segsum, threefry, device_mod)
    check_run("library bipartite", dict(
        out, label_sha256=digest(s.label), dist_sha256=digest(s.dist),
        odd_edges=bp.odd_edges(g, s).item(),
        component_sha256=digest(bp.component_bipartite(g, s))),
        want["bipartite"])
    no_launch("bipartite", rec)
    record("bipartite-gather", run, rec, None, {
        "rounds": out["rounds"], "messages": out["messages"]})

    run = lambda: {  # noqa: E731
        "triangles": triangles.count_triangles(g),
        "transitivity_sample": triangles.transitivity_sample(g, KEY,
                                                             65536)}
    got, rec = counted(run, segsum, threefry, device_mod)
    check_run("library triangles", got, want["triangles"])
    no_launch("triangles", rec, threefry=6)  # three randints, two draws each
    record("triangles", run, rec, None, got)

    gw = g.with_weights(symmetric_latency)
    run = conv(gw, M.Boruvka(), "changed", max_rounds=64)
    (s, out), rec = counted(run, segsum, threefry, device_mod)
    check_run("library boruvka", dict(
        out, mst_edges=s.mst_edge.sum().item(), comp_sha256=digest(s.comp),
        mst_edge_sha256=digest(s.mst_edge)), want["boruvka"])
    err = check_floats("boruvka", {"mst_weight": s.mst_weight.item()},
                       "boruvka")
    no_launch("boruvka", rec)
    record("boruvka", run, rec, None, {
        "rounds": out["rounds"], "mst_weight": s.mst_weight.item(),
        "max_rel_err_vs_reference": err})

    viv = M.Vivaldi(dim=2)
    run = lambda: engine.run(gw, viv, KEY, VIVALDI_ROUNDS)  # noqa: E731
    (s, stats), rec = counted(run, segsum, threefry, device_mod)
    if stats["messages"].tolist() != want["vivaldi_messages"]:
        fail(f"vivaldi messages {stats['messages'].tolist()}")
    live = gw.edge_mask
    a, b = gw.senders[live][:VIVALDI_EDGES], gw.receivers[live][:VIVALDI_EDGES]
    w = gw.edge_weight[live][:VIVALDI_EDGES]
    med = float(np.median(((viv.predicted(s, a, b) - w).abs() / w)
                          .cpu().numpy()))
    err = check_floats("vivaldi", {"median_rel_err": med}, "vivaldi")
    no_launch("vivaldi", rec, threefry=1 + 2 * VIVALDI_ROUNDS)
    record("vivaldi-30", run, rec, None, {
        "median_rel_err": med, "rmse_last": stats["rmse"][-1].item(),
        "max_rel_err_vs_reference": err})

    gm = failures.mark_unresponsive(g, DEAD)
    run = conv(gm, M.FailureDetector(threshold=3, loss_prob=0.05),
               "undetected", max_rounds=4096, key=prng.key(1))
    (s, out), rec = counted(run, segsum, threefry, device_mod)
    check_run("library detector", dict(
        out, declared_sha256=digest(s.declared),
        suspicion_sha256=digest(s.suspicion)), want["detector"])
    no_launch("detector", rec, threefry=4 * out["rounds"])
    record("detector", run, rec, None, {
        "rounds": out["rounds"], "messages": out["messages"]})

    gf = failures.fail_nodes(g, DEAD)
    run = conv(gf, M.AntiEntropy(n_items=64), "missing", max_rounds=4096,
               key=prng.key(2))
    (s, out), rec = counted(run, segsum, threefry, device_mod)
    check_run("library antientropy", dict(out, have_sha256=digest(s.have)),
              want["antientropy"])
    no_launch("antientropy", rec, threefry=1 + 2 * out["rounds"])
    record("antientropy-64", run, rec, None, {
        "rounds": out["rounds"], "messages": out["messages"]})
    return launches


def churn_delta(g, graph_mod, rng):
    """Phase 4p's churn epoch: ``DELTA_PAIRS`` live undirected pairs
    removed, as many random pairs (no self-loop) added, both directions
    stored (``GraphDelta.undirected``). Returns the delta and the merged
    edge list of the equivalence contract (kept + adds). ``g`` is
    pristine: its live edges are its first ``n_edges``."""
    s = g.senders[:g.n_edges].cpu().numpy()
    r = g.receivers[:g.n_edges].cpu().numpy()
    fwd = np.flatnonzero(s < r)
    pick = rng.choice(fwd, DELTA_PAIRS, replace=False)
    a = rng.integers(0, g.n_nodes, DELTA_PAIRS)
    b = (a + rng.integers(1, g.n_nodes, DELTA_PAIRS)) % g.n_nodes
    delta = graph_mod.GraphDelta.undirected(
        add_senders=a, add_receivers=b, remove_senders=s[pick],
        remove_receivers=r[pick])
    keys = (r.astype(np.int64) << 32) | s
    gone = ((delta.remove_receivers.astype(np.int64) << 32)
            | delta.remove_senders)
    keep = ~np.isin(keys, gone)
    merged = (np.concatenate([s[keep], delta.add_senders]),
              np.concatenate([r[keep], delta.add_receivers]))
    return delta, merged


def host_timed(fn):
    """``fn()`` and its wall seconds, the device drained at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_graph(label, gr, want_sha):
    got = graph_digest(gr)
    if got != want_sha:
        fail(f"{label}: the graph's arrays differ from the reference's "
             f"(sha256 {got}, want {want_sha})")


def flood_check(label, gr, method, want, engine, segsum, threefry,
                device_mod, Flood):
    """A counted ``Flood(method)`` run to 0.99 on ``gr``: its dict and the
    sha256 of its final ``seen`` must equal ``want``'s, and B1 must
    launch. Returns the counts and the timed walls."""
    proto = Flood(source=0, method=method)
    run = lambda: engine.run_until_coverage(  # noqa: E731
        gr, proto, KEY, coverage_target=0.99, max_rounds=64)
    (state, out), rec = counted(run, segsum, threefry, device_mod)
    out["seen_sha256"] = digest(bool_seen(state, gr.n_nodes_padded))
    expected = {k: want[k] for k in out}
    if out != expected:
        fail(f"{label} {method} returned {out}, the reference gives "
             f"{expected}")
    if rec["segsum_launches"] == 0:
        fail(f"{label} {method} never launched the segment-sum kernel")
    return rec, timed_runs(run, NEW_REPS)


def state_io_path(g, seen, engine, prng, segsum, threefry, device_mod,
                  graph_mod, Flood, SIR, ckpt, flightrec, layoutcache,
                  telemetry):
    """Phase 4p: on phase 4's graph, a churn epoch applied incrementally
    (``donate`` off, then on a copy in the rolling form), floods on the
    rebuilt layouts, growth by ``GROW_NODES`` wired by a delta, the flight
    recorder on phase 4's hybrid flood, checkpoints cut mid-run and
    resumed (the flood and SIR), and the graph file and layout cache.
    Every check is against ``EXPECTED_4P``. Returns B1's launches (OR
    entry: the floods; sum entry: SIR) and threefry's."""
    want = EXPECTED_4P
    launches = {"or": 0, "sum": 0, "threefry": 0}
    cov = dict(coverage_target=0.99, max_rounds=64)
    rng = np.random.default_rng(DELTA_SEED)

    # The churn epoch.
    delta, merged = churn_delta(g, graph_mod, rng)
    gd, apply_s = host_timed(lambda: graph_mod.apply_delta(g, delta))
    phases = graph_mod.last_build_phases()
    check_graph("4p apply_delta", gd, want["delta"]["graph_sha256"])
    base = dataclasses.replace(g, **{n: getattr(g, n).clone() for n in (
        "neighbors", "neighbor_mask", "in_degree", "out_degree")})
    rolled, donate_s = host_timed(
        lambda: graph_mod.apply_delta(base, delta, donate=True))
    check_graph("4p apply_delta(donate=True)", rolled,
                want["delta"]["graph_sha256"])
    del base, rolled
    fresh, from_edges_s = host_timed(lambda: graph_mod.from_edges(
        *merged, g.n_nodes, blocked=True, hybrid=True, source_csr=True))
    check_graph("4p from_edges of the merged list", fresh,
                want["delta"]["graph_sha256"])
    del fresh
    print(json.dumps({
        "phase": "state-io", "part": "delta", "removed": delta.n_removes,
        "added": delta.n_adds, "n_edges": gd.n_edges,
        "apply_delta_s": apply_s, "apply_delta_donate_s": donate_s,
        "from_edges_s": from_edges_s, "apply_delta_phases": phases,
        "hybrid_remainder": list(gd.hybrid.remainder.src.shape),
        "blocked": list(gd.blocked.src.shape)}), flush=True)
    for method in ("hybrid", "pallas"):
        rec, timed = flood_check("4p delta", gd, method, want["delta"],
                                 engine, segsum, threefry, device_mod, Flood)
        launches["or"] += rec["segsum_launches"]
        print(json.dumps({"phase": "state-io", "part": "delta-flood",
                          "method": method, **rec, **timed}), flush=True)

    # Growth, twice by GROW_NODES: the first fills the capacity (64 free
    # ids; the hybrid layout alone is rebuilt), the second doubles it; the
    # new nodes are then wired by a delta.
    gg, grow_s = host_timed(lambda: graph_mod.grow(
        graph_mod.grow(gd, GROW_NODES), GROW_NODES))
    new = np.arange(g.n_nodes, g.n_nodes + 2 * GROW_NODES)
    peers = rng.integers(0, g.n_nodes, new.size * GROW_FANOUT)
    wire = graph_mod.GraphDelta.undirected(
        add_senders=np.repeat(new, GROW_FANOUT), add_receivers=peers)
    gw, wire_s = host_timed(
        lambda: graph_mod.apply_delta(gg, wire, donate=True))
    del gg, gd
    if gw.n_nodes_padded != want["grow"]["n_pad"]:
        fail(f"4p grow: capacity {gw.n_nodes_padded}, want "
             f"{want['grow']['n_pad']}")
    check_graph("4p grow + wiring", gw, want["grow"]["graph_sha256"])
    rec, timed = flood_check("4p grown", gw, "hybrid", want["grow"], engine,
                             segsum, threefry, device_mod, Flood)
    launches["or"] += rec["segsum_launches"]
    print(json.dumps({"phase": "state-io", "part": "grow-flood",
                      "method": "hybrid", "grow_s": grow_s,
                      "wire_s": wire_s, "n_pad": gw.n_nodes_padded,
                      "hybrid_remainder":
                          list(gw.hybrid.remainder.src.shape),
                      **rec, **timed}), flush=True)
    del gw
    torch.cuda.empty_cache()

    # The flight recorder on phase 4's hybrid flood: 11 rounds in an
    # 8-row ring, at 1 and 4 steps per super-step.
    proto = Flood(source=0, method="hybrid")
    walls = {}
    for steps in (1, 4):
        rec_run = lambda: engine.run_until_coverage_from(  # noqa: E731
            g, proto, proto.init(g, KEY), KEY, steps_per_round=steps,
            recorder=flightrec.FlightRecorder(REC_CAPACITY), **cov)
        (_, out), rec = counted(rec_run, segsum, threefry, device_mod)
        ring = out.pop("flight_record")
        exp = want[f"rec_{steps}"]
        if out != EXPECTED_1M or ring.dropped != exp["dropped"] or \
                digest(torch.from_numpy(ring.rows)) != exp["rows_sha256"]:
            fail(f"4p recorder (steps {steps}): {out}, dropped "
                 f"{ring.dropped}, rows {ring.rows.tolist()}; the "
                 f"reference gives {exp}")
        launches["or"] += rec["segsum_launches"]
        off_run = lambda: engine.run_until_coverage_from(  # noqa: E731
            g, proto, proto.init(g, KEY), KEY, steps_per_round=steps, **cov)
        _, off_rec = counted(off_run, segsum, threefry, device_mod)
        # The recorder's one host transfer: the ring's fetch at the end.
        if rec["syncs"] != off_rec["syncs"] + 1:
            fail(f"4p recorder (steps {steps}) made {rec['syncs']} syncs, "
                 f"{off_rec['syncs']} without it")
        walls[steps] = {"with": timed_runs(rec_run, NEW_REPS),
                        "without": timed_runs(off_run, NEW_REPS)}
        print(json.dumps({
            "phase": "state-io", "part": "recorder", "steps": steps,
            "capacity": REC_CAPACITY, "dropped": ring.dropped, **rec,
            "syncs_without": off_rec["syncs"],
            **paired_walls(rec_run, off_run),
            "profile": walls[steps]["with"]["profile"],
            "profile_without": walls[steps]["without"]["profile"]}),
            flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        # The flood checkpointed at FLOOD_STOP rounds and resumed.
        stop_run = lambda: engine.run_until_coverage_from(  # noqa: E731
            g, proto, proto.init(g, KEY), KEY, coverage_target=0.99,
            max_rounds=FLOOD_STOP)
        (st5, o5), rec = counted(stop_run, segsum, threefry, device_mod)
        launches["or"] += rec["segsum_launches"]
        exp = want["ckpt_flood"]
        if o5 != exp["stop"]:
            fail(f"4p flood stopped at {FLOOD_STOP}: {o5}, the reference "
                 f"gives {exp['stop']}")
        path = f"{tmp}/flood.npz"
        _, save_s = host_timed(lambda: ckpt.save(path, st5, KEY, o5["rounds"],
                                                 o5["messages"]))
        file_sha = file_digest(path)
        (st, key, rnd, msgs), load_s = host_timed(
            lambda: ckpt.load(path, proto.init(g, KEY)))
        (st, out), rec = counted(
            lambda: engine.run_until_coverage_from(g, proto, st, key, **cov),
            segsum, threefry, device_mod)
        launches["or"] += rec["segsum_launches"]
        if (file_sha != exp["file_sha256"] or out != exp["resumed"]
                or rnd + out["rounds"] != EXPECTED_1M["rounds"]
                or msgs + out["messages"] != EXPECTED_1M["messages"]
                or not torch.equal(bool_seen(st, g.n_nodes_padded), seen)):
            fail(f"4p flood resume: file {file_sha}, resumed {out} from "
                 f"round {rnd}; the reference gives {exp} and phase 4's "
                 f"seen")
        print(json.dumps({"phase": "state-io", "part": "checkpoint-flood",
                          "stop_rounds": rnd, "resumed_rounds": out["rounds"],
                          "save_s": save_s, "load_s": load_s,
                          "file_bytes": Path(path).stat().st_size,
                          **rec}), flush=True)

        # SIR by run_from, checkpointed with the chain's key, resumed.
        sir = SIR(method="hybrid", **SIR_RUNG)
        (s15, st15), rec1 = counted(lambda: engine.run_from(
            g, sir, sir.init(g, KEY), KEY, SIR_STOP), segsum, threefry,
            device_mod)
        path = f"{tmp}/sir.npz"
        ckpt.save(path, s15, prng.fold_in(KEY, SIR_STOP), SIR_STOP,
                  int(st15["messages"].sum()))
        sl, kl, rl, ml = ckpt.load(path, sir.init(g, KEY))
        (s30, st30), rec2 = counted(lambda: engine.run_from(
            g, sir, sl, kl, SIR_STOP), segsum, threefry, device_mod)
        exp = want["ckpt_sir"]
        got = {"file_sha256": file_digest(path), "messages_at_stop": ml,
               "status_sha256": digest(s30.status),
               "messages": st30["messages"].tolist()}
        if got != exp or rl != SIR_STOP:
            fail(f"4p SIR resume: {got}, the reference gives {exp}")
        for r in (rec1, rec2):
            launches["sum"] += r["segsum_launches"]
            launches["threefry"] += r["threefry_launches"]
        print(json.dumps({"phase": "state-io", "part": "checkpoint-sir",
                          "rounds": [SIR_STOP, SIR_STOP],
                          "segsum_launches": rec1["segsum_launches"]
                          + rec2["segsum_launches"],
                          "threefry_launches": rec1["threefry_launches"]
                          + rec2["threefry_launches"]}), flush=True)

        # The graph file and the layout cache.
        path = f"{tmp}/graph.npz"
        _, gsave_s = host_timed(lambda: ckpt.save_graph(path, g))
        loaded, gload_s = host_timed(lambda: ckpt.load_graph(path))
        check_graph("4p load_graph", loaded, want["graph_sha256"])
        del loaded
        reg = telemetry.Registry()
        prev = telemetry.set_default_registry(reg)
        try:
            kw = dict(cache_dir=f"{tmp}/layouts",
                      params={"n": N_NODES, "k": 10, "p": 0.1, "seed": 0})
            (_, miss_s, hit0), miss_wall = host_timed(
                lambda: layoutcache.cached_graph("ws-1m", lambda: g, **kw))
            (cached, load_cached_s, hit1), hit_wall = host_timed(
                lambda: layoutcache.cached_graph("ws-1m", lambda: g, **kw))
        finally:
            telemetry.set_default_registry(prev)
        misses = reg.value("layout_cache_miss_total", reason="missing")
        if (hit0, hit1, misses) != (False, True, 1):
            fail(f"4p layout cache: hits {hit0}, {hit1}, misses {misses}")
        check_graph("4p cached_graph", cached, want["graph_sha256"])
        print(json.dumps({"phase": "state-io", "part": "graph-file",
                          "save_graph_s": gsave_s, "load_graph_s": gload_s,
                          "file_bytes": Path(path).stat().st_size,
                          "cache_miss_s": miss_wall, "cache_hit_s": hit_wall,
                          "cache_load_s": load_cached_s}), flush=True)
    return launches


#: The ordered row sums (``ops/rowsum.py``) at the shapes the main path
#: gives them: PageRank ``gather``'s pull over phase 4's neighbor table
#: (``gather`` entry), the batch recorder's two 1-D sums (B = 1,024 lane
#: counts, 32 message words; dense entry); beside them 4g's BA table shape
#: ``[100096, 128]``, the widest row that ``gather`` and ``skew`` sum.
BA_ROWS, BA_WIDTH = 100_096, 128


def rowsum_cases(neighbors, neighbor_mask) -> list:
    """Phase 4p's row-sum inputs, ``(entry, table, args)``: seeded random
    terms over phase 4's neighbor table ``[1,000,064, 17]``, the BA shape
    (30% of the slots live) and the recorder's lanes. ``tools/
    kernel_times.py`` times the same inputs."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    return [
        ("gather", "ws-1m", (torch.rand(neighbors.shape[0], generator=gen,
                                        device=dev),
                             neighbors, neighbor_mask)),
        ("gather", "ba-100k", (
            torch.rand(BA_ROWS, generator=gen, device=dev),
            torch.randint(0, BA_ROWS, (BA_ROWS, BA_WIDTH), generator=gen,
                          device=dev, dtype=torch.int32),
            torch.rand(BA_ROWS, BA_WIDTH, generator=gen, device=dev) < 0.3)),
    ] + [("dense", f"lanes-{n}",
          ((torch.rand(1, n, generator=gen, device=dev) * 1e5).floor(),))
         for n in (BATCH_B, 32)]


def rowsum_phase(rowsum, build_mod, g, flush):
    """Phase 4p: the row-sum kernel against its plain version (one torch
    launch per column of a window, on the card) on :func:`rowsum_cases`:
    bits equal, and equal to the CPU's plain version. Times each (CUDA
    events after an L2 flush, 20 launches), and for the dense entry the
    library call ``sum(dim=1)`` (no one PyTorch call gathers, masks and
    sums, so the gather entry has none), beside the launch floor. Prints a
    ``kernel`` line each; returns them by table."""
    cases = rowsum_cases(g.neighbors, g.neighbor_mask)
    floor_ms = launch_floor_ms(build_mod, flush)
    rows = {}
    for entry, name, args in cases:
        if entry == "gather":
            kernel, plain = rowsum.gather_row_sum, rowsum.gather_row_sum_plain
            signal, idx, _ = args
            shape, terms = list(idx.shape), idx.numel()
            # Each index and mask byte once, the signal once, two ops a
            # term (the mask product and the add).
            in_bytes, ops = 5 * terms + 4 * signal.numel(), 2 * terms
        else:
            kernel, plain = rowsum.row_sum, rowsum.row_sum_plain
            shape, terms = list(args[0].shape), args[0].numel()
            in_bytes, ops = 4 * terms, terms
        got, want = kernel(*args), plain(*args)
        cpu = plain(*(a.cpu() for a in args))
        for label, ref in (("plain version on the card", want),
                           ("CPU's plain version", cpu)):
            if not torch.equal(got.cpu().view(torch.int32),
                               ref.cpu().view(torch.int32)):
                fail(f"row-sum {name}: the kernel's bits differ from the "
                     f"{label}")
        by_bytes = (in_bytes + 4 * shape[0]) / HBM_BYTES_PER_S
        by_ops = ops / VECTOR_OPS_PER_S
        row = {"entry": entry, "table": name, "shape": shape,
               "ms": cuda_times(lambda: kernel(*args), 20, flush),
               "plain_ms": cuda_times(lambda: plain(*args), 20, flush),
               "library_ms": None if entry == "gather" else cuda_times(
                   lambda: args[0].sum(dim=1), 20, flush),
               "bound_ms": 1e3 * max(by_bytes, by_ops),
               "bound_by": "bytes" if by_bytes >= by_ops else "operations",
               "launch_floor_ms": floor_ms,
               "back_to_back_ms": back_to_back_ms(lambda: kernel(*args), 20),
               "max_abs_err": float((got - want).abs().max().nan_to_num())}
        print(json.dumps({"phase": "kernel", "kernel": "rowsum", **row}),
              flush=True)
        rows[name] = row
    return rows


def pagerank_gather(g, engine, rowsum, segsum, threefry, device_mod,
                    PageRank) -> int:
    """Phase 4p: PageRank by ``gather`` on phase 4's graph to
    ``EXPECTED_PAGERANK``'s threshold, its pull summed by the row-sum
    kernel once a round. Rounds and messages exact, the value and the
    rank total within ``PAGERANK_TOL``. Its wall beside the same run with
    the plain column loop in the kernel's place (swapped in for that
    comparison only; the ranks must keep their bits). Returns the
    kernel's launches."""
    proto = PageRank(method="gather")
    thr = EXPECTED_PAGERANK["threshold"]
    run = lambda: engine.run_until_converged(  # noqa: E731
        g, proto, KEY, stat="residual", threshold=thr)
    (state, out), rec = counted(run, segsum, threefry, device_mod)
    rank_total = state.ranks.sum().item()
    for k in ("rounds", "messages"):
        if out[k] != EXPECTED_PAGERANK[k]:
            fail(f"PageRank gather {k} {out[k]}, the reference gives "
                 f"{EXPECTED_PAGERANK[k]}")
    err = max(assert_close("PageRank gather value", out["value"],
                           EXPECTED_PAGERANK["value"],
                           *PAGERANK_TOL["value"]),
              assert_close("PageRank gather rank_total", rank_total,
                           EXPECTED_PAGERANK["rank_total"],
                           *PAGERANK_TOL["rank_total"]))
    no_launch("PageRank gather", rec, rowsum=out["rounds"])
    timed = timed_runs(run, NEW_REPS)
    kernel = rowsum.gather_row_sum
    rowsum.gather_row_sum = rowsum.gather_row_sum_plain
    try:
        plain_state, plain_out = run()
        plain = timed_runs(run, NEW_REPS)
    finally:
        rowsum.gather_row_sum = kernel
    if plain_out != out or not torch.equal(
            plain_state.ranks.view(torch.int32),
            state.ranks.view(torch.int32)):
        fail("PageRank gather: the plain row sum gives other ranks than the "
             "kernel")
    print(json.dumps({"phase": "state-io", "part": "pagerank-gather",
                      "threshold": thr, **out, "rank_total": rank_total,
                      **rec, **timed, "max_abs_err_vs_reference": err,
                      "plain_wall_s": plain["wall_s"],
                      "plain_wall_s_all": plain["wall_s_all"],
                      "plain_profile": plain["profile"]}), flush=True)
    return rec["rowsum_launches"]


def file_digest(path) -> str:
    """A checkpoint file's embedded ``__sha256__``."""
    with np.load(path) as data:
        return bytes(data["__sha256__"]).decode()


def batch_recorder(bg, engine, segsum, threefry, device_mod, flightrec,
                   MB):
    """Phase 4p on phase 4j's graph: the B = 1,024 ``auto`` batch call
    with a recorder. The rows must equal the reference's, the results
    ``EXPECTED_BATCH``'s; prints the recorder's cost in wall."""
    sources = np.random.default_rng(0).integers(
        0, bg.n_nodes, size=BATCH_B).astype(np.int32)
    proto = MB.BatchFlood(method="auto")

    def run(recorder=None):
        return engine.run_batch_until_coverage(
            bg, proto, proto.init(bg, sources, coverage_target=0.99), KEY,
            max_rounds=64, recorder=recorder)

    rec_run = lambda: run(flightrec.FlightRecorder(BATCH_REC_CAPACITY))  # noqa: E731,E501
    (state, out), rec = counted(rec_run, segsum, threefry, device_mod)
    ring = out.pop("flight_record")
    out["lane_messages"] = MB.lane_messages(bg, state).cpu().numpy()
    out["seen"] = state.seen.cpu().numpy()
    check_run("4p batch with a recorder", lane_summary(
        out, ("lane_messages", "seen")), EXPECTED_BATCH["first"])
    exp = EXPECTED_4P["batch_rec"]
    if digest(torch.from_numpy(ring.rows)) != exp["rows_sha256"]:
        fail(f"4p batch recorder rows {ring.rows.tolist()}, the reference "
             f"gives {exp['rows']}")
    # Two ordered 1-D sums a round: the sends and the seen counts.
    no_launch("4p batch recorder", rec, rowsum=2 * out["rounds"])
    _, off_rec = counted(run, segsum, threefry, device_mod)
    if rec["syncs"] != off_rec["syncs"] + 1:
        fail(f"4p batch recorder made {rec['syncs']} syncs, "
             f"{off_rec['syncs']} without it")
    with_rec, without = timed_runs(rec_run, NEW_REPS), timed_runs(run,
                                                                  NEW_REPS)
    paired = paired_walls(rec_run, run)
    print(json.dumps({"phase": "state-io", "part": "batch-recorder",
                      "rounds": out["rounds"], "capacity": BATCH_REC_CAPACITY,
                      **rec, "syncs_without": off_rec["syncs"], **paired,
                      "profile": with_rec["profile"],
                      "profile_without": without["profile"]}), flush=True)
    return rec["rowsum_launches"]


def canon_sha(doc) -> str:
    """sha256 of a document's canonical JSON (sorted keys, no spaces)."""
    return hashlib.sha256(json.dumps(
        doc, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


def serve_table(tickets, extra=()) -> dict:
    """The checked fields of every ticket record."""
    return {t: {k: r.get(k) for k in SERVE_FIELDS + tuple(extra)}
            for t, r in tickets.items()}


def serve_summary(out, stats) -> dict:
    """The checked numbers of a drive (``EXPECTED_SERVE``'s keys)."""
    got = {k: out[k] for k in ("submitted", "completed", "drain_ticks",
                               "executed_rounds", "peak_concurrent_lanes")}
    got.update(shed=len(out["shed"]),
               completion_rounds_p50=stats.get("completion_rounds_p50"),
               completion_rounds_p99=stats.get("completion_rounds_p99"),
               tickets_sha256=canon_sha(serve_table(out["tickets"])),
               shed_sha256=canon_sha(out["shed"]))
    return got


def journal_clock(svc):
    """:func:`host_clock` over every journal call of ``svc``."""
    return host_clock({n: (svc._journal, n) for n in JOURNAL_CALLS})


def phase_means(svc) -> dict:
    return {ph: row["mean_s"]
            for ph, row in svc.tick_phases()["per_phase"].items()}


def serve_path(bg, serve, segsum, threefry, device_mod, telemetry):
    """Phase 4q (after 4k): bench.py's serving column on phase 4j's graph,
    a warm service first as the bench does, then the drive: its numbers
    and ticket table equal to ``EXPECTED_SERVE``, no kernel launched;
    one tick under the profiler; then the same drive with a store, the
    journal and the seen hashes, preempted at ``SERVE_PREEMPT_TICK`` and
    finished by a fresh service resumed from the store, its retained
    ticket table equal to the uninterrupted run's and the reference's;
    then the background driver (``start``/``wait``/``close``) on
    ``SERVE_BACKGROUND`` tickets, each equal to a ticked service's, and
    every one of them done in a service resumed from its store."""
    sched = serve.generate(serve.TrafficPattern(**SERVE_PATTERN),
                           bg.n_nodes, seed=0)

    def make(**kw):
        return serve.SimService(bg, capacity=BATCH_B, queue_depth=BATCH_B,
                                chunk_rounds=4, seed=0, **kw)

    warm = make()
    warm.submit(0)
    warm.tick()
    warm.close()
    svc = make()
    out, rec = counted(lambda: serve.drive(svc, sched), segsum, threefry,
                       device_mod)
    stats = svc.stats()
    check_run("serve drive", serve_summary(out, stats), EXPECTED_SERVE)
    no_launch("serve drive", rec)
    wall, ticks = rec["first_run_s"], stats["tick"]
    launches = (rec["segsum_launches"] + rec["threefry_launches"]
                + rec["rowsum_launches"])
    print(json.dumps({
        "phase": "serve-path", "run": "drive", "wall_s": wall,
        "ticks": ticks, "completed": out["completed"],
        "shed": len(out["shed"]),
        "sustained_lanes_per_s": out["completed"] / wall,
        "executed_rounds": out["executed_rounds"],
        "peak_concurrent_lanes": out["peak_concurrent_lanes"],
        "completion_rounds_p50": stats["completion_rounds_p50"],
        "completion_rounds_p99": stats["completion_rounds_p99"],
        "syncs": rec["syncs"], "syncs_per_tick": rec["syncs"] / ticks,
        "launches": launches, "launches_per_tick": launches / ticks,
        "tick_phase_mean_s": phase_means(svc),
        "t_s": time.perf_counter() - T_START}), flush=True)

    # One profiled tick: tick 1 of the schedule, tick 0's lanes running.
    prof = make()
    for t in (0, 1):
        for src, tenant in sched.arrivals_at(t):
            try:
                prof.submit(src, tenant=tenant)
            except serve.Rejected:
                pass
        if t == 0:
            prof.tick()
    device_mod.SYNCS = 0
    profile = profile_run(prof.tick)
    print(json.dumps({"phase": "serve-path", "run": "profiled-tick",
                      "tick_syncs": device_mod.SYNCS,
                      "running": prof.stats()["active_lanes"],
                      "profile": profile}), flush=True)
    prof.close()

    # The stored drive, preempted and resumed.
    with tempfile.TemporaryDirectory() as d:
        kw = dict(store=d, journal=True, record_seen_hash=True)
        regs = [telemetry.Registry(), telemetry.Registry()]
        first = make(registry=regs[0], **kw)
        clocks = [journal_clock(first)]
        first.arm_preemption(SERVE_PREEMPT_TICK)
        t0 = time.perf_counter()
        try:
            serve.drive(first, sched)
            fail("serve: the armed preemption never fired")
        except serve.service.Preempted:
            pass
        t1 = time.perf_counter()
        again = make(registry=regs[1], **kw)
        if again.tick_index != SERVE_PREEMPT_TICK - 1:
            fail(f"serve resume restored tick {again.tick_index}, want "
                 f"{SERVE_PREEMPT_TICK - 1}")
        clocks.append(journal_clock(again))
        resumed = serve.drive(again, sched)
        t2 = time.perf_counter()
        kept = again.tickets()
        if serve_table(kept) != serve_table(svc.tickets()):
            fail("serve: the resumed drive's tickets differ from the "
                 "uninterrupted drive's")
        if canon_sha(serve_table(kept, ("seen_sha256",))) \
                != EXPECTED_SERVE_RETAINED:
            fail("serve: the resumed drive's tickets or seen hashes "
                 "differ from the reference's")
        ckpt_s = sum(s.tick_phases()["per_phase"]["checkpoint"]["total_s"]
                     for s in (first, again))
        n_ckpt = sum(r.value("supervise_checkpoints_written_total")
                     for r in regs)
        again.close()
        journal_s = sum(acc[n] for acc, _ in clocks for n in JOURNAL_CALLS)
        for _, undo in clocks:
            undo()
    print(json.dumps({
        "phase": "serve-path", "run": "preempt-resume",
        "preempted_at_tick": SERVE_PREEMPT_TICK,
        "first_life_s": t1 - t0, "resumed_life_s": t2 - t1,
        "replayed": resumed["replayed"], "checkpoints": n_ckpt,
        "checkpoint_s": ckpt_s, "checkpoint_s_each": ckpt_s / max(n_ckpt, 1),
        "journal_s": journal_s,
        "journal_records": again.stats()["journal"]["last_seq"],
        "tick_phase_mean_s": phase_means(again),
        "t_s": time.perf_counter() - T_START}), flush=True)

    # The background driver: the tickets submitted while its thread ticks,
    # then a clean close, which synchronizes the card before the final
    # checkpoint. Lanes are independent, so each ticket's rounds and seen
    # count equal those of the same sources ticked on the main thread.
    sources = range(0, bg.n_nodes, bg.n_nodes // SERVE_BACKGROUND)
    ticked = make()
    want = [ticked.submit(s) for s in sources]
    while ticked.busy():
        ticked.tick()
    want = [("done",) + tuple(ticked.poll(t)[k]
                              for k in ("rounds", "seen_count"))
            for t in want]
    ticked.close()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        live = make(store=d, idle_wait_s=0.01).start()
        tids = [live.submit(s) for s in sources]
        recs = [live.wait(t, timeout=120) for t in tids]
        live.close()
        wall = time.perf_counter() - t0
        got = [tuple(r[k] for k in ("status", "rounds", "seen_count"))
               for r in recs]
        if live.driver_running or got != want:
            fail(f"serve background: {got} against the ticked service's "
                 f"{want}, driver running {live.driver_running}")
        again = make(store=d)
        status = [again.poll(t)["status"] for t in tids]
        again.close()
        if status != ["done"] * len(tids):
            fail(f"serve background: the resumed store holds {status}")
    print(json.dumps({"phase": "serve-path", "run": "background",
                      "tickets": len(tids), "done": len(tids),
                      "wall_s": wall, "ticks": live.stats()["tick"],
                      "rounds": sorted({g[1] for g in got}),
                      "t_s": time.perf_counter() - T_START}), flush=True)


def host_clock(targets: dict):
    """Wrap each ``(owner, attribute)`` of ``targets`` so that its host
    seconds add to ``acc[name]``, and add the garbage collector's seconds
    to ``acc["gc"]``. Returns ``(acc, undo)``; ``undo()`` unwraps."""
    acc = dict.fromkeys([*targets, "gc"], 0.0)
    saved, gc_t0 = [], [0.0]
    for name, (owner, attr) in targets.items():
        f = getattr(owner, attr)
        saved.append((owner, attr, f))

        def timed(*a, _f=f, _n=name, **kw):
            t0 = time.perf_counter()
            try:
                return _f(*a, **kw)
            finally:
                acc[_n] += time.perf_counter() - t0
        setattr(owner, attr, timed)

    def on_gc(phase, _info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            acc["gc"] += time.perf_counter() - gc_t0[0]
    gc.callbacks.append(on_gc)

    def undo():
        gc.callbacks.remove(on_gc)
        for owner, attr, f in reversed(saved):
            setattr(owner, attr, f)
    return acc, undo


def supervise_path(g, seen, engine, segsum, threefry, device_mod, Flood,
                   supervise) -> int:
    """Phase 4q's supervised flood (on phase 4's graph, after 4p):
    ``SupervisedRun`` over the ``hybrid`` flood in ``SUPERVISE_CHUNK``-round
    chunks, preempted at ``SUPERVISE_PREEMPT`` and resumed from its store:
    rounds, coverage and messages ``EXPECTED_1M``'s, the final ``seen``
    phase 4's, B1 launched. Then the walls of the unsupervised flood alone
    (``SUPERVISE_ALONE`` back to back), of a fresh supervised run and of
    the unsupervised flood in turns (``SUPERVISE_PAIRS``), each with the
    host seconds of the engine's telemetry (run summary and history
    sample), of the store's saves and of the garbage collector; and one
    unsupervised flood profiled right after a supervised one. Returns B1's
    launches."""
    from p2pnetwork_tpu_torch.telemetry import history

    proto = Flood(source=0, method="hybrid")
    with tempfile.TemporaryDirectory() as d:
        def supervised(resume=False, preempt=None):
            run = supervise.SupervisedRun(g, proto, d,
                                          chunk_rounds=SUPERVISE_CHUNK)
            if preempt is not None:
                run.arm_preemption(preempt)
            return run.run_until_coverage(KEY, coverage_target=0.99,
                                          max_rounds=64, resume=resume)

        def unsupervised():
            return engine.run_until_coverage(g, proto, KEY,
                                             coverage_target=0.99,
                                             max_rounds=64)

        def preempted_then_resumed():
            try:
                supervised(preempt=SUPERVISE_PREEMPT)
                fail("supervise: the armed preemption never fired")
            except supervise.Preempted:
                pass
            return supervised(resume=True)

        (state, out), rec = counted(preempted_then_resumed, segsum,
                                    threefry, device_mod)
        got = {k: out[k] for k in ("rounds", "coverage", "messages")}
        check_run("supervised flood", got,
                  {k: EXPECTED_1M[k] for k in got})
        if out["resumed_from"] != SUPERVISE_PREEMPT - SUPERVISE_CHUNK:
            fail(f"supervised flood resumed from {out['resumed_from']}")
        if not torch.equal(bool_seen(state, g.n_nodes_padded), seen):
            fail("supervised flood: final seen differs from phase 4's")
        if rec["segsum_launches"] == 0:
            fail("supervised flood never launched the segment-sum kernel")

        acc, undo = host_clock({
            "summary": (engine, "_record_run_summary"),
            "history": (history.default_history(), "sample"),
            "store_save": (supervise.CheckpointStore, "save")})

        def timed(run):
            before = dict(acc)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            row = {k: acc[k] - before[k] for k in acc}
            row["telemetry"] = row.pop("summary") + row.pop("history")
            return {"wall": time.perf_counter() - t0, **row}

        try:
            alone = [timed(unsupervised) for _ in range(SUPERVISE_ALONE)]
            pairs = [(timed(supervised), timed(unsupervised))
                     for _ in range(SUPERVISE_PAIRS)]
            supervised()
            profile = profile_run(unsupervised)
        finally:
            undo()

    def med(rows, key):
        return statistics.median(r[key] for r in rows)

    sup = [p[0] for p in pairs]
    uns = [p[1] for p in pairs]
    costs = {f"{name}_{k}_s": med(rows, k)
             for name, rows in (("alone", alone), ("supervised", sup),
                                ("unsupervised", uns))
             for k in ("telemetry", "store_save", "gc")}
    print(json.dumps({
        "phase": "supervise-path", "run": "hybrid", **rec,
        "chunks": out["chunks"], "checkpoints": out["checkpoints"],
        "resumed_from": out["resumed_from"],
        "pairs": SUPERVISE_PAIRS,
        "supervised_wall_s": med(sup, "wall"),
        "unsupervised_wall_s": med(uns, "wall"),
        "alone_wall_s": med(alone, "wall"),
        "supervision_cost_s": statistics.median(
            a["wall"] - b["wall"] for a, b in pairs),
        **costs,
        "walls_supervised": [r["wall"] for r in sup],
        "walls_unsupervised": [r["wall"] for r in uns],
        "walls_alone": [r["wall"] for r in alone],
        "gc_unsupervised": [r["gc"] for r in uns],
        "profile_after_supervised": profile,
        "t_s": time.perf_counter() - T_START}), flush=True)
    return rec["segsum_launches"]


def slo_summary(out, svc, slo) -> dict:
    """4r(b)'s checked numbers: ``serve_summary``, the admit budget the
    drive ends on, and the SLO engine's alerts as (objective, transition,
    tick)."""
    got = serve_summary(out, svc.stats())
    got["admit_budget"] = svc.stats()["admit_budget"]
    got["alerts"] = [[r.data["objective"], r.data["transition"],
                      r.data["tick"]] for r in slo.log.snapshot()]
    return got


def soak_summary(out) -> dict:
    """4r(c)'s checked numbers of a storm drive; ``tickets_sha256`` over
    every ticket record (seen hashes included)."""
    got = {k: out[k] for k in (
        "submitted", "completed", "drain_ticks", "executed_rounds",
        "peak_concurrent_lanes", "events", "graph_nodes", "graph_capacity",
        "replayed")}
    got.update(shed=len(out["shed"]), tickets_sha256=canon_sha(out["tickets"]))
    return got


def fault_counts(reg) -> dict:
    return {k: int(reg.value("chaos_device_faults_total", kind=k))
            for k in ("corrupt", "zero", "delay", "preempt", "wedge")}


def http_call(port, path, body=None):
    """``(status, body text)`` of one request to a localhost server."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def prometheus_families(text: str) -> set:
    """The families of a Prometheus exposition; fails unless every sample
    line parses as ``name{labels} value``."""
    fams = set()
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            fams.add(line.split()[2])
        elif line and not line.startswith("#"):
            m = re.fullmatch(r'([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)',
                             line)
            if m is None:
                fail(f"/metrics line does not parse: {line!r}")
            float(m.group(3).replace("Inf", "inf"))
    return fams


def chaos_serve_path(bg, serve, chaos, heal, slo_mod, httpd, telemetry,
                     segsum, threefry, device_mod):
    """Phase 4r (a), (b) and (g) on 4j's graph, after 4q's drives.

    (a) 4q's drive with ``heal=`` under ``SERVE_FAULTS``: ``EXPECTED_SERVE``
    exactly, the ticket table an unhealed drive's, one preempt and one
    wedge injected, two chunks healed, no kernel launched; then
    ``HEAL_PAIRS`` unhealed and healed drives (no fault) in turns, whose
    wall difference is the healing's cost (the retained input and one
    audited host read of the batch per tick). (b) The healed, faulted
    drive with an SLO engine: ``EXPECTED_SERVE_SLO``. (g) A
    ``MetricsServer`` on ``127.0.0.1:0`` over (b)'s registry with (b)'s
    service mounted: ``/metrics`` parses and holds the ``serve_``,
    ``heal_`` and ``chaos_`` families, ``/dashboard.json`` is JSON, one
    ``POST /submit`` goes through ``handle_http`` to a done ticket."""
    sched = serve.generate(serve.TrafficPattern(**SERVE_PATTERN),
                           bg.n_nodes, seed=0)

    def make(**kw):
        return serve.SimService(bg, capacity=BATCH_B, queue_depth=BATCH_B,
                                chunk_rounds=4, seed=0, **kw)

    def faulted(reg, **kw):
        """A drive under ``SERVE_FAULTS`` counted into ``reg``."""
        prev = chaos.install_dispatch_chaos(
            chaos.DispatchChaos(registry=reg, **SERVE_FAULTS))
        try:
            svc = make(heal=heal.RetryPolicy(**HEAL_POLICY), registry=reg,
                       **kw)
            out, rec = counted(lambda: serve.drive(svc, sched), segsum,
                               threefry, device_mod)
        finally:
            chaos.install_dispatch_chaos(prev)
        return svc, out, rec

    base = make()
    serve.drive(base, sched)
    reg_a = telemetry.Registry()
    svc, out, rec = faulted(reg_a)
    check_run("healed serve drive", serve_summary(out, svc.stats()),
              EXPECTED_SERVE)
    if serve_table(svc.tickets()) != serve_table(base.tickets()):
        fail("healed serve drive: its tickets differ from the unfaulted "
             "drive's")
    counts = fault_counts(reg_a)
    healed = reg_a.value("heal_retries_total", outcome="healed")
    if (counts["preempt"], counts["wedge"], healed) != (1, 1, 2) \
            or reg_a.value("serve_healed_ticks_total") != 2:
        fail(f"healed serve drive: faults {counts}, healed {healed}")
    no_launch("healed serve drive", rec)
    svc.close()
    base.close()

    def drive_wall(**kw):
        s = make(**kw)
        syncs0 = device_mod.SYNCS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve.drive(s, sched)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ticks = s.stats()["tick"]
        s.close()
        return wall, (device_mod.SYNCS - syncs0) / ticks

    pairs = [(drive_wall(), drive_wall(heal=heal.RetryPolicy(**HEAL_POLICY)))
             for _ in range(HEAL_PAIRS)]
    print(json.dumps({
        "phase": "chaos-path", "run": "healed-drive",
        "faulted_wall_s": rec["first_run_s"], "syncs": rec["syncs"],
        "faults": counts, "healed_chunks": healed,
        "unhealed_wall_s": statistics.median(p[0][0] for p in pairs),
        "healed_wall_s": statistics.median(p[1][0] for p in pairs),
        "healing_cost_s": statistics.median(p[1][0] - p[0][0]
                                            for p in pairs),
        "syncs_per_tick": [pairs[0][0][1], pairs[0][1][1]],
        "walls": [[a[0], b[0]] for a, b in pairs],
        "t_s": time.perf_counter() - T_START}), flush=True)

    # (b) The same healed, faulted drive with the SLO engine.
    reg_b = telemetry.Registry()
    slo = slo_mod.SLOEngine(slo_mod.serve_objectives(slo_rounds=SLO_ROUNDS),
                            registry=reg_b)
    svc_b, out_b, rec_b = faulted(reg_b, slo=slo)
    check_run("slo serve drive", slo_summary(out_b, svc_b, slo),
              EXPECTED_SERVE_SLO)
    print(json.dumps({"phase": "chaos-path", "run": "slo-drive",
                      "wall_s": rec_b["first_run_s"],
                      "admit_budget": svc_b.stats()["admit_budget"],
                      "alerts": len(slo.log.snapshot()),
                      "t_s": time.perf_counter() - T_START}), flush=True)

    # (g) The HTTP mount over (b)'s registry and service.
    t0 = time.perf_counter()
    with httpd.MetricsServer(reg_b, host="127.0.0.1", port=0, service=svc_b,
                             slo=slo) as srv:
        code, text = http_call(srv.port, "/metrics")
        fams = prometheus_families(text) if code == 200 else set()
        missing = [p for p in ("serve_", "heal_", "chaos_")
                   if not any(f.startswith(p) for f in fams)]
        if code != 200 or missing:
            fail(f"/metrics: status {code}, no family of {missing}")
        code, doc = http_call(srv.port, "/dashboard.json")
        if code != 200 or "slo" not in json.loads(doc):
            fail(f"/dashboard.json: status {code}")
        code, page = http_call(srv.port, "/dashboard")
        if code != 200 or not page.startswith("<!DOCTYPE html>"):
            fail(f"/dashboard: status {code}")
        code, sub = http_call(srv.port, "/submit", {"source": 0})
        if code != 202:
            fail(f"/submit: status {code}: {sub}")
        tid = json.loads(sub)["ticket"]
        for _ in range(64):
            if not svc_b.busy():
                break
            svc_b.tick()
        code, rec_t = http_call(srv.port, f"/poll/{tid}")
        if code != 200 or json.loads(rec_t)["status"] != "done":
            fail(f"/poll/{tid}: status {code}: {rec_t}")
    svc_b.close()
    print(json.dumps({"phase": "chaos-path", "run": "http",
                      "families": len(fams), "seconds":
                      time.perf_counter() - t0,
                      "t_s": time.perf_counter() - T_START}), flush=True)


def soak_path(serve, storm, chaos, heal, graph_mod, telemetry):
    """Phase 4r(c): the reference's 100k churn soak on the card: the
    unfaulted drive, then the same storm under ``SERVE_FAULTS``, healed;
    both ``EXPECTED_SOAK``, their tickets equal."""
    t0 = time.perf_counter()
    g = graph_mod.grow(graph_mod.watts_strogatz(100_000, 6, 0.1, seed=0), 0,
                       node_capacity=1 << 17)
    churn = storm.generate(storm.ChurnPattern(**SOAK_STORM), g.n_nodes,
                           seed=11)
    tr = serve.generate(serve.TrafficPattern(**SOAK_TRAFFIC), g.n_nodes,
                        seed=13)
    build_s = time.perf_counter() - t0

    def drive(reg):
        svc = serve.SimService(g, capacity=32, chunk_rounds=4, seed=1,
                               record_seen_hash=True,
                               heal=heal.RetryPolicy(**HEAL_POLICY),
                               registry=reg)
        t0 = time.perf_counter()
        out = storm.drive(svc, churn, traffic=tr)
        torch.cuda.synchronize()
        svc.close()
        return out, svc.tickets(), time.perf_counter() - t0

    ref, ref_tickets, ref_s = drive(telemetry.Registry())
    check_run("soak drive", soak_summary(ref), EXPECTED_SOAK)
    reg = telemetry.Registry()
    prev = chaos.install_dispatch_chaos(
        chaos.DispatchChaos(registry=reg, **SERVE_FAULTS))
    try:
        got, got_tickets, got_s = drive(reg)
    finally:
        chaos.install_dispatch_chaos(prev)
    if got["tickets"] != ref["tickets"] or got_tickets != ref_tickets:
        fail("soak: the healed drive's tickets differ from the unfaulted "
             "drive's")
    check_run("healed soak drive", soak_summary(got), EXPECTED_SOAK)
    counts = fault_counts(reg)
    if (counts["preempt"], counts["wedge"],
            reg.value("heal_retries_total", outcome="healed"),
            reg.value("heal_retries_total", outcome="exhausted")) \
            != (1, 1, 2, 0):
        fail(f"soak: faults {counts}")
    if got["completed"] + len(got["shed"]) != got["submitted"]:
        fail("soak: a ticket was neither completed nor shed")
    print(json.dumps({"phase": "chaos-path", "run": "soak",
                      "build_s": build_s, "unfaulted_s": ref_s,
                      "healed_s": got_s, "events": got["events"],
                      "submitted": got["submitted"],
                      "graph_nodes": got["graph_nodes"],
                      "t_s": time.perf_counter() - T_START}), flush=True)


def heal_flood_path(g, seen, segsum, threefry, device_mod, Flood,
                    supervise, chaos, heal, telemetry) -> int:
    """Phase 4r(d): 4q's supervised ``hybrid`` flood under ``heal=`` with
    one chip preemption injected at its second chunk: ``EXPECTED_1M``,
    phase 4's ``seen``, one chunk healed. Returns B1's launches."""
    proto = Flood(source=0, method="hybrid")
    reg = telemetry.Registry()
    with tempfile.TemporaryDirectory() as d:
        run = supervise.SupervisedRun(g, proto, d,
                                      chunk_rounds=SUPERVISE_CHUNK,
                                      heal=heal.RetryPolicy(**HEAL_POLICY),
                                      registry=reg)
        prev = chaos.install_dispatch_chaos(
            chaos.DispatchChaos(preempt_at=(1,), registry=reg))
        try:
            (state, out), rec = counted(
                lambda: run.run_until_coverage(KEY, coverage_target=0.99,
                                               max_rounds=64),
                segsum, threefry, device_mod)
        finally:
            chaos.install_dispatch_chaos(prev)
    got = {k: out[k] for k in ("rounds", "coverage", "messages")}
    check_run("healed supervised flood", got,
              {k: EXPECTED_1M[k] for k in got})
    if not torch.equal(bool_seen(state, g.n_nodes_padded), seen):
        fail("healed supervised flood: final seen differs from phase 4's")
    if (fault_counts(reg)["preempt"],
            reg.value("heal_retries_total", outcome="healed")) != (1, 1):
        fail(f"healed supervised flood: {fault_counts(reg)}")
    if rec["segsum_launches"] == 0:
        fail("healed supervised flood never launched the segment-sum kernel")
    print(json.dumps({"phase": "chaos-path", "run": "healed-flood", **rec,
                      "chunks": out["chunks"],
                      "t_s": time.perf_counter() - T_START}), flush=True)
    return rec["segsum_launches"]


def fault_ring_path(g, want_seen, ring, segsum, threefry, device_mod,
                    sharded, mesh_mod, chaos, telemetry) -> dict:
    """Phase 4r(e): phase 4's graph sharded 8 ways (``mxu``) and flooded
    with ``comm=FaultSpec(FaultSchedule(**RING_FAULTS), "pallas")``: the
    reference's dict and ``seen``, the counter equal to the schedule's
    replay; ``FaultyComm`` never fuses, so B2 hops, B1's stacked sum
    applies and threefry draws the corrupt bits, and B3 never runs. With
    an empty schedule the flood equals the bare (B3) flood bit for bit.
    Returns the faulted flood's launches."""
    mesh = mesh_mod.ring_mesh(RING_SHARDS)
    t0 = time.perf_counter()
    sg = sharded.shard_graph(g, mesh, mxu=True)
    build_s = time.perf_counter() - t0
    sched = chaos.FaultSchedule(**RING_FAULTS)
    spec = chaos.FaultSpec(sched, "pallas")
    empty = chaos.FaultSpec(chaos.FaultSchedule(seed=RING_FAULTS["seed"]),
                            "pallas")

    def run(comm):
        return sharded.flood_until_coverage(sg, mesh, 0, coverage_target=0.99,
                                            max_rounds=64, comm=comm)

    reg = telemetry.default_registry()
    before = fault_counts(reg)
    reset_counts(ring, segsum, device_mod)
    threefry.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seen, out = run(spec)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {**ring_counts(ring, segsum), "threefry": threefry.LAUNCHES}
    syncs = device_mod.SYNCS
    after = fault_counts(reg)
    counts = {k: after[k] - before[k] for k in ("corrupt", "zero", "delay")}
    want = dict(EXPECTED_RING_FAULTED)
    want_sha, want_counts = want.pop("seen_sha256"), want.pop("faults")
    check_run("faulted ring flood", out, want)
    if digest(seen) != want_sha:
        fail("faulted ring flood: final seen differs from the reference's")
    replay = sched.counts_between(0, out["rounds"], RING_SHARDS - 1,
                                  RING_SHARDS)
    if counts != replay or counts != want_counts:
        fail(f"faulted ring flood counted {counts}; the schedule's replay "
             f"gives {replay}, the reference {want_counts}")
    if launches["ring_segsum"] or not (launches["segsum"]
                                       and launches["ring_shift"]
                                       and launches["threefry"]):
        fail(f"faulted ring flood launched {launches}: B1, B2 and "
             "threefry must run, B3 must not")
    seen_b, out_b = run("pallas")
    seen_e, out_e = run(empty)
    if out_b != EXPECTED_1M or not torch.equal(
            seen_b.reshape(-1)[:N_PAD], want_seen):
        fail(f"bare ring flood returned {out_b}")
    if out_e != out_b or not torch.equal(seen_e, seen_b):
        fail("ring flood with an empty schedule differs from the bare one")
    walls = {"faulted": [], "bare": []}
    for _ in range(RING_FAULT_REPS):
        for name, comm in (("faulted", spec), ("bare", "pallas")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(comm)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    print(json.dumps({
        "phase": "chaos-path", "run": "faulted-ring", "build_s": build_s,
        "rounds": out["rounds"], "faults": counts, "launches": launches,
        "syncs": syncs, "first_run_s": first_s,
        "faulted_wall_s": statistics.median(walls["faulted"]),
        "bare_wall_s": statistics.median(walls["bare"]), "walls": walls,
        "profile": profile_run(lambda: run(spec)),
        "t_s": time.perf_counter() - T_START}), flush=True)
    del sg
    torch.cuda.empty_cache()
    return launches


class EventList:
    """A node callback keeping ``[event, peer id, data]`` in firing order.
    Socket events fire on the node's loop thread and only append here;
    :meth:`wait` blocks the driving thread until they have arrived."""

    def __init__(self):
        self.events = []
        self._cv = threading.Condition()

    def __call__(self, event, main_node, connected_node, data):
        with self._cv:
            self.events.append(
                [event, getattr(connected_node, "id", None), data])
            self._cv.notify_all()

    def count(self, event) -> int:
        with self._cv:
            return sum(1 for e in self.events if e[0] == event)

    def wait(self, event, n, timeout=10.0) -> None:
        with self._cv:
            if not self._cv.wait_for(
                    lambda: sum(1 for e in self.events if e[0] == event) >= n,
                    timeout):
                fail(f"simnode: {event} number {n} did not arrive within "
                     f"{timeout} s")


def node_seen(node) -> np.ndarray:
    """A flood node's final ``seen`` as host bools, ``[n_pad]`` (the
    ring's ``[S, block]`` flattened: ``S * block`` is the padded size)."""
    state = node.sim_state
    seen = state[0] if isinstance(state, tuple) else state.seen
    if isinstance(seen, torch.Tensor):
        seen = seen.cpu()
    return np.asarray(seen).reshape(-1)


def sim_record(node, rec, summary) -> dict:
    return {"events_sha256": canon_sha(rec.events),
            "n_events": len(rec.events), "summary": summary,
            "alive_nodes": int(node.sim_node_alive.sum()),
            "seen_sha256": hashlib.sha256(
                node_seen(node).tobytes()).hexdigest(),
            "sim_round": node.sim_round,
            "sim_messages": node.sim_message_count}


def simnode_sequence(SimNode, Node, graph, proto, path, mesh=None,
                     sync=lambda: None, before_connect=None, peer_kw=None,
                     **kw):
    """Phase 4s's sequence, on either package's classes (the reference's
    recipe runs it on ``JaxSimNode``): a sim node and a plain ``Node``
    peer, both started on ``SIMNODE_HOST``; the peer connects,
    ``SIMNODE_PINGS`` dicts go each way (one round trip each); then the
    population calls, each timed between ``sync()`` calls. Returns the
    record the reference's is held to, the timings, and ``(node, peer,
    events, peer events)``, both nodes still running."""
    rec, peer_rec = EventList(), EventList()
    node = SimNode(SIMNODE_HOST, 0, id="sim-node", callback=rec,
                   graph=graph, protocol=proto, seed=SIMNODE_SEED,
                   mesh=mesh, **kw)
    peer = Node(SIMNODE_HOST, 0, id="peer", callback=peer_rec,
                **(peer_kw or {}))
    if before_connect is not None:
        before_connect(node, peer)
    node.start()
    peer.start()
    walls = {}

    def step(name, call):
        sync()
        t0 = time.perf_counter()
        out = call()
        sync()
        walls[name] = time.perf_counter() - t0
        return out

    if not peer.connect_with_node(SIMNODE_HOST, node.port, reconnect=True):
        fail("simnode: the peer could not connect to the sim node")
    rec.wait("inbound_node_connected", 1)
    rtts = []
    for i in range(SIMNODE_PINGS):
        t0 = time.perf_counter()
        peer.send_to_nodes({"ping": i})
        rec.wait("node_message", i + 1)
        node.send_to_nodes({"pong": i})
        peer_rec.wait("node_message", i + 1)
        rtts.append(time.perf_counter() - t0)
    step("run_rounds", lambda: node.run_rounds(SIMNODE_ROUNDS))
    step("fail_sim_nodes",
         lambda: node.fail_sim_nodes(np.arange(*SIMNODE_DEAD)))
    step("inject_sim_churn", lambda: node.inject_sim_churn(SIMNODE_CHURN))
    step("connect_sim_nodes", lambda: node.connect_sim_nodes(*SIMNODE_PAIRS))
    step("save_checkpoint", lambda: node.save_checkpoint(path))
    summary = step("run_until_coverage", lambda: node.run_until_coverage(
        SIMNODE_TARGET, max_rounds=64))
    record = {**sim_record(node, rec, summary),
              "peer_events_sha256": canon_sha(peer_rec.events),
              "payload_sha256": file_digest(path)}
    return record, {"walls": walls, "rtt_s": rtts}, (node, peer, rec,
                                                     peer_rec)


def simnode_resume(SimNode, graph, proto, path, mesh=None,
                   sync=lambda: None, **kw):
    """A fresh sim node (never started: no socket traffic) loads
    ``path`` and runs to ``SIMNODE_TARGET``. Returns its record and its
    walls."""
    rec = EventList()
    node = SimNode(SIMNODE_HOST, 0, id="sim-resumed", callback=rec,
                   graph=graph, protocol=proto, seed=SIMNODE_SEED, mesh=mesh,
                   **kw)
    try:
        sync()
        t0 = time.perf_counter()
        node.load_checkpoint(path)
        sync()
        t1 = time.perf_counter()
        summary = node.run_until_coverage(SIMNODE_TARGET, max_rounds=64)
        sync()
        t2 = time.perf_counter()
        record = sim_record(node, rec, summary)
    finally:
        node.stop()
    return record, {"load_checkpoint": t1 - t0,
                    "run_until_coverage": t2 - t1}


def simnode_counts(ring, segsum, threefry, device_mod) -> dict:
    return {"segsum": segsum.LAUNCHES, "ring_segsum": ring.SEGSUM_LAUNCHES,
            "ring_shift": ring.SHIFT_LAUNCHES - ring.SHIFT_BACK_LAUNCHES,
            "ring_shift_back": ring.SHIFT_BACK_LAUNCHES,
            "threefry": threefry.LAUNCHES, "syncs": device_mod.SYNCS}


def zero_counts(ring, segsum, threefry, device_mod) -> None:
    reset_counts(ring, segsum, device_mod)
    ring.SHIFT_BACK_LAUNCHES = threefry.LAUNCHES = 0


#: The kernels each 4s node must launch.
SIMNODE_EXPECT = {"single": ("segsum", "threefry"),
                  "mxu": ("ring_segsum", "segsum", "ring_shift",
                          "ring_shift_back", "threefry"),
                  "hybrid": ("segsum", "ring_shift", "ring_shift_back",
                             "threefry"),
                  "segment": ("ring_shift", "ring_shift_back", "threefry")}


def topology_events(rec) -> list:
    return [e[2] for e in rec.events
            if isinstance(e[2], dict) and "sim_topology" in e[2]]


def chaos_check(plane, reg, node, peer, rec) -> dict:
    """4s(c): a seeded partition of the two socket nodes and its heal;
    the counters read back, the peer reconnected, and a message sent
    after the heal delivered."""
    def until(pred, what, timeout=10.0):
        deadline = time.perf_counter() + timeout
        while not pred():
            if time.perf_counter() > deadline:
                fail(f"simnode chaos: {what} within {timeout} s")
            time.sleep(0.005)

    t0 = time.perf_counter()
    plane.partition([["sim-node"], ["peer"]])
    until(lambda: not peer.nodes_outbound, "the partition did not sever")
    t1 = time.perf_counter()
    plane.heal_partition()
    until(lambda: any(c.id == "sim-node" for c in peer.nodes_outbound),
          "the peer did not reconnect after the heal")
    t2 = time.perf_counter()
    n = rec.count("node_message")
    peer.send_to_nodes({"after": "heal"})
    rec.wait("node_message", n + 1)
    got = [e[2] for e in rec.events if e[0] == "node_message"][-1]
    if got != {"after": "heal"}:
        fail(f"simnode chaos: the sim node got {got} after the heal")
    counts = {k: reg.value("chaos_injected_failures_total", kind=k)
              for k in ("partition", "partition_heal")}
    groups = reg.value("chaos_active_faults", kind="partition_groups")
    if counts != {"partition": 1, "partition_heal": 1} or groups != 0:
        fail(f"simnode chaos: counters {counts}, {groups} groups")
    if [e[0] for e in plane.fault_log()] != ["partition", "partition_heal"]:
        fail(f"simnode chaos: fault log {plane.fault_log()}")
    return {"counts": counts, "sever_s": t1 - t0, "reconnect_s": t2 - t1,
            "delivered_s": time.perf_counter() - t2}


def b2_reverse_row(ring, flush) -> dict:
    """B2 reversed at 4s's shape: the re-mask's Horner payload, i32
    ``[8, 125008]``, bit-equal to its plain version; timed as phase 3's
    rows (library call ``torch.roll``)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randint(0, 2**20, (RING_SHARDS, RING_BLOCK), generator=gen,
                      device="cuda", dtype=torch.int32)
    if not torch.equal(ring.ring_shift(x, reverse=True),
                       ring.ring_shift_plain(x, reverse=True)):
        fail("ring_shift reversed differs from its plain version (i32)")
    nbytes = x.numel() * x.element_size()
    return {"kernel": "ring_shift_back", "entry": "i32",
            "shape": list(x.shape),
            "ms": cuda_times(lambda: ring.ring_shift(x, reverse=True), 50,
                             flush),
            "plain_ms": cuda_times(
                lambda: ring.ring_shift_plain(x, reverse=True), 50, flush),
            "library_ms": cuda_times(lambda: torch.roll(x, -1, 0), 50, flush),
            "back_to_back_ms": back_to_back_ms(
                lambda: ring.ring_shift(x, reverse=True), 50),
            "bound_ms": 1e3 * 2 * nbytes / HBM_BYTES_PER_S,
            "bound_by": "bytes", "max_abs_err": 0.0}


def simnode_path(g, ring, segsum, threefry, device_mod, topology, mesh_mod,
                 sharded, Flood, simnode, node_mod, config_mod, chaos,
                 telemetry) -> tuple:
    """Phase 4s: ``TorchSimNode`` on phase 4's graph through the Node API,
    on one device (with the peer's ChaosPlane, (c)) and on the 8-shard
    ring under each of ``SIMNODE_RING_LAYOUTS``; each node and its resumed
    twin against the reference's records, the ring nodes against the
    single-device node where the reference's
    ``test_churn_and_events_match`` holds them equal. On each ring node,
    one more re-mask (every node alive) under the profiler. Returns the
    launches of every kernel over the checked runs and the B2-reversed
    row."""
    mesh = mesh_mod.ring_mesh(RING_SHARDS)
    proto = Flood(source=0, method="hybrid")
    runs = [("single", topology.with_capacity(g, extra_edges=SIMNODE_DYN),
             None, {})]
    runs += [(lay, g, mesh, dict(layout=lay, dynamic_edges=SIMNODE_DYN))
             for lay in SIMNODE_RING_LAYOUTS]
    totals = collections.Counter()
    single = None
    with tempfile.TemporaryDirectory() as d:
        for name, graph, mm, kw in runs:
            path = f"{d}/{name}.npz"
            reg = telemetry.Registry()
            plane = chaos.ChaosPlane(seed=SIMNODE_CHAOS_SEED, registry=reg)
            zero_counts(ring, segsum, threefry, device_mod)
            t0 = time.perf_counter()
            record, timing, (node, peer, rec, _) = simnode_sequence(
                simnode.TorchSimNode, node_mod.Node, graph, proto, path,
                mesh=mm, sync=torch.cuda.synchronize,
                before_connect=plane.attach if name == "single" else None,
                peer_kw={"config": config_mod.NodeConfig(**SIMNODE_FAST)},
                **kw)
            seq_s = time.perf_counter() - t0
            launches = simnode_counts(ring, segsum, threefry, device_mod)
            remask_profile = None if mm is None else profile_run(
                lambda: sharded.fail_nodes(node.sim_sharded, []))
            try:
                chaos_rec = (chaos_check(plane, reg, node, peer, rec)
                             if name == "single" else None)
            finally:
                for n in (node, peer):
                    n.stop()
                for n in (node, peer):
                    n.join(10.0)
            zero_counts(ring, segsum, threefry, device_mod)
            resumed, resume_walls = simnode_resume(
                simnode.TorchSimNode, graph, proto, path, mesh=mm,
                sync=torch.cuda.synchronize, **kw)
            resume_launches = simnode_counts(ring, segsum, threefry,
                                             device_mod)
            want = (EXPECTED_SIMNODE if name == "single"
                    else EXPECTED_SIMNODE_RING[name])
            got = {**record,
                   "resumed_events_sha256": resumed["events_sha256"]}
            check_run(f"simnode {name}", got, want)
            # The uninterrupted node's run summary: its last event before
            # (c) and the stops added theirs.
            last = rec.events[record["n_events"] - 1]
            if canon_sha([last]) != resumed["events_sha256"] or \
                    {k: v for k, v in resumed.items()
                     if k not in ("events_sha256", "n_events")} != {
                        k: record[k] for k in resumed
                        if k not in ("events_sha256", "n_events")}:
                fail(f"simnode {name}: the resumed node {resumed} differs "
                     f"from the uninterrupted one {record}")
            if single is None:
                single = (record, topology_events(rec))
            elif (topology_events(rec) != single[1]
                  or record["seen_sha256"] != single[0]["seen_sha256"]
                  or record["sim_messages"] != single[0]["sim_messages"]
                  or {k: record["summary"][k] for k in (
                      "rounds", "messages", "coverage")} != {
                      k: single[0]["summary"][k] for k in (
                          "rounds", "messages", "coverage")}):
                fail(f"simnode {name}: the ring node differs from the "
                     f"single-device node")
            missing = [k for k in SIMNODE_EXPECT[name] if launches[k] == 0]
            if missing:
                fail(f"simnode {name} never launched {missing}")
            for k, v in launches.items():
                totals[k] += v
            for k, v in resume_launches.items():
                totals[k] += v
            rtt = sorted(timing["rtt_s"])
            print(json.dumps({
                "phase": "simnode-path", "node": name,
                "sequence_s": seq_s, "walls": timing["walls"],
                "resume_walls": resume_walls,
                "socket_rtt_median_s": rtt[len(rtt) // 2],
                "socket_rtt_max_s": rtt[-1], "launches": launches,
                "resume_launches": resume_launches,
                "events": record["n_events"], "summary": record["summary"],
                "alive_nodes": record["alive_nodes"],
                **({"chaos": chaos_rec} if chaos_rec else {}),
                **({"remask_profile": remask_profile} if remask_profile
                   else {}),
                "t_s": time.perf_counter() - T_START}), flush=True)
            del node, peer
            gc.collect()
            torch.cuda.empty_cache()
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    back_row = b2_reverse_row(ring, flush)
    del flush
    print(json.dumps({"phase": "kernel", **back_row}), flush=True)
    return dict(totals), back_row


# --------------------------------------------------------------- phase 4t


def host_np(x) -> np.ndarray:
    """A tensor of either package as numpy."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def np_sha(x) -> str:
    """sha256 of either package's array bytes."""
    return hashlib.sha256(np.ascontiguousarray(host_np(x)).tobytes()
                          ).hexdigest()


def stat_lists(stats) -> dict:
    return {k: host_np(v).tolist() for k, v in stats.items()}


def ring_runs(sharded, models, sg, mesh, key, layout) -> dict:
    """Phase 4t's runs of one ring layout, on either package's
    ``parallel.sharded`` and protocol classes (the reference's recipe
    runs them on the JAX package): ``name -> (run, record)``, ``record``
    turning the run's result into what is held to the reference."""
    SIR, PageRank, PushSum = models.SIR, models.PageRank, models.PushSum
    sir = SIR(**SIR_RUNG)

    def sir_fixed(**kw):
        return (lambda: sharded.sir(sg, mesh, sir, key, SIR_ROUNDS, **kw),
                lambda out: {**stat_lists(out[1]),
                             "status_sha256": np_sha(out[0])})

    runs = {"sir_exact": sir_fixed(exact_rng=True), "sir_fold": sir_fixed(),
            "sir_coverage": (
                lambda: sharded.sir_until_coverage(
                    sg, mesh, sir, key, coverage_target=RING_SIR_TARGET,
                    max_rounds=64),
                lambda out: {**out[1], "status_sha256": np_sha(out[0])})}
    if layout in RING_CONSENSUS_LAYOUTS:
        runs["pagerank"] = (
            lambda: sharded.pagerank(sg, mesh, PageRank(), RING_PR_ROUNDS),
            lambda out: stat_lists(out[1]))
        runs["pagerank_until"] = (
            lambda: sharded.pagerank_until_residual(
                sg, mesh, PageRank(), tol=RING_PR_TOL),
            lambda out: dict(out[1]))
        runs["pushsum"] = (
            lambda: sharded.pushsum(sg, mesh, PushSum(), key,
                                    RING_PS_ROUNDS),
            lambda out: stat_lists(out[1]))
        runs["pushsum_until"] = (
            lambda: sharded.pushsum_until_variance(
                sg, mesh, PushSum(), key, tol=RING_PS_TOL),
            lambda out: dict(out[1]))
    if layout == "segment":
        runs["hopdist"] = (
            lambda: sharded.hopdist_until_done(
                sg, mesh, models.HopDistance(source=0)),
            lambda out: {"rounds": out[1]["rounds"],
                         "messages": out[1]["messages"],
                         "sha256": np_sha(out[0][0])})
        runs["leader"] = (
            lambda: sharded.leader_until_quiet(sg, mesh),
            lambda out: {"rounds": out[1]["rounds"],
                         "messages": out[1]["messages"],
                         "sha256": np_sha(out[0])})
    return runs


def ring_gossip_run(sharded, Gossip, sg, mesh, key):
    """4t's gossip rung (``bench_gossip_sharded``): 30 rounds on the
    ladder's 100K BA graph, ``(run, record)``."""
    return (lambda: sharded.gossip(sg, mesh, Gossip(alpha=0.5), key,
                                   GOSSIP_ROUNDS),
            lambda out: {**stat_lists(out[1]),
                         "values_sha256": np_sha(out[0])})


def mesh_demo(SimNode, graph, SIR, mesh, path, sync=lambda: None, **kw):
    """``examples/mesh_simnode_demo.py``'s story at phase 4's width, on
    either package's sim node (not started: the population calls need no
    socket): SIR rounds, churn, two runtime links, more rounds, the run to
    the target, a checkpoint, and a fresh node that loads it. Returns the
    record the reference's is held to and each call's wall."""
    rec, walls = EventList(), {}
    make = lambda: SimNode(  # noqa: E731
        SIMNODE_HOST, 0, id="mesh-demo", callback=rec, graph=graph,
        protocol=SIR(**MESH_DEMO["sir"]), seed=MESH_DEMO["seed"], mesh=mesh,
        dynamic_edges=MESH_DEMO["dyn"], **kw)

    def step(name, call):
        sync()
        t0 = time.perf_counter()
        out = call()
        sync()
        walls[name] = time.perf_counter() - t0
        return out

    node = step("attach", make)
    step("run_rounds", lambda: node.run_rounds(MESH_DEMO["rounds"][0]))
    step("inject_sim_churn",
         lambda: node.inject_sim_churn(MESH_DEMO["churn"]))
    step("connect_sim_nodes",
         lambda: node.connect_sim_nodes(*MESH_DEMO["links"]))
    step("run_rounds_2", lambda: node.run_rounds(MESH_DEMO["rounds"][1]))
    summary = step("run_until_coverage", lambda: node.run_until_coverage(
        MESH_DEMO["target"], max_rounds=MESH_DEMO["max_rounds"]))
    step("save_checkpoint", lambda: node.save_checkpoint(path))
    n_events = len(rec.events)
    resumed = step("resume", make)
    step("load_checkpoint", lambda: resumed.load_checkpoint(path))
    same = (np_sha(resumed.sim_state) == np_sha(node.sim_state)
            and int(resumed.sim_node_alive.sum())
            == int(node.sim_node_alive.sum())
            and (resumed.sim_round, resumed.sim_message_count)
            == (node.sim_round, node.sim_message_count))
    record = {"events_sha256": canon_sha(rec.events[:n_events]),
              "n_events": n_events, "summary": summary,
              "alive_nodes": int(node.sim_node_alive.sum()),
              "status_sha256": np_sha(node.sim_state),
              "sim_round": node.sim_round,
              "sim_messages": node.sim_message_count,
              "resumed_equal": bool(same)}
    return record, walls


def mesh_pagerank(SimNode, graph, PageRank, mesh, walls=None, **kw):
    """A PageRank node on the ring: ``run_rounds(3)``, then
    ``run_until_converged("residual", RING_PR_TOL)``. Returns its events
    (the f32 values are held to the reference's within ``PAGERANK_TOL``);
    ``walls`` (a dict), when given, gets each call's host seconds (the
    card synchronised after each)."""
    rec, t = EventList(), [time.perf_counter()]

    def lap(name):
        if walls is not None:
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t[0]
            t[0] = time.perf_counter()

    node = SimNode(SIMNODE_HOST, 0, id="mesh-pagerank", callback=rec,
                   graph=graph, protocol=PageRank(), seed=MESH_DEMO["seed"],
                   mesh=mesh, **kw)
    lap("attach")
    node.run_rounds(3)
    lap("run_rounds")
    node.run_until_converged("residual", RING_PR_TOL, max_rounds=64)
    lap("run_until_converged")
    return [e[2] for e in rec.events]


def check_close(label, got, want, tols):
    """Fail unless ``got`` has ``want``'s keys, the values of ``tols``'
    keys within their ``(rtol, atol)``, every other value equal. Returns
    the largest difference of the tolerated values."""
    if sorted(got) != sorted(want):
        fail(f"{label}: keys {sorted(got)}, the reference has "
             f"{sorted(want)}")
    err = 0.0
    for k in want:
        if k in tols:
            err = max(err, assert_close(f"{label} {k}", got[k], want[k],
                                        *tols[k]))
        elif got[k] != want[k]:
            fail(f"{label} {k}: {got[k]}, the reference gives {want[k]}")
    return err


def ring_counts_4t(ring, segsum, threefry, rowsum, device_mod) -> dict:
    return {**simnode_counts(ring, segsum, threefry, device_mod),
            "rowsum": rowsum.LAUNCHES}


def zero_counts_4t(ring, segsum, threefry, rowsum, device_mod) -> None:
    zero_counts(ring, segsum, threefry, device_mod)
    rowsum.LAUNCHES = 0


def ring_launch_want(name, layout, out) -> dict:
    """The launches a 4t run must make, by kernel (``None``: more than 0):
    each sum pass is B3 on steps 0-6 and B1 on the peeled step 7
    (``mxu``), B2's seven f32 hops and B1 at every step (``hybrid``), or
    B2's seven hops and the segment buckets' scatter (``segment``); the
    draws one launch a key (``exact``) or a shard (``fold``); each f32
    ring total two row sums (the ``[S, block]`` shards', then theirs)."""
    steps = RING_SHARDS - 1
    if name.startswith("sir"):
        rounds = SIR_ROUNDS if name != "sir_coverage" else out[1]["rounds"]
        passes, draws = rounds, 2 * rounds * (
            1 if name == "sir_exact" else RING_SHARDS)
        totals = 0
    elif name.startswith("pagerank"):
        rounds = (RING_PR_ROUNDS if name == "pagerank"
                  else out[1]["rounds"])
        passes, draws, totals = rounds, 0, 3 * rounds
    elif name.startswith("pushsum"):
        rounds = (RING_PS_ROUNDS if name == "pushsum"
                  else out[1]["rounds"])
        passes, draws, totals = 2 * rounds, 1, 4 * rounds
    else:  # hop distance and leader: segment, B2 only
        return {"ring_shift": None}
    want = {"threefry": draws, "rowsum": 2 * totals}
    if layout == "mxu":
        want.update(ring_segsum=steps * passes, segsum=passes)
    elif layout == "hybrid":
        want.update(ring_shift=steps * passes, segsum=RING_SHARDS * passes)
    else:
        want.update(ring_shift=steps * passes)
    return want


def check_launches(label, launches, want) -> None:
    for k, w in want.items():
        n = launches[k]
        if (w is None and n == 0) or (w is not None and n != w):
            fail(f"{label} launched {k} {n} times, want "
                 f"{'> 0' if w is None else w}")


def shard_rowsum_input(block: int) -> torch.Tensor:
    """Seeded f32 ``[8, block]`` terms: the ring's per-shard totals' input
    (``sharded.psum_f32``) at the 1M and 100K blocks. ``tools/
    kernel_times.py`` times the same inputs."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    return torch.randn((RING_SHARDS, block), generator=gen, device="cuda")


def row_sum_shards_row(rowsum, flush, block: int) -> dict:
    """The row sum at the ring's per-shard shape, f32 ``[8, block]`` (a
    warp a level-1 window of 1,024 terms: rows of more than 1,024 terms),
    bit-equal to its plain version on the card and on the CPU; timed as
    phase 3's rows beside ``sum(dim=1)``, and back to back."""
    x = shard_rowsum_input(block)
    got = rowsum.row_sum(x).view(torch.int32)
    for label, want in (("on the card", rowsum.row_sum_plain(x)),
                        ("on the CPU", rowsum.row_sum_plain(x.cpu()))):
        if not torch.equal(got.cpu(), want.cpu().view(torch.int32)):
            fail(f"row_sum differs from its plain version {label} at "
                 f"[{RING_SHARDS}, {block}]")
    by_bytes = (x.numel() + RING_SHARDS) * 4 / HBM_BYTES_PER_S
    by_ops = x.numel() / VECTOR_OPS_PER_S
    return {"kernel": "row_sum", "entry": "shards",
            "shape": list(x.shape),
            "ms": cuda_times(lambda: rowsum.row_sum(x), 50, flush),
            "plain_ms": cuda_times(lambda: rowsum.row_sum_plain(x), 5,
                                   flush),
            "library_ms": cuda_times(lambda: x.sum(dim=1), 50, flush),
            "bound_ms": 1e3 * max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "back_to_back_ms": back_to_back_ms(lambda: rowsum.row_sum(x),
                                               50),
            "max_abs_err": 0.0}


def b2_i32_row(ring, flush) -> dict:
    """B2 forward on leader election's payload, i32 ``[8, 125008]``,
    bit-equal to its plain version; timed as phase 3's rows."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randint(0, 2**20, (RING_SHARDS, RING_BLOCK), generator=gen,
                      device="cuda", dtype=torch.int32)
    if not torch.equal(ring.ring_shift(x), ring.ring_shift_plain(x)):
        fail("ring_shift differs from its plain version (i32)")
    nbytes = x.numel() * x.element_size()
    return {"kernel": "ring_shift", "entry": "i32", "shape": list(x.shape),
            "ms": cuda_times(lambda: ring.ring_shift(x), 50, flush),
            "plain_ms": cuda_times(lambda: ring.ring_shift_plain(x), 50,
                                   flush),
            "library_ms": cuda_times(lambda: torch.roll(x, 1, 0), 50, flush),
            "bound_ms": 1e3 * 2 * nbytes / HBM_BYTES_PER_S,
            "bound_by": "bytes", "max_abs_err": 0.0}


def ring_protocol_path(g, ring, segsum, threefry, rowsum, device_mod,
                       sharded, mesh_mod, models, graph_mod, simnode):
    """Phase 4t: the ring's other protocols on phase 4's graph, 8 shards
    on the card, in each of ``RING_LAYOUTS`` (SIR on all three; PageRank
    and push-sum on ``RING_CONSENSUS_LAYOUTS``; hop distance and leader
    election on ``segment``), then the gossip rung, then
    ``TorchSimNode``'s mesh backend (``mesh_demo`` and a PageRank node on
    the ``mxu`` ring). Each run is held to the reference
    (``EXPECTED_SIR`` with ``exact_rng=True``, else ``EXPECTED_RING``,
    ``EXPECTED_ANALYTICS``, ``EXPECTED_RING_GOSSIP``,
    ``EXPECTED_MESH_DEMO``, ``EXPECTED_MESH_PAGERANK``) and to its
    launches (:func:`ring_launch_want`), then timed once more under the
    profiler. Returns the launches by kernel row, the timed rows of the
    row sum at the shards' shape and of B2 on i32, and each run's record
    (phase 4v holds its runs across ranks to them)."""
    t_phase = time.perf_counter()
    mesh = mesh_mod.ring_mesh(RING_SHARDS)
    counts = lambda: ring_counts_4t(  # noqa: E731
        ring, segsum, threefry, rowsum, device_mod)
    zero = lambda: zero_counts_4t(  # noqa: E731
        ring, segsum, threefry, rowsum, device_mod)
    rows = collections.Counter()
    records = {}
    err = 0.0

    def checked(label, run):
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, counts()

    def timed(label, run, first_s, launches, extra):
        prof = profile_run(run)
        print(json.dumps({"phase": "ring-protocol-path", "run": label,
                          "first_run_s": first_s, "wall_s": prof["wall_s"],
                          "device_busy_s": prof["device_busy_s"],
                          "device_idle_share": prof["device_idle_share"],
                          "kernel_launches": prof["kernel_launches"],
                          "launches": launches, "top": prof["top"],
                          **extra, "t_s": time.perf_counter() - T_START}),
              flush=True)

    for layout, kw in RING_LAYOUTS:
        t0 = time.perf_counter()
        sg = sharded.shard_graph(g, mesh, **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        for name, (run, record) in ring_runs(sharded, models, sg, mesh, KEY,
                                             layout).items():
            label = f"{name}-{layout}"
            out, first_s, launches = checked(label, run)
            got = records[label] = record(out)
            if name == "sir_exact":
                check_run(label, got, EXPECTED_SIR)
            elif name in ("hopdist", "leader"):
                want = EXPECTED_ANALYTICS["hop" if name == "hopdist"
                                          else "leader"]
                check_run(label, got, {k: want[k] for k in got})
            else:
                err = max(err, check_close(label, got, EXPECTED_RING[name],
                                           RING_TOL.get(name, {})))
            check_launches(label, launches,
                           ring_launch_want(name, layout, out))
            f32 = not name.startswith(("hopdist", "leader"))
            rows["ring_segsum_sum"] += launches["ring_segsum"]
            rows["segsum_ring_sum"] += launches["segsum"]
            rows["ring_shift_f32" if f32 else
                 "ring_shift_i32" if name == "leader"
                 else "ring_shift"] += launches["ring_shift"]
            rows["threefry"] += launches["threefry"]
            rows["row_sum_shards"] += launches["rowsum"] // 2
            rows["row_sum"] += launches["rowsum"] // 2
            timed(label, run, first_s, launches,
                  {"layout": layout, "build_s": build_s})
        del sg
        torch.cuda.empty_cache()

    # The gossip rung: the ladder's sharded 100K BA graph, segment buckets
    # (gossip reads the neighbor table only).
    gba = graph_mod.barabasi_albert(**RING_GOSSIP_GRAPH)
    sg = sharded.shard_graph(gba, mesh)
    if tuple(sg.node_mask.shape) != (RING_SHARDS, RING_GOSSIP_BLOCK):
        fail(f"the gossip ring's shards are {list(sg.node_mask.shape)}, "
             f"not the row sum's timed [{RING_SHARDS}, {RING_GOSSIP_BLOCK}]")
    run, record = ring_gossip_run(sharded, models.Gossip, sg, mesh, KEY)
    out, first_s, launches = checked("gossip", run)
    err = max(err, check_close("gossip", record(out), EXPECTED_RING_GOSSIP,
                               RING_TOL["gossip"]))
    # A partner draw a round: randint's two bits launches for each
    # shard's key ("fold"); the init's normal one.
    check_launches("gossip", launches, {
        "threefry": 2 * RING_SHARDS * GOSSIP_ROUNDS + 1,
        "ring_shift": (RING_SHARDS - 1) * GOSSIP_ROUNDS,
        "rowsum": 4 * GOSSIP_ROUNDS})
    rows["ring_shift_f32"] += launches["ring_shift"]
    rows["threefry"] += launches["threefry"]
    rows["row_sum_shards_100k"] += launches["rowsum"] // 2
    rows["row_sum"] += launches["rowsum"] // 2
    timed("gossip", run, first_s, launches, {"graph": RING_GOSSIP_GRAPH})
    del sg, gba

    # TorchSimNode's mesh backend on the mxu ring.
    with tempfile.TemporaryDirectory() as d:
        zero()
        t0 = time.perf_counter()
        record, walls = mesh_demo(simnode.TorchSimNode, g, models.SIR, mesh,
                                  f"{d}/demo.npz",
                                  sync=torch.cuda.synchronize, layout="mxu")
        demo_s = time.perf_counter() - t0
        launches = counts()
    check_run("mesh demo", record, EXPECTED_MESH_DEMO)
    check_launches("mesh demo", launches, {
        "ring_segsum": None, "segsum": None, "ring_shift": None,
        "ring_shift_back": None, "threefry": None})
    rows["ring_segsum_sum"] += launches["ring_segsum"]
    rows["segsum_ring_sum"] += launches["segsum"]
    rows["ring_shift"] += launches["ring_shift"]
    rows["ring_shift_back"] += launches["ring_shift_back"]
    rows["threefry"] += launches["threefry"]
    print(json.dumps({"phase": "ring-protocol-path", "run": "mesh-demo",
                      "layout": "mxu", "wall_s": demo_s, "walls": walls,
                      "launches": launches, "summary": record["summary"],
                      "t_s": time.perf_counter() - T_START}), flush=True)
    zero()
    t0 = time.perf_counter()
    events = mesh_pagerank(simnode.TorchSimNode, g, models.PageRank, mesh,
                           layout="mxu")
    torch.cuda.synchronize()
    pr_s = time.perf_counter() - t0
    launches = counts()
    if len(events) != len(EXPECTED_MESH_PAGERANK):
        fail(f"mesh PageRank fired {len(events)} events, the reference "
             f"{len(EXPECTED_MESH_PAGERANK)}")
    for i, (e, w) in enumerate(zip(events, EXPECTED_MESH_PAGERANK)):
        err = max(err, check_close(f"mesh PageRank event {i}", e, w,
                                   RING_TOL["mesh_pagerank"]))
    rows["ring_segsum_sum"] += launches["ring_segsum"]
    rows["segsum_ring_sum"] += launches["segsum"]
    rows["row_sum_shards"] += launches["rowsum"] // 2
    rows["row_sum"] += launches["rowsum"] // 2
    print(json.dumps({"phase": "ring-protocol-path", "run": "mesh-pagerank",
                      "layout": "mxu", "wall_s": pr_s, "launches": launches,
                      "summary": events[-1],
                      "t_s": time.perf_counter() - T_START}), flush=True)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    kernel_rows = {
        "row_sum_shards": row_sum_shards_row(rowsum, flush, RING_BLOCK),
        "row_sum_shards_100k": row_sum_shards_row(rowsum, flush,
                                                  RING_GOSSIP_BLOCK),
        "ring_shift_i32": b2_i32_row(ring, flush)}
    del flush
    for r in kernel_rows.values():
        print(json.dumps({"phase": "kernel", **r}), flush=True)
    print(json.dumps({"phase": "ring-protocol-path", "run": "phase",
                      "phase_s": time.perf_counter() - t_phase,
                      "max_abs_err_vs_reference": err, "launches": rows}),
          flush=True)
    return dict(rows), kernel_rows, records



def ring_walk_run(sharded, RandomWalks, sg, mesh, key):
    """4t's walk: 4l's cohort (``WALKERS``) for ``RING_WALK_ROUNDS`` rounds
    on a ``source_csr=True`` ring, on either package; ``(run, record)``."""
    proto = RandomWalks(n_walkers=WALKERS)
    return (lambda: sharded.walk(sg, mesh, proto, key, RING_WALK_ROUNDS,
                                 return_state=True),
            lambda out: {**stat_lists(out[1]),
                         "pos_sha256": np_sha(out[0][0]),
                         "visited_sha256": np_sha(out[0][2])})


def ring_walk_path(g, ring, segsum, threefry, rowsum, device_mod, sharded,
                   mesh_mod, RandomWalks) -> dict:
    """Phase 4t's walk on phase 4's graph: the 8-shard ring with the
    sender-CSR view, held to ``EXPECTED_RING_WALK``. No kernel runs (the
    draws are edge hashes); returns the launches."""
    mesh = mesh_mod.ring_mesh(RING_SHARDS)
    t0 = time.perf_counter()
    sg = sharded.shard_graph(g, mesh, source_csr=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    run, record = ring_walk_run(sharded, RandomWalks, sg, mesh, KEY)
    zero_counts_4t(ring, segsum, threefry, rowsum, device_mod)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ring_counts_4t(ring, segsum, threefry, rowsum, device_mod)
    check_run("ring walk", record(out), EXPECTED_RING_WALK)
    check_launches("ring walk", launches, {
        k: 0 for k in ("segsum", "ring_segsum", "ring_shift", "threefry",
                       "rowsum")})
    prof = profile_run(run)
    print(json.dumps({"phase": "ring-protocol-path", "run": "walk",
                      "build_s": build_s, "csr_span": sg.csr_span,
                      "first_run_s": first_s, "wall_s": prof["wall_s"],
                      "device_busy_s": prof["device_busy_s"],
                      "device_idle_share": prof["device_idle_share"],
                      "kernel_launches": prof["kernel_launches"],
                      "launches": launches, "top": prof["top"],
                      "t_s": time.perf_counter() - T_START}), flush=True)
    return launches


def ring_batch_path(bg, ring, segsum, threefry, rowsum, device_mod,
                    sharded, mesh_mod, MB, flush) -> tuple:
    """Phase 4t's batched call on 4j's graph: the B = 1,024 batch of
    ``batch_path`` on the 8-shard ``segment`` ring, the lane words
    (``[8, 32, 12512]``) the halo payload; equal to ``EXPECTED_BATCH``'s
    first call (the reference's ring loop is its engine loop, lane for
    lane). Returns B2's launches on the word stack and its timed row."""
    mesh = mesh_mod.ring_mesh(RING_SHARDS)
    sg = sharded.shard_graph(bg, mesh)
    sources = np.random.default_rng(0).integers(
        0, bg.n_nodes, size=BATCH_B).astype(np.int32)
    proto = MB.BatchFlood(method="segment")
    run = lambda: sharded.run_batch_until_coverage(  # noqa: E731
        sg, mesh, proto, proto.init(bg, sources, coverage_target=0.99),
        max_rounds=64)
    zero_counts_4t(ring, segsum, threefry, rowsum, device_mod)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, out = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ring_counts_4t(ring, segsum, threefry, rowsum, device_mod)
    out["lane_messages"] = MB.lane_messages(bg, state).cpu().numpy()
    out["seen"] = state.seen.cpu().numpy()
    check_run("ring batch", lane_summary(out, ("lane_messages", "seen")),
              EXPECTED_BATCH["first"])
    check_launches("ring batch", launches, {
        "ring_shift": (RING_SHARDS - 1) * out["rounds"], "segsum": 0,
        "ring_segsum": 0, "threefry": 0, "rowsum": 0})
    prof = profile_run(run)
    print(json.dumps({"phase": "ring-protocol-path", "run": "batch",
                      "lanes": BATCH_B, "rounds": out["rounds"],
                      "messages": out["messages"], "first_run_s": first_s,
                      "wall_s": prof["wall_s"],
                      "device_busy_s": prof["device_busy_s"],
                      "device_idle_share": prof["device_idle_share"],
                      "kernel_launches": prof["kernel_launches"],
                      "launches": launches, "top": prof["top"],
                      "t_s": time.perf_counter() - T_START}), flush=True)
    stack = sharded.shard_lanes(sg, state.seen)
    if not torch.equal(ring.ring_shift(stack), ring.ring_shift_plain(stack)):
        fail("ring_shift differs from its plain version on the word stack")
    nbytes = stack.numel() * stack.element_size()
    row = {"kernel": "ring_shift", "entry": "lanes",
           "shape": list(stack.shape),
           "ms": cuda_times(lambda: ring.ring_shift(stack), 50, flush),
           "plain_ms": cuda_times(lambda: ring.ring_shift_plain(stack), 50,
                                  flush),
           "library_ms": cuda_times(lambda: torch.roll(stack, 1, 0), 50,
                                    flush),
           "bound_ms": 1e3 * 2 * nbytes / HBM_BYTES_PER_S,
           "bound_by": "bytes", "max_abs_err": 0.0}
    print(json.dumps({"phase": "kernel", **row}), flush=True)
    return launches["ring_shift"], row

def campaign_path(crashstorm, serve, graph_mod, telemetry) -> None:
    """Phase 4r(f): the reference's crash-storm acceptance campaign, its
    subprocess children on the card: no acknowledged ticket lost, the
    final table the uninterrupted child's (``run_campaign`` raises
    otherwise), at least 3 kills landed; then a ``Standby`` promotes over
    the stormed trail and the zombie primary's publish dies as
    ``FencedEpoch``."""
    sched = crashstorm.generate(CAMPAIGN_KILLS["n_kills"],
                                seed=CAMPAIGN_KILLS["seed"],
                                ticks=CAMPAIGN_KILLS["ticks"])
    kinds = [k.kind for k in sched.kills]
    if not {"journal_append", "sidecar_publish"} <= set(kinds):
        fail(f"crash schedule lacks a required kind: {kinds}")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        report = crashstorm.run_campaign(d, sched, config=CAMPAIGN_CONFIG,
                                         timeout=600.0)
        wall = time.perf_counter() - t0
        landed = sum(1 for k in report["kills"] if k["landed"])
        if report["tickets"] <= 0 or landed < 3 \
                or report["acked_seen"] > report["tickets"]:
            fail(f"crash campaign: {report}")
        g = graph_mod.watts_strogatz(CAMPAIGN_CONFIG["n_nodes"], 6, 0.1,
                                     seed=3)
        trail = f"{d}/trail"
        kw = dict(capacity=CAMPAIGN_CONFIG["capacity"],
                  chunk_rounds=CAMPAIGN_CONFIG["chunk_rounds"], seed=0,
                  record_seen_hash=True)
        zombie = serve.SimService(g, store=trail, resume=True,
                                  registry=telemetry.Registry(), **kw)
        promoted = serve.Standby(g, trail, registry=telemetry.Registry(),
                                 **kw).promote()
        if promoted.stats()["epoch"] != zombie.stats()["epoch"] + 1:
            fail("crash campaign: the promoted epoch is not the zombie's + 1")
        try:
            zombie.checkpoint()
            fail("crash campaign: the zombie's publish was not fenced")
        except serve.FencedEpoch:
            pass
        promoted.close()
    print(json.dumps({"phase": "chaos-path", "run": "crash-campaign",
                      "wall_s": wall, "kills": report["kills"],
                      "landed": landed, "tickets": report["tickets"],
                      "acked_seen": report["acked_seen"],
                      "replayed": report["replayed"],
                      "t_s": time.perf_counter() - T_START}), flush=True)


def reorder_path(engine, segsum, threefry, device_mod, graph_mod, layout,
                 Flood) -> int:
    """Phase 4o: ``from_edges(reorder=...)`` by ``"rcm"`` and ``"degree"``
    on phase 4j's 100K WS class (with the hybrid layout): every field's
    sha256 equal to the reference's build (``EXPECTED_REORDER``), and a
    ``Flood(hybrid)`` from node 0's new id, mapped back by
    ``to_original_order``, equal to the flood over the plain build (its
    dict and ``seen``). Returns B1's OR launches."""
    kw = dict(source_csr=True, hybrid=True)
    plain = graph_mod.watts_strogatz(BATCH_N, 10, 0.1, seed=0, **kw)
    base_state, base_out = engine.run_until_coverage(
        plain, Flood(source=0, method="hybrid"), KEY, coverage_target=0.99,
        max_rounds=64)
    launches = 0
    for strategy in ("rcm", "degree"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rg = graph_mod.watts_strogatz(BATCH_N, 10, 0.1, seed=0,
                                      reorder=strategy, **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        sha = graph_digest(rg)
        if sha != EXPECTED_REORDER[strategy]:
            fail(f"reorder {strategy}: graph sha256 {sha}, the reference's "
                 f"is {EXPECTED_REORDER[strategy]}")
        proto = Flood(source=int(rg.layout_perm[0]), method="hybrid")
        run = lambda: engine.run_until_coverage(  # noqa: E731
            rg, proto, KEY, coverage_target=0.99, max_rounds=64)
        (state, out), rec = counted(run, segsum, threefry, device_mod)
        if out != base_out or not torch.equal(
                layout.to_original_order(state.seen, rg), base_state.seen):
            fail(f"reorder {strategy}: the flood mapped back differs from "
                 f"the plain build's ({out} against {base_out})")
        no_launch(f"reorder {strategy}", rec, segsum=None)
        launches += rec["segsum_launches"]
        timed_line("reorder-path", strategy, run, rec, {
            "build_s": build_s, "graph_sha256": sha,
            "rounds": out["rounds"], "messages": out["messages"]},
            reps=NEW_REPS)
    return launches


#: Launches each ring layout must make (> 0): kernel name -> counter.
def dense_launches(layout: str, passes: int) -> dict:
    """Launches by kernel of ``passes`` dense ring OR passes."""
    want = {"segsum": 0, "ring_shift": 0, "ring_segsum": 0, "threefry": 0,
            "rowsum": 0}
    for k, n in DENSE_PASS[layout].items():
        want[k] = n * passes
    return want


def adaptive_ring_path(g, want_seen, ring, segsum, threefry, rowsum,
                       device_mod, sharded, mesh_mod, flightrec,
                       HopDistance, sparse1: dict) -> dict:
    """Phase 4u (a), (b), (d): phase 4's graph sharded 8 ways with its
    sender-CSR view, in each layout: (a) the frontier-adaptive flood
    (``adaptive_k=ADAPTIVE_K``) equal to the reference's and to the dense
    loop's, its sparse rounds, syncs and launches (none in a sparse round,
    one dense pass a dense round), its wall in turns with the dense
    flood's and one profiled run; (d) the recorded dense flood, rows and
    ``ici_bytes`` the reference's, summary and ``seen`` unchanged, its
    wall in turns with the bare flood's; under ``hybrid`` also (b) the
    adaptive hop distance. Returns the launches by kernel, and keeps each
    adaptive run's sparse rounds in ``sparse1`` (``adaptive-<layout>``,
    ``adaptive_hop-hybrid``), which 4w holds the rank ring to."""
    mesh = mesh_mod.ring_mesh(RING_SHARDS)
    totals = {"segsum": 0, "ring_shift": 0, "ring_segsum": 0}
    order = [("hybrid", {"hybrid": True}), ("mxu", {"mxu": True}),
             ("segment", {})]
    for layout, kw in order:
        t0 = time.perf_counter()
        sg = sharded.shard_graph(g, mesh, source_csr=True, **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0

        def adaptive():
            return sharded.flood_until_coverage(
                sg, mesh, 0, coverage_target=0.99, max_rounds=64,
                adaptive_k=ADAPTIVE_K)

        def dense():
            return sharded.flood_until_coverage(
                sg, mesh, 0, coverage_target=0.99, max_rounds=64)

        def recorded():
            return sharded.flood_until_coverage(
                sg, mesh, 0, coverage_target=0.99, max_rounds=64,
                recorder=flightrec.FlightRecorder(64))

        seen_d, out_d = dense()
        zero_counts_4t(ring, segsum, threefry, rowsum, device_mod)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seen, out = adaptive()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = ring_counts_4t(ring, segsum, threefry, rowsum, device_mod)
        sparse = sparse1[f"adaptive-{layout}"] = list(
            sharded.LAST_SPARSE_ROUNDS)
        if out != EXPECTED_1M or out != out_d:
            fail(f"adaptive ring {layout} returned {out}, the reference "
                 f"gives {EXPECTED_1M}, the dense loop {out_d}")
        if digest(seen) != EXPECTED_RING_SEEN or not torch.equal(
                seen, seen_d) or not torch.equal(seen.reshape(-1),
                                                 want_seen):
            fail(f"adaptive ring {layout}: seen differs from the "
                 "reference's, the dense loop's or phase 4's")
        n_dense = out["rounds"] - len(sparse)
        check_launches(f"adaptive ring {layout}", counts,
                       dense_launches(layout, n_dense))
        if counts["syncs"] != 2 * out["rounds"] + 1:
            fail(f"adaptive ring {layout}: {counts['syncs']} syncs, want "
                 f"{2 * out['rounds'] + 1}")
        for k in totals:
            totals[k] += counts[k]
        walls = paired_walls(adaptive, dense, pairs=NEW_REPS)
        prof = profile_run(adaptive)
        print(json.dumps({
            "phase": "adaptive-ring-path", "run": "flood", "layout": layout,
            "k": ADAPTIVE_K, "build_s": build_s, "csr_span": sg.csr_span,
            "rounds": out["rounds"], "sparse_rounds": sparse,
            "dense_rounds": n_dense, "launches": counts,
            "first_run_s": first_s, "wall_s": walls["wall_s"],
            "dense_wall_s": walls["wall_s_without"],
            "walls": walls["walls_with"],
            "dense_walls": walls["walls_without"],
            "device_busy_s": prof["device_busy_s"],
            "device_idle_share": prof["device_idle_share"],
            "kernel_launches": prof["kernel_launches"], "top": prof["top"],
            "t_s": time.perf_counter() - T_START}), flush=True)

        # (d) The recorder on the dense flood.
        zero_counts_4t(ring, segsum, threefry, rowsum, device_mod)
        seen_r, out_r = recorded()
        counts = ring_counts_4t(ring, segsum, threefry, rowsum, device_mod)
        fr = out_r.pop("flight_record")
        if out_r != out_d or not torch.equal(seen_r, seen_d):
            fail(f"recorded ring {layout}: the recorder changed the run")
        if np_sha(fr.rows) != EXPECTED_RING_REC["rows"] or int(
                fr.rows[0, -1]) != EXPECTED_RING_REC["ici"]:
            fail(f"recorded ring {layout}: rows differ from the "
                 f"reference's (ici_bytes {fr.rows[0, -1]}, want "
                 f"{EXPECTED_RING_REC['ici']})")
        check_launches(f"recorded ring {layout}", counts,
                       dense_launches(layout, out_r["rounds"]))
        if counts["syncs"] != out_r["rounds"] + 2:
            fail(f"recorded ring {layout}: {counts['syncs']} syncs, want "
                 f"{out_r['rounds'] + 2} (the exit reads and the fetch)")
        for k in totals:
            totals[k] += counts[k]
        rec_walls = paired_walls(recorded, dense, pairs=NEW_REPS)
        print(json.dumps({
            "phase": "adaptive-ring-path", "run": "recorder",
            "layout": layout, "rows": list(fr.rows.shape),
            "ici_bytes": int(fr.rows[0, -1]), "launches": counts,
            **{k: rec_walls[k] for k in ("wall_s", "wall_s_without",
                                         "recorder_cost_s", "walls_with",
                                         "walls_without")},
            "t_s": time.perf_counter() - T_START}), flush=True)

        if layout == "hybrid":
            totals_hop = adaptive_hop(sg, mesh, ring, segsum, threefry,
                                      rowsum, device_mod, sharded,
                                      HopDistance, sparse1)
            for k in totals:
                totals[k] += totals_hop[k]
        del sg
        torch.cuda.empty_cache()
    return totals


def adaptive_hop(sg, mesh, ring, segsum, threefry, rowsum, device_mod,
                 sharded, HopDistance, sparse1: dict) -> dict:
    """Phase 4u (b): the adaptive hop distance to 0.99 on the ``hybrid``
    ring, equal to the reference's and to the dense loop's."""
    proto = HopDistance(source=0)

    def adaptive():
        return sharded.hopdist_until_coverage(
            sg, mesh, proto, coverage_target=0.99, adaptive_k=ADAPTIVE_K)

    def dense():
        return sharded.hopdist_until_coverage(sg, mesh, proto,
                                              coverage_target=0.99)

    (dd, fd, rd), out_d = dense()
    zero_counts_4t(ring, segsum, threefry, rowsum, device_mod)
    (d, f, r), out = adaptive()
    counts = ring_counts_4t(ring, segsum, threefry, rowsum, device_mod)
    sparse = sparse1["adaptive_hop-hybrid"] = list(
        sharded.LAST_SPARSE_ROUNDS)
    want = EXPECTED_ADAPTIVE_HOP
    if out != want["summary"] or out != out_d:
        fail(f"adaptive ring hop distance returned {out}, the reference "
             f"gives {want['summary']}, the dense loop {out_d}")
    if (digest(d), digest(f), int(r)) != (want["dist"], want["frontier"],
                                          want["round"]) or not (
            torch.equal(d, dd) and torch.equal(f, fd) and int(r) == int(rd)):
        fail("adaptive ring hop distance: dist, frontier or round differ "
             "from the reference's or the dense loop's")
    check_launches("adaptive ring hop distance", counts,
                   dense_launches("hybrid", out["rounds"] - len(sparse)))
    if counts["syncs"] != 2 * out["rounds"] + 1:
        fail(f"adaptive ring hop distance: {counts['syncs']} syncs")
    walls = paired_walls(adaptive, dense, pairs=NEW_REPS)
    print(json.dumps({
        "phase": "adaptive-ring-path", "run": "hopdist", "layout": "hybrid",
        "k": ADAPTIVE_K, "rounds": out["rounds"], "sparse_rounds": sparse,
        "launches": counts, "wall_s": walls["wall_s"],
        "dense_wall_s": walls["wall_s_without"],
        "t_s": time.perf_counter() - T_START}), flush=True)
    return counts


def adaptive_node_path(g, ring, segsum, threefry, rowsum, device_mod,
                       mesh_mod, simnode, node_mod, Flood,
                       HopDistance) -> dict:
    """Phase 4u (c): ``TorchSimNode`` on the ``hybrid`` ring with
    ``adaptive_k``, a plain ``Node`` peer connected over a real socket:
    ``run_until_coverage`` for Flood (then a checkpoint, loaded by a
    fresh node whose state and counters equal the first's) and for
    HopDistance. Summaries and their ``sim_run`` events equal (a)'s and
    (b)'s. Returns the launches by kernel."""
    mesh = mesh_mod.ring_mesh(RING_SHARDS)
    totals = {"segsum": 0, "ring_shift": 0, "ring_segsum": 0}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "adaptive_node.npz")
        for name, proto, want in (
                ("flood", Flood(source=0), EXPECTED_1M),
                ("hopdist", HopDistance(source=0),
                 EXPECTED_ADAPTIVE_HOP["summary"])):
            rec, peer_rec = EventList(), EventList()
            t0 = time.perf_counter()
            node = simnode.TorchSimNode(
                SIMNODE_HOST, 0, id="sim-adaptive", callback=rec,
                graph=g, protocol=proto, seed=SIMNODE_SEED, mesh=mesh,
                adaptive_k=ADAPTIVE_K)
            build_s = time.perf_counter() - t0
            peer = node_mod.Node(SIMNODE_HOST, 0, id="peer",
                                 callback=peer_rec)
            try:
                node.start()
                peer.start()
                if not peer.connect_with_node(SIMNODE_HOST, node.port):
                    fail("adaptive node: the peer could not connect")
                rec.wait("inbound_node_connected", 1)
                peer.send_to_nodes({"ping": name})
                rec.wait("node_message", 1)
                zero_counts_4t(ring, segsum, threefry, rowsum, device_mod)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                summary = node.run_until_coverage(0.99, max_rounds=64)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = ring_counts_4t(ring, segsum, threefry, rowsum,
                                        device_mod)
                event = [e[2] for e in rec.events if e[0] == "node_message"
                         and isinstance(e[2], dict) and e[2].get("sim_run")]
                if summary != want or event != [{"sim_run": True, **want}]:
                    fail(f"adaptive node {name}: summary {summary} or its "
                         f"event {event} differs from {want}")
                if node.sim_sharded.csr_pos is None:
                    fail(f"adaptive node {name}: no sender-CSR view")
                for k in totals:
                    totals[k] += counts[k]
                resumed = {}
                if name == "flood":
                    node.save_checkpoint(path)
                    back = simnode.TorchSimNode(
                        SIMNODE_HOST, 0, id="sim-resumed", graph=g,
                        protocol=proto, seed=SIMNODE_SEED, mesh=mesh,
                        adaptive_k=ADAPTIVE_K)
                    try:
                        back.load_checkpoint(path)
                        same = all(torch.equal(a, b) for a, b in zip(
                            back.sim_state, node.sim_state))
                        if not same or (back.sim_round,
                                        back.sim_message_count) != (
                                node.sim_round, node.sim_message_count):
                            fail("adaptive node: the resumed node's state "
                                 "differs from the checkpointed node's")
                        again = back.run_until_coverage(0.99, max_rounds=64)
                        if again["rounds"] != 0:
                            fail(f"adaptive node: the resumed node ran "
                                 f"{again} past its target")
                    finally:
                        back.stop()
                    resumed = {"checkpoint_bytes": Path(path).stat().st_size,
                               "resumed_rounds": again["rounds"]}
                print(json.dumps({
                    "phase": "adaptive-ring-path", "run": f"node-{name}",
                    "layout": "hybrid", "build_s": build_s,
                    "run_until_coverage_s": wall, "summary": summary,
                    "launches": counts, **resumed,
                    "t_s": time.perf_counter() - T_START}), flush=True)
            finally:
                for n in (peer, node):
                    n.stop()
                for n in (peer, node):
                    if n.ident is not None:
                        n.join(timeout=10)
    return totals


def lane_recorder_path(bg, ring, segsum, threefry, rowsum, device_mod,
                       sharded, mesh_mod, engine, flightrec, MB) -> dict:
    """Phase 4u (e): 4t's batched call (4j's B = 1,024 batch on the 100K
    class's ``segment`` ring) with the recorder: rows before ``ici_bytes``
    equal to the single-device engine's on the same batch, all of them
    the reference's, ``ici_bytes`` its integer; the summary unchanged;
    its wall in turns with the bare call's. Returns the launches."""
    mesh = mesh_mod.ring_mesh(RING_SHARDS)
    sg = sharded.shard_graph(bg, mesh)
    sources = np.random.default_rng(0).integers(
        0, bg.n_nodes, size=BATCH_B).astype(np.int32)
    proto = MB.BatchFlood(method="segment")

    def call(recorder=None):
        return sharded.run_batch_until_coverage(
            sg, mesh, proto, proto.init(bg, sources, coverage_target=0.99),
            max_rounds=64, recorder=recorder)

    _, bare = call()
    zero_counts_4t(ring, segsum, threefry, rowsum, device_mod)
    _, out = call(flightrec.FlightRecorder(64))
    counts = ring_counts_4t(ring, segsum, threefry, rowsum, device_mod)
    fr = out.pop("flight_record")
    _, eng = engine.run_batch_until_coverage(
        bg, proto, proto.init(bg, sources, coverage_target=0.99), KEY,
        max_rounds=64, recorder=flightrec.FlightRecorder(64))
    ici = len(flightrec.REC_COLS) - 1
    if lane_summary(out) != lane_summary(bare):
        fail("recorded lane ring: the recorder changed the summary")
    if np_sha(fr.rows) != EXPECTED_LANE_REC["rows"] or int(
            fr.rows[0, ici]) != EXPECTED_LANE_REC["ici"]:
        fail("recorded lane ring: rows differ from the reference's")
    if not np.array_equal(fr.rows[:, :ici],
                          eng["flight_record"].rows[:, :ici]):
        fail("recorded lane ring: rows differ from the engine's")
    # The row sums: a round's coverage column, and the rows' sends column
    # once a run (a ring split over ranks sums its sends at the end).
    check_launches("recorded lane ring", counts, {
        "ring_shift": (RING_SHARDS - 1) * out["rounds"], "segsum": 0,
        "ring_segsum": 0, "threefry": 0, "rowsum": out["rounds"] + 1})
    walls = paired_walls(lambda: call(flightrec.FlightRecorder(64)), call,
                         pairs=NEW_REPS)
    print(json.dumps({
        "phase": "adaptive-ring-path", "run": "lane-recorder",
        "lanes": BATCH_B, "rounds": out["rounds"],
        "ici_bytes": int(fr.rows[0, ici]), "launches": counts,
        **{k: walls[k] for k in ("wall_s", "wall_s_without",
                                 "recorder_cost_s")},
        "t_s": time.perf_counter() - T_START}), flush=True)
    return counts


def planner_path(bg, serve, graph_mod, capacity, gpu: str) -> None:
    """Phase 4u (f): 4q's serving drive (4j's graph, ``BATCH_B`` lanes)
    measured as ``tools/fit_capacity.py`` measures a fit point: the
    graph's resident bytes plus the service's peak over its baseline; the
    plan (the checked-in H100 coefficients) within ``MODEL_TOLERANCE`` of
    it. Then a service budgeted between the plan now and the plan after a
    ``PLAN_GROW`` growth: the grow sheds with ``MemoryBudgetExceeded``,
    nothing queued and nothing allocated."""
    model = capacity.load_membudgets().get("capacity_model")
    if not model or not model.get("card"):
        fail("planner: no capacity model checked in")
    sched = serve.generate(serve.TrafficPattern(**SERVE_PATTERN),
                           bg.n_nodes, seed=0)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    svc = serve.SimService(bg, capacity=BATCH_B, queue_depth=BATCH_B,
                           chunk_rounds=4, seed=0)
    serve.drive(svc, sched)
    torch.cuda.synchronize()
    measured = capacity.resident_bytes(bg) + (
        torch.cuda.max_memory_allocated() - base)
    svc.close()
    del svc
    words = -(-BATCH_B // capacity.LANES_PER_WORD)
    planned = capacity.serving_footprint_bytes(
        bg.n_nodes_padded, bg.n_edges_padded, words)
    err = abs(planned - measured) / measured
    if err > capacity.MODEL_TOLERANCE:
        fail(f"planner: planned {planned} bytes, measured {measured} "
             f"({err:.1%} off, bound {capacity.MODEL_TOLERANCE:.0%})")
    grown = graph_mod.growth_capacity(bg.n_nodes + PLAN_GROW,
                                      bg.n_nodes_padded)
    after = capacity.serving_footprint_bytes(grown, bg.n_edges_padded,
                                             words)
    budget = (planned + after) / 2
    svc = serve.SimService(bg, capacity=BATCH_B, queue_depth=BATCH_B,
                           chunk_rounds=4, seed=0, hbm_budget_bytes=budget)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        svc.grow(PLAN_GROW)
        fail("planner: a growth planned over the budget was queued")
    except serve.MemoryBudgetExceeded as e:
        shed = e.to_dict()
    torch.cuda.synchronize()
    if torch.cuda.memory_allocated() != before or svc._mutations:
        fail("planner: the refused growth allocated or queued")
    if (shed["reason"], shed["planned_bytes"], shed["planned_capacity"]) \
            != ("memory_budget", after, grown):
        fail(f"planner: the shed {shed} does not carry the plan")
    svc.close()
    print(json.dumps({
        "phase": "adaptive-ring-path", "run": "planner", "card": gpu,
        "fitted_on": model["card"].get("nvidia_smi"),
        "lanes": BATCH_B, "n_pad": bg.n_nodes_padded,
        "e_pad": bg.n_edges_padded, "planned_bytes": planned,
        "measured_bytes": measured, "plan_error": err,
        "max_resid": model["max_resid"], "budget_bytes": budget,
        "grow_planned_bytes": after, "grow_capacity": grown, "shed": shed,
        "northstar": {k: capacity.northstar_plan()[k] for k in (
            "global_bytes", "recommended_shards")},
        "t_s": time.perf_counter() - T_START}), flush=True)


#: Phase 4v (slice 14): the ring split over rank processes on the one
#: card. Worlds run, the per-rank time limit of a launch, the ordering
#: check's hops, and the churn step of the reference worker's phase 3 at
#: 1M: nodes failed, dynamic slots, the runtime link and the target.
RANK_WORLDS = (8, 2)  # world 8 saves the checkpoint world 2 restores
RANK_TIMEOUT = 420
ORDERING_STEPS = 256
GATHER_ORDERING_STEPS = 64
RANK_CHURN = dict(fail=(3, N_NODES // 2), capacity=8,
                  link=([1], [N_NODES - 2]), target=0.9)
#: Launches of the cross-rank kernels and B1 per rank per 1M flood to
#: 0.99 (11 rounds, a pass a round): one gather a pass (B2 across ranks:
#: the pass's blocks in one exchange, no hop), and on the MXU layouts
#: (``mxu``; ``hybrid``'s remainder) one pass kernel a pass (B3 across
#: ranks: every step's sums in one launch), no B1.
RANK_LAUNCHES = {
    "segment": {"put": 0, "land": 0, "gather": 11, "pass_segsum": 0,
                "segsum": 0},
    "hybrid": {"put": 0, "land": 0, "gather": 11, "pass_segsum": 11,
               "segsum": 0},
    "mxu": {"put": 0, "land": 0, "gather": 11, "pass_segsum": 11,
            "segsum": 0}}
#: 4v's protocol runs (slice 15; 4t's ``ring_runs`` on a ring split over
#: ranks), by world and layout: at world 2 4t's SIR, PageRank and
#: push-sum on ``mxu`` and ``hybrid``, hop distance and election on
#: ``segment``; fewer at world 8. Both worlds walk 4t's cohort; world 2
#: also runs 4t's batched call on 4j's graph and the mesh PageRank node;
#: world 8 saves SIR's status (``save_orbax``) and world 2 restores it.
RANK_PROTOCOLS = {
    2: {"mxu": ("sir_exact", "pagerank", "pagerank_until", "pushsum",
                "pushsum_until"),
        "hybrid": ("sir_exact", "pagerank", "pagerank_until", "pushsum",
                   "pushsum_until"),
        "segment": ("hopdist", "leader")},
    8: {"mxu": ("sir_exact", "pagerank"), "segment": ("leader",)}}


def _rank_pass(layout: str, passes: int) -> dict:
    """A rank's launches for ``passes`` sum passes on the MXU layouts
    (``mxu``, ``hybrid``): a gather and a pass kernel each, no hop, no
    B1."""
    return {"put": 0, "land": 0, "gather": passes, "pass_segsum": passes,
            "segsum": 0}


#: Predicted, before the first run: each protocol run's launches by kernel
#: on every rank (every rank launches each step's kernel for its own
#: shards): 4t's counts (``ring_launch_want``) with its hops as puts; the
#: f32 totals' row sums two a total (the rank's ``[n_local, block]``,
#: then the gathered ``[1, 8]``); SIR's ``exact`` draws of the whole
#: population, two a round; push-sum's init draw. Rounds: 4t's records.
RANK_PROTOCOL_LAUNCHES = {
    **{f"sir_exact-{lay}": {**_rank_pass(lay, SIR_ROUNDS),
                            "threefry": 2 * SIR_ROUNDS, "rowsum": 0}
       for lay in ("mxu", "hybrid")},
    **{f"{name}-{lay}": {**_rank_pass(lay, rounds), "threefry": 0,
                         "rowsum": 6 * rounds}
       for lay in ("mxu", "hybrid")
       for name, rounds in (
           ("pagerank", RING_PR_ROUNDS),
           ("pagerank_until", EXPECTED_RING["pagerank_until"]["rounds"]))},
    **{f"{name}-{lay}": {**_rank_pass(lay, 2 * rounds), "threefry": 1,
                         "rowsum": 8 * rounds}
       for lay in ("mxu", "hybrid")
       for name, rounds in (
           ("pushsum", RING_PS_ROUNDS),
           ("pushsum_until", EXPECTED_RING["pushsum_until"]["rounds"]))},
    **{f"{name}-segment": {
        "put": 0, "land": 0, "gather": EXPECTED_ANALYTICS[key]["rounds"],
        "pass_segsum": 0, "segsum": 0, "threefry": 0, "rowsum": 0}
       for name, key in (("hopdist", "hop"), ("leader", "leader"))},
    "walk": {"put": 0, "land": 0, "gather": 0, "pass_segsum": 0,
             "segsum": 0, "threefry": 0, "rowsum": 0},
    "batch": {"put": 0, "land": 0, "gather": 10, "pass_segsum": 0,
              "segsum": 0, "threefry": 0, "rowsum": 0},
    "mesh_pagerank": {**_rank_pass("mxu", 3 + EXPECTED_MESH_PAGERANK[-1][
        "rounds"]), "threefry": 0, "rowsum": 6 * (
            3 + EXPECTED_MESH_PAGERANK[-1]["rounds"])}}
#: Which kernel row of the ``kernels`` line each protocol run's gathers
#: count in, by payload: f32 (the sum passes on ``mxu`` and ``hybrid``),
#: i32 (election's ids), bool (hop distance's OR), the lane words.
RANK_GATHER_ROW = {"mxu": "gather_f32", "hybrid": "gather_f32",
                   "mesh_pagerank": "gather_f32", "leader": "gather_i32",
                   "hopdist": "gather", "batch": "gather_lanes"}


#: Phase 4w (slice 16): what the ring split over ranks once refused, run
#: in 4v's rank processes after each layout's 4v runs, on the same shards
#: (built with their sender-CSR view where 4w runs): at world 2 the
#: ladder's adaptive rung (``benchmarks/ladder.py:495-520``,
#: ``adaptive_k=ADAPTIVE_K``) on every layout, the adaptive hop distance
#: on ``hybrid``, the recorded dense floods on every layout and (in the
#: batched call) 4t's lane ring recorded, and 4r(e)'s faulted flood on
#: ``mxu``; at world 8 the adaptive and faulted ``mxu`` floods and the hop
#: census by host. Each is held to 4u's and 4r(e)'s records.
ADAPTIVE_RANK_RUNS = {
    2: {"hybrid": ("adaptive", "adaptive_hop", "recorded"),
        "mxu": ("adaptive", "recorded", "faulted"),
        "segment": ("adaptive", "recorded")},
    8: {"mxu": ("adaptive", "faulted", "census")}}
#: The census's hosts at world 8: 4 ranks a host, as the reference's
#: ``examples/hierarchical_mesh_demo.py`` emulates 2 hosts of 4 chips.
CENSUS_PER_HOST = 4
#: The reference's hop classes of its lowered ring flood on 8 devices,
#: hosts of 4 (``tests/test_mesh2d_comm.py`` pins them): 6 pairs within a
#: host, 2 across, one permute. Regenerate (~5 s):
#:   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 python -c "from p2pnetwork_tpu.parallel import commviz as C; print(C.ring_hop_classes(C.lower_ring_flood_hlo(), lambda d: d // 4))"
EXPECTED_RING_HOP_CENSUS = {
    "within": 6, "cross": 2,
    "per_permute": [[(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7),
                     (7, 0)]]}


def _rank_or(layout: str, passes: int) -> dict:
    """A rank's launches for ``passes`` ring OR passes across ranks: a
    gather each, and a pass kernel each on the MXU layouts."""
    return {**RANK_LAUNCHES[layout], "gather": passes,
            "pass_segsum": 0 if layout == "segment" else passes,
            "threefry": 0, "rowsum": 0}


def _rank_hops(passes: int, segsum: int, threefry: int = 0) -> dict:
    """A rank's launches for ``passes`` passes hop by hop (a comm that
    wraps the rank comm: the faulted flood, the hop census): ``S - 1``
    puts and lands each, no gather, B1's stacked apply ``segsum``
    times."""
    hops = (RING_SHARDS - 1) * passes
    return {"put": hops, "land": hops, "gather": 0, "pass_segsum": 0,
            "segsum": segsum, "threefry": threefry, "rowsum": 0}


def rank_adaptive(sharded, mesh_mod, flightrec, chaos, telemetry, commviz,
                  multihost, models, sg, mesh, layout, checked) -> dict:
    """One rank's 4w runs on one layout (``ADAPTIVE_RANK_RUNS``): each
    checked (launches, syncs, wall), with its exchanges through the
    process group and its record (the rank's rows of the final state, the
    whole ring's summary)."""
    out = {}
    for name in ADAPTIVE_RANK_RUNS.get(mesh.world, {}).get(layout, ()):
        if name == "adaptive":
            def run():
                return sharded.flood_until_coverage(
                    sg, mesh, 0, coverage_target=0.99, max_rounds=64,
                    adaptive_k=ADAPTIVE_K)
        elif name == "adaptive_hop":
            def run():
                return sharded.hopdist_until_coverage(
                    sg, mesh, models.HopDistance(source=0),
                    coverage_target=0.99, adaptive_k=ADAPTIVE_K)
        elif name == "recorded":
            def run():
                return sharded.flood_until_coverage(
                    sg, mesh, 0, coverage_target=0.99, max_rounds=64,
                    recorder=flightrec.FlightRecorder(64))
        elif name == "faulted":
            spec = chaos.FaultSpec(chaos.FaultSchedule(**RING_FAULTS),
                                   "pallas")

            def run():
                return sharded.flood_until_coverage(
                    sg, mesh, 0, coverage_target=0.99, max_rounds=64,
                    comm=spec)
        else:  # the hop census by host
            def run():
                return commviz.ring_hop_census(
                    sg, mesh, multihost.host_of(mesh, CENSUS_PER_HOST))
        reg = telemetry.default_registry()
        before, e0 = fault_counts(reg), mesh_mod.EXCHANGES
        got, first_s, launches, syncs = checked(run)
        exchanges = mesh_mod.EXCHANGES - e0
        after = fault_counts(reg)
        rec = {"first_run_s": first_s, "launches": launches, "syncs": syncs,
               "exchanges": exchanges}
        if name == "census":
            rec["census"] = got
        else:
            state, res = got
            if name == "adaptive_hop":
                rec.update(dist=host_np(state[0]), frontier=host_np(state[1]),
                           round=int(state[2]))
            else:
                rec["seen"] = host_np(state)
            if name == "recorded":
                rec["rows"] = res.pop("flight_record").rows
            rec["out"] = res
            if name.startswith("adaptive"):
                rec["sparse"] = list(sharded.LAST_SPARSE_ROUNDS)
            if name == "faulted":
                rec["faults"] = {k: after[k] - before[k]
                                 for k in ("corrupt", "zero", "delay")}
            rec["wall_s"] = checked(run)[1]
        out[f"{name}-{layout}"] = rec
    return out


def rank_counts(ring, segsum, threefry=None, rowsum=None) -> dict:
    out = {"put": ring.PUT_LAUNCHES, "land": ring.LAND_LAUNCHES,
           "gather": ring.GATHER_LAUNCHES,
           "pass_segsum": ring.PASS_SEGSUM_LAUNCHES,
           "segsum": segsum.LAUNCHES}
    if threefry is not None:
        out.update(threefry=threefry.LAUNCHES, rowsum=rowsum.LAUNCHES)
    return out


def zero_rank_counts(ring, segsum, device_mod, threefry=None,
                     rowsum=None) -> None:
    ring.PUT_LAUNCHES = ring.LAND_LAUNCHES = 0
    ring.GATHER_LAUNCHES = ring.PASS_SEGSUM_LAUNCHES = 0
    segsum.LAUNCHES = 0
    device_mod.SYNCS = 0
    if threefry is not None:
        threefry.LAUNCHES = rowsum.LAUNCHES = 0


def host_ms(fn, reps: int) -> float:
    """Mean host ms of ``fn()`` with a synchronise after each call: for
    the plain versions, which wait on the host anyway."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def peer_copy(ring, mesh, x, out):
    """The library yardstick of a forward put: ``copy_`` (a
    ``cudaMemcpyAsync``) of the local shards into ``out[1:]`` and of the
    boundary shard into the next rank's slot, the same bytes, no
    signal."""
    shard = x[0].numel() * x.element_size()
    chan = ring.peer_channel(mesh, shard)
    slot = torch.as_tensor(ring._Interface(
        chan.slot_address(mesh.next_rank, False, chan.seq[0] + 1), shard),
        device=x.device)
    src = x.view(torch.uint8).reshape(x.shape[0], -1)
    dst = out.view(torch.uint8).reshape(x.shape[0], -1)

    def run():
        dst[1:].copy_(src[:-1])
        slot.copy_(src[-1])

    return run


def rank_put_rows(ring, mesh_mod, mesh, flush) -> list:
    """B2's hop across ranks (``ring_put``: the faulted hops and the
    re-mask's) at this rank's bool ``[n_local, 125008]``: the kernel and
    its plain version against the global ``torch.roll`` of the stacked
    blocks (gathered through the group), then timed, with
    ``hop_floor_ms`` the hop of a 16-byte shard."""
    import torch.distributed as dist

    gen = torch.Generator(device="cuda").manual_seed(5 + mesh.rank)
    L, lo = mesh.n_local, mesh.shard_lo
    # The same hop with 16 bytes a shard: what a hop costs with no bytes
    # to speak of (the launches, the waits, the ranks' hand-over).
    tiny = torch.zeros((L, 16), dtype=torch.bool, device="cuda")
    floor_ms = cuda_times(lambda: ring.ring_put(tiny, mesh), 50, flush)
    bits = torch.randint(0, 1 << 20, (L, RING_BLOCK), generator=gen,
                         device="cuda", dtype=torch.int32)
    x = bits % 2 == 1
    whole = mesh_mod.gather_shards(mesh, x.view(torch.uint8))
    want = torch.roll(whole, 1, 0)[lo:lo + L].view(torch.bool)
    got, plain = ring.ring_put(x, mesh), ring.ring_put_plain(x, mesh)
    if not torch.equal(got, want) or not torch.equal(plain, want):
        fail(f"ring_put bool {list(x.shape)} differs from the global roll "
             f"on rank {mesh.rank}")
    out = torch.empty_like(x)
    nbytes = 2 * x.numel() * x.element_size()
    torch.cuda.synchronize()
    dist.barrier()
    library = cuda_times(peer_copy(ring, mesh, x, out), 50, flush)
    torch.cuda.synchronize()
    dist.barrier()
    return [{
        "kernel": "ring_put", "entry": "bool", "shape": list(x.shape),
        "world": mesh.world,
        "ms": cuda_times(lambda: ring.ring_put(x, mesh), 50, flush),
        "plain_ms": host_ms(lambda: ring.ring_put_plain(x, mesh), 10),
        "library_ms": library,
        "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
        "hop_floor_ms": floor_ms, "max_abs_err": 0.0}]


def rank_move_row(ring, mesh, flush) -> dict:
    """A pass's movement both ways at this rank's bool ``[n_local,
    125008]`` frontier: ``S - 1`` chained ``ring_put`` hops against one
    ``ring_gather``, each also with 16-byte shards (what the hand-overs
    cost with no bytes to speak of), in turns (hops, gather, gather,
    hops; the means of each pair)."""
    L, S = mesh.n_local, mesh.n_shards
    x = torch.zeros((L, RING_BLOCK), dtype=torch.bool, device="cuda")
    tiny = torch.zeros((L, 16), dtype=torch.bool, device="cuda")

    def hops(y):
        def run():
            z = y
            for _ in range(S - 1):
                z = ring.ring_put(z, mesh)
        return run

    def gather(y):
        return lambda: ring.ring_gather(y, mesh)

    out = {"kernel": "ring_move", "world": mesh.world,
           "shape": [L, RING_BLOCK], "hops": S - 1}
    for name, y in (("", x), ("floor_", tiny)):
        first = cuda_times(hops(y), 20, flush)
        g1 = cuda_times(gather(y), 20, flush)
        g2 = cuda_times(gather(y), 20, flush)
        last = cuda_times(hops(y), 20, flush)
        out[f"{name}hops_ms"] = (first + last) / 2
        out[f"{name}gather_ms"] = (g1 + g2) / 2
        out[f"{name}turns_ms"] = [first, g1, g2, last]
    return out


def nccl_group(mesh):
    """An NCCL group over the ranks (the gather's library call), or the
    error NCCL gave: two ranks on one card are refused."""
    import torch.distributed as dist

    try:
        grp = dist.new_group(backend="nccl")
        probe = torch.zeros(mesh.world, device="cuda")
        dist.all_gather_into_tensor(probe, probe[mesh.rank:mesh.rank + 1],
                                    group=grp)
        torch.cuda.synchronize()
        return grp, None
    except Exception as e:  # noqa: BLE001 - the row records NCCL's answer
        return None, f"{type(e).__name__}: {' '.join(str(e).split())[:400]}"


def rank_gather_rows(ring, mesh_mod, mesh, flush, payloads, nccl) -> list:
    """B2 across ranks a pass at a time (``ring_gather``) on ``payloads``
    (``(entry, x)`` pairs, this rank's stacks): the kernel and its plain
    version against the whole ring's stack in ring order, twice (gathered
    through the group), then timed; the library call is NCCL's
    ``all_gather_into_tensor`` where ``nccl`` holds a group, else the row
    carries NCCL's error (``library_error``)."""
    import torch.distributed as dist

    grp, err = nccl
    rows = []
    for entry, x in payloads:
        wire = x.view(torch.uint8) if x.dtype == torch.bool else x
        whole = mesh_mod.gather_shards(mesh, wire)
        want = torch.cat([whole, whole]).view(x.dtype)
        got = ring.ring_gather(x, mesh)
        plain = ring.ring_gather_plain(x, mesh)
        if not torch.equal(got, want) or not torch.equal(plain, want):
            fail(f"ring_gather {entry} {list(x.shape)} differs from the "
                 f"ring's stack on rank {mesh.rank}")
        shard = x[0].numel() * x.element_size()
        library = None
        if grp is not None:
            flat = wire.reshape(-1)
            out = torch.empty(mesh.world * flat.numel(), dtype=flat.dtype,
                              device="cuda")
            torch.cuda.synchronize()
            dist.barrier()
            library = cuda_times(lambda: dist.all_gather_into_tensor(
                out, flat, group=grp), 50, flush)
            torch.cuda.synchronize()
            dist.barrier()
        rows.append({
            "kernel": "ring_gather", "entry": entry, "shape": list(x.shape),
            "world": mesh.world,
            "ms": cuda_times(lambda: ring.ring_gather(x, mesh), 50, flush),
            "plain_ms": host_ms(lambda: ring.ring_gather_plain(x, mesh), 10),
            "library_ms": library, "library_error": err,
            # The rank's stack read once, its [2S, ...] slab written once.
            "bound_ms": 1e3 * (mesh.n_local + 2 * mesh.n_shards) * shard
            / HBM_BYTES_PER_S, "bound_by": "bytes", "max_abs_err": 0.0})
    return rows


def one_rank_at_a_time(mesh, fn):
    """``fn()``'s value, run by each rank in turn while the others wait in
    a barrier: a kernel that waits on no peer timed without the other
    ranks' contexts on the card."""
    import torch.distributed as dist

    value = None
    for r in range(mesh.world):
        torch.cuda.synchronize()
        dist.barrier()
        if mesh.rank == r:
            value = fn()
    torch.cuda.synchronize()
    dist.barrier()
    return value


def rank_pass_rows(ring, mesh, sg, flush) -> list:
    """B3 across ranks a pass at a time (``ring_pass_segsum_*``) on this
    rank's real ``mxu`` buckets of every ring step, with the rows'
    extents, over a gathered slab, against its plain version (OR
    bit-equal, integer sums exact), then timed one rank at a time (it
    waits on no peer); the library call one ``scatter_add_`` of every
    step's terms, gathered up front."""
    gen = torch.Generator(device="cuda").manual_seed(9 + mesh.rank)
    src, dst, mask, extent = (sg.mxu_src, sg.mxu_dst, sg.mxu_mask,
                              sg.mxu_extent)
    L, S, nb, w = src.shape
    lo, block = mesh.shard_lo, sg.mxu_block
    args = (src, dst, mask, block)
    live_slots = int(mask.sum().item())
    slots = int(extent.sum().item())
    dst64 = dst.permute(0, 2, 1, 3).reshape(L * nb, S * w).long()
    rows = []
    for entry, sig in (
            ("or", torch.rand((L, sg.block), generator=gen,
                              device="cuda") < 0.1),
            ("sum", torch.randint(-8, 8, (L, sg.block), generator=gen,
                                  device="cuda").to(torch.float32))):
        fn = getattr(ring, f"ring_pass_segsum_{entry}")
        plain = getattr(ring, f"ring_pass_segsum_{entry}_plain")
        slab = ring.ring_gather(sig, mesh).clone()
        want = plain(ring.ring_gather_plain(sig, mesh), lo, *args)
        for ext in (extent, None):
            if not torch.equal(fn(slab, lo, *args, extent=ext), want):
                fail(f"ring_pass_segsum_{entry} on the real buckets "
                     f"(extents {ext is not None}) differs from its plain "
                     f"version on rank {mesh.rank}")
        elem = sig.element_size()
        sig_bytes = S * sg.block * elem  # the pass reads each block once
        least, bound_by = bound(slots, live_slots,
                                sig_bytes + extent.numel() * 4,
                                L * nb * block * elem)
        terms = torch.stack([pregathered(ring.ring_rows(slab, lo, L, t),
                                         src[:, t], mask[:, t]).reshape(
                                             L, nb, w) for t in range(S)],
                            dim=2).reshape(L * nb, S * w)
        lib_out = torch.zeros(L * nb, block, device="cuda")

        def timed():
            return {
                "ms": cuda_times(lambda: fn(slab, lo, *args, extent=extent),
                                 50, flush),
                "full_width_ms": cuda_times(lambda: fn(slab, lo, *args), 20,
                                            flush),
                "plain_ms": host_ms(lambda: plain(slab, lo, *args), 3),
                "library_ms": cuda_times(
                    lambda: lib_out.scatter_add_(1, dst64, terms), 50,
                    flush)}

        rows.append({
            "kernel": "ring_pass_segsum", "entry": entry,
            "shape": [L, S, nb, w], "world": mesh.world,
            "live_slots": live_slots, "slots": slots,
            **one_rank_at_a_time(mesh, timed),
            "bound_ms": least, "bound_by": bound_by, "max_abs_err": 0.0})
    return rows


def rank_ordering(ring, mesh, steps: int) -> dict:
    """``steps`` hops of an i32 ``[n_local, 125008]`` payload that names
    its shard and step, both directions, the last rank held back by a
    sleep kernel before each put and on the host every 64 steps: every
    block of every hop against the global roll (one count, read once)."""
    L, lo, S = mesh.n_local, mesh.shard_lo, mesh.n_shards
    g = torch.arange(S, device="cuda", dtype=torch.int32)[:, None]
    j = torch.arange(RING_BLOCK, device="cuda", dtype=torch.int32)[None, :]
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    t0 = time.perf_counter()
    for s in range(steps):
        if mesh.rank == mesh.world - 1:
            torch.cuda._sleep(100_000)
            if s % 64 == 0:
                time.sleep(0.05)
        whole = g * 1_000_003 + s * 7919 + j
        reverse = s % 3 == 2
        got = ring.ring_put(whole[lo:lo + L].contiguous(), mesh, reverse)
        bad += (got != torch.roll(whole, -1 if reverse else 1,
                                  0)[lo:lo + L]).sum()
    n_bad = int(bad.item())
    return {"steps": steps, "bad": n_bad, "s": time.perf_counter() - t0}


def rank_payloads(mesh) -> list:
    """The gather's kernel rows' payloads, this rank's ``[n_local,
    125008]`` stacks: the bool frontier at every world, and at world 2 the
    f32 sum passes' and election's i32 ids."""
    gen = torch.Generator(device="cuda").manual_seed(7 + mesh.rank)
    bits = torch.randint(0, 1 << 20, (mesh.n_local, RING_BLOCK),
                         generator=gen, device="cuda", dtype=torch.int32)
    out = [("bool", bits % 2 == 1)]
    if mesh.world == 2:
        out += [("f32", bits.to(torch.float32)), ("i32", bits)]
    return out


def rank_gather_ordering(ring, mesh, steps: int) -> dict:
    """``steps`` gathers of an i32 ``[n_local, 125008]`` payload that names
    its shard and gather, the last rank held back by a sleep kernel before
    each and on the host every 16: every step's rows of every gather
    against the global roll (one count, read once). Two gathers may be in
    flight; the third waits for the first's readers."""
    L, lo, S = mesh.n_local, mesh.shard_lo, mesh.n_shards
    g = torch.arange(S, device="cuda", dtype=torch.int32)[:, None]
    j = torch.arange(RING_BLOCK, device="cuda", dtype=torch.int32)[None, :]
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    t0 = time.perf_counter()
    for s in range(steps):
        if mesh.rank == mesh.world - 1:
            torch.cuda._sleep(100_000)
            if s % 16 == 0:
                time.sleep(0.05)
        whole = g * 1_000_003 + s * 7919 + j
        slab = ring.ring_gather(whole[lo:lo + L].contiguous(), mesh)
        for t in range(S):
            bad += (ring.ring_rows(slab, lo, L, t)
                    != torch.roll(whole, t, 0)[lo:lo + L]).sum()
    n_bad = int(bad.item())
    return {"steps": steps, "bad": n_bad, "s": time.perf_counter() - t0}


def rank_record(name, out) -> dict:
    """A rank's record of one of 4t's runs (``ring_runs``): its stats or
    summary (the whole ring's, the same on every rank) and its state's
    rows (this rank's shards; the parent stacks them in rank order)."""
    state, stats = out
    if name.startswith("pushsum"):
        state = state[0]
    elif name == "hopdist":
        state = state[0]
    rec = {"rows": host_np(state)}
    if isinstance(stats, dict) and "rounds" in stats:
        rec["summary"] = dict(stats)
    else:
        rec["stats"] = stat_lists(stats)
    return rec


def rank_protocols(sharded, models, sg, mesh, layout, checked) -> dict:
    """This world's 4t runs on one layout (``RANK_PROTOCOLS``), each
    checked (counts, wall) and recorded (:func:`rank_record`)."""
    runs = ring_runs(sharded, models, sg, mesh, KEY, layout)
    out = {}
    for name in RANK_PROTOCOLS[mesh.world].get(layout, ()):
        got, wall, launches, syncs = checked(runs[name][0])
        out[f"{name}-{layout}"] = {**rank_record(name, got), "wall_s": wall,
                                   "launches": launches, "syncs": syncs}
    return out


def rank_ring(reps: int, ckpt_dir: str) -> dict:
    """One rank of phase 4v (run by ``multihost.launch``): phase 4's
    graph, this rank's shards of the 8-shard ring, the dense flood to
    0.99 on each layout (counts, syncs, walls), the churn step, the
    kernel rows, the ordering check and 4t's gossip rung; then (slice
    15) this world's protocol runs (``RANK_PROTOCOLS``), the walk, at
    world 8 SIR's status saved into ``ckpt_dir`` and at world 2 restored
    from it, 4t's batched call and the mesh PageRank node. Prints
    nothing: the parent checks and prints."""
    import torch.distributed as dist

    from p2pnetwork_tpu_torch import _device, models, telemetry
    from p2pnetwork_tpu_torch.chaos import device as chaos
    from p2pnetwork_tpu_torch.ops import ring, rowsum, segsum, threefry
    from p2pnetwork_tpu_torch.parallel import commviz
    from p2pnetwork_tpu_torch.parallel import mesh as mesh_mod
    from p2pnetwork_tpu_torch.parallel import multihost, sharded
    from p2pnetwork_tpu_torch.sim import checkpoint, flightrec, simnode
    from p2pnetwork_tpu_torch.sim import graph as graph_mod

    Gossip = models.Gossip
    mesh = multihost.hierarchical_ring_mesh(n_shards=RING_SHARDS)
    t0 = time.perf_counter()
    g = graph_mod.watts_strogatz(N_NODES, 10, 0.1, seed=0)
    torch.cuda.synchronize()
    res = {"rank": mesh.rank, "world": mesh.world, "shard_lo": mesh.shard_lo,
           "device": str(mesh.device), "graph_s": time.perf_counter() - t0,
           "floods": {}, "rows": [], "protocols": {}, "adaptive": {}}
    csr = ADAPTIVE_RANK_RUNS.get(mesh.world, {})
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")

    def checked(run):
        zero_rank_counts(ring, segsum, _device, threefry, rowsum)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, rank_counts(
            ring, segsum, threefry, rowsum), _device.SYNCS

    for layout, kw in RING_LAYOUTS:
        t0 = time.perf_counter()
        # 4w's runs on this layout need the sender-CSR view.
        sg = sharded.shard_graph(g, mesh, source_csr=layout in csr, **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if layout == "mxu":
            res["rows"] += rank_pass_rows(ring, mesh, sg, flush)

        def run():
            return sharded.flood_until_coverage(
                sg, mesh, 0, coverage_target=0.99, max_rounds=64)

        (seen, out), first_s, launches, syncs = checked(run)
        walls = [checked(run)[1] for _ in range(reps)]
        rec = {"out": out, "seen": seen.cpu().numpy(), "launches": launches,
               "syncs": syncs, "build_s": build_s, "first_run_s": first_s,
               "wall_s": statistics.median(walls), "wall_s_all": walls}
        if layout == "segment":
            (seen_c, out_c), churn_s, churn_launches, _ = checked(
                lambda: rank_churn(sharded, sg, mesh))
            rec["churn"] = {"out": out_c, "seen": seen_c.cpu().numpy(),
                            "s": churn_s, "launches": churn_launches}
        res["floods"][layout] = rec
        t0 = time.perf_counter()
        res["protocols"].update(rank_protocols(sharded, models, sg, mesh,
                                               layout, checked))
        if layout == "mxu" and mesh.world == 8:
            # SIR's final status saved by every rank (its own shard).
            status = torch.from_numpy(
                res["protocols"]["sir_exact-mxu"]["rows"]).cuda()
            checkpoint.save_orbax(ckpt_dir, {"status": status}, KEY,
                                  SIR_ROUNDS)
        res["floods"][layout]["protocols_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["adaptive"].update(rank_adaptive(
            sharded, mesh_mod, flightrec, chaos, telemetry, commviz,
            multihost, models, sg, mesh, layout, checked))
        res["floods"][layout]["adaptive_s"] = time.perf_counter() - t0
        del sg
        torch.cuda.empty_cache()
    if mesh.world == 2:
        t0 = time.perf_counter()
        template = {"status": torch.zeros((mesh.n_local, RING_BLOCK),
                                          dtype=torch.int32, device="cuda")}
        restored, key, rnd, _ = checkpoint.load_orbax(ckpt_dir, template)
        res["restored"] = {"rows": host_np(restored["status"]),
                           "key": key.tolist(), "round": rnd,
                           "s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    sg = sharded.shard_graph(g, mesh, source_csr=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    run, _ = ring_walk_run(sharded, models.RandomWalks, sg, mesh, KEY)
    ((pos, start, visited), stats), wall, launches, syncs = checked(run)
    res["protocols"]["walk"] = {
        "rows": host_np(visited), "pos": host_np(pos),
        "stats": stat_lists(stats), "wall_s": wall, "launches": launches,
        "syncs": syncs, "build_s": build_s}
    del sg, pos, start, visited
    if mesh.world == 2:
        node_walls = {}
        events, wall, launches, syncs = checked(lambda: mesh_pagerank(
            simnode.TorchSimNode, g, models.PageRank, mesh, node_walls,
            layout="mxu"))
        res["protocols"]["mesh_pagerank"] = {
            "events": events, "wall_s": wall, "launches": launches,
            "syncs": syncs, "node_walls": node_walls}
    nccl = nccl_group(mesh)
    res["rows"] += rank_put_rows(ring, mesh_mod, mesh, flush)
    res["rows"] += rank_gather_rows(
        ring, mesh_mod, mesh, flush, rank_payloads(mesh), nccl)
    res["move"] = rank_move_row(ring, mesh, flush)
    res["ordering"] = rank_ordering(ring, mesh, ORDERING_STEPS)
    res["gather_ordering"] = rank_gather_ordering(ring, mesh,
                                                  GATHER_ORDERING_STEPS)
    del g
    torch.cuda.empty_cache()
    gba = graph_mod.barabasi_albert(**RING_GOSSIP_GRAPH)
    sg = sharded.shard_graph(gba, mesh)
    (vals, stats), gossip_s, launches, syncs = checked(
        lambda: sharded.gossip(sg, mesh, Gossip(alpha=0.5), KEY,
                               GOSSIP_ROUNDS))
    res["gossip"] = {"stats": stat_lists(stats),
                     "values": vals.cpu().numpy(), "first_run_s": gossip_s,
                     "launches": launches, "syncs": syncs}
    del sg, gba
    if mesh.world == 2:
        res["protocols"]["batch"], lane_row, lanes_rec = rank_batch(
            sharded, models, graph_mod, mesh, mesh_mod, ring, checked,
            flush, nccl)
        res["adaptive"]["lanes_recorded-segment"] = lanes_rec
        res["rows"].append(lane_row)
    del flush
    return res


def rank_batch(sharded, models, graph_mod, mesh, mesh_mod, ring, checked,
               flush, nccl):
    """4t's batched call on a ring split over ranks: 4j's graph, its
    1,024 lanes on the ``segment`` ring, the rank's lane words ``[n_local,
    32, 12512]`` B2's payload across ranks (``EXPECTED_BATCH``'s first
    call; the batch comes back whole on every rank). Then B2 across ranks
    (the gather) on those words as a kernel row. Then (4w) the same call with the
    ring's recorder, its record third."""
    from p2pnetwork_tpu_torch.models import messagebatch as MB
    from p2pnetwork_tpu_torch.sim import flightrec

    t0 = time.perf_counter()
    bg = graph_mod.watts_strogatz(BATCH_N, 10, 0.1, seed=0, source_csr=True)
    sg = sharded.shard_graph(bg, mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sources = np.random.default_rng(0).integers(
        0, bg.n_nodes, size=BATCH_B).astype(np.int32)
    proto = MB.BatchFlood(method="segment")

    def call(recorder=None):
        return sharded.run_batch_until_coverage(
            sg, mesh, proto, proto.init(bg, sources, coverage_target=0.99),
            max_rounds=64, recorder=recorder)

    e0 = mesh_mod.EXCHANGES
    (state, out), wall, launches, syncs = checked(call)
    exchanges = mesh_mod.EXCHANGES - e0
    out["lane_messages"] = MB.lane_messages(bg, state).cpu().numpy()
    out["seen"] = state.seen.cpu().numpy()
    rec = {"summary": lane_summary(out, ("lane_messages", "seen")),
           "wall_s": wall, "launches": launches, "syncs": syncs,
           "build_s": build_s, "exchanges": exchanges}
    e0 = mesh_mod.EXCHANGES
    (_, out_r), wall_r, launches_r, syncs_r = checked(
        lambda: call(flightrec.FlightRecorder(64)))
    lanes_rec = {"rows": out_r.pop("flight_record").rows,
                 "summary": lane_summary(out_r), "bare": lane_summary(out),
                 "first_run_s": wall_r, "launches": launches_r,
                 "syncs": syncs_r, "exchanges": mesh_mod.EXCHANGES - e0,
                 "bare_exchanges": exchanges}
    stack = sharded.shard_lanes(sg, state.seen)
    row = rank_gather_rows(ring, mesh_mod, mesh, flush, [("lanes", stack)],
                           nccl)[0]
    return rec, row, lanes_rec


def rank_churn(sharded, sg, mesh):
    """The reference worker's churn step at 1M: nodes failed, dynamic
    slots, a runtime link, then the flood to ``RANK_CHURN['target']``."""
    sgc = sharded.with_capacity(sharded.fail_nodes(
        sg, list(RANK_CHURN["fail"])), RANK_CHURN["capacity"])
    sgc = sharded.connect(sgc, *RANK_CHURN["link"])
    return sharded.flood_until_coverage(
        sgc, mesh, 0, coverage_target=RANK_CHURN["target"], max_rounds=64)


def rank_fails() -> None:
    """A rank target that raises at once (phase 4v's failure check)."""
    raise RuntimeError("a rank fails on purpose")


def canon(value) -> str:
    """A value as a string that equal values share: an array's sha256,
    else its JSON."""
    if isinstance(value, np.ndarray):
        return np_sha(value)
    return json.dumps(value, sort_keys=True)


def check_rank_protocols(world: int, parts: list, world1: dict):
    """Slice 15's runs of 4v at ``world`` (``rank_ring``'s
    ``protocols``): every rank's launches ``RANK_PROTOCOL_LAUNCHES``', its
    summaries the other ranks', the rows gathered in rank order held to
    4t's records (``EXPECTED_SIR``, ``EXPECTED_RING`` within ``RING_TOL``,
    ``EXPECTED_ANALYTICS``, ``EXPECTED_RING_WALK``, ``EXPECTED_BATCH``,
    ``EXPECTED_MESH_PAGERANK``) and to world 1's (4t's records: the
    integer results by digest; PageRank's and push-sum's f32 stats within
    ``RING_TOL``, as the card's f32 atomics add in a varying order).
    Returns the launches summed over the ranks by kernel row, each run's
    walls and the largest f32 difference."""
    counts, walls, err = collections.Counter(), {}, 0.0
    for name in parts[0]["protocols"]:
        recs = [p["protocols"][name] for p in parts]
        label = f"rank {name} at world {world}"
        base, _, layout = name.partition("-")
        for key in ("stats", "summary", "events", "pos"):
            if key in recs[0] and any(canon(r[key]) != canon(recs[0][key])
                                      for r in recs):
                fail(f"{label}: the ranks' {key} disagree")
        for r in recs:
            check_launches(label, r["launches"],
                           RANK_PROTOCOL_LAUNCHES[name])
            row = RANK_GATHER_ROW.get(layout, RANK_GATHER_ROW.get(base))
            counts[row or "gather"] += r["launches"]["gather"]
            counts["put"] += r["launches"]["put"]
            counts["pass_segsum_sum"] += r["launches"]["pass_segsum"]
            counts["segsum_sum"] += r["launches"]["segsum"]
            counts["threefry"] += r["launches"]["threefry"]
            counts["rowsum"] += r["launches"]["rowsum"]
        walls[name] = [r["wall_s"] for r in recs]
        rows = (np.concatenate([r["rows"] for r in recs])
                if "rows" in recs[0] else None)
        rec = recs[0]
        if base == "sir_exact":
            got = {**rec["stats"], "status_sha256": np_sha(rows)}
            check_run(label, got, EXPECTED_SIR)
        elif base in ("pagerank", "pushsum"):
            err = max(err, check_close(label, rec["stats"],
                                       EXPECTED_RING[base], RING_TOL[base]))
            got = rec["stats"]
        elif base in ("pagerank_until", "pushsum_until"):
            err = max(err, check_close(label, rec["summary"],
                                       EXPECTED_RING[base],
                                       RING_TOL.get(base, {})))
            got = rec["summary"]
        elif base in ("hopdist", "leader"):
            got = {"rounds": rec["summary"]["rounds"],
                   "messages": rec["summary"]["messages"],
                   "sha256": np_sha(rows)}
            want = EXPECTED_ANALYTICS["hop" if base == "hopdist"
                                      else "leader"]
            check_run(label, got, {k: want[k] for k in got})
        elif base == "walk":
            got = {**rec["stats"], "pos_sha256": np_sha(rec["pos"]),
                   "visited_sha256": np_sha(rows)}
            check_run(label, got, EXPECTED_RING_WALK)
        elif base == "batch":
            got = rec["summary"]
            check_run(label, got, EXPECTED_BATCH["first"])
        else:  # the mesh PageRank node
            got = rec["events"]
            if len(got) != len(EXPECTED_MESH_PAGERANK):
                fail(f"{label} fired {len(got)} events, the reference "
                     f"{len(EXPECTED_MESH_PAGERANK)}")
            for i, (e, w) in enumerate(zip(got, EXPECTED_MESH_PAGERANK)):
                err = max(err, check_close(f"{label} event {i}", e, w,
                                           RING_TOL["mesh_pagerank"]))
        one = world1.get(name)
        if one is not None:  # 4t's run of the same name at world 1
            check_close(f"{label} against world 1", got, one,
                        RING_TOL.get(base, {}))
    return counts, walls, err


def check_rank_adaptive(world: int, parts: list, sparse1: dict):
    """Phase 4w's runs at ``world`` (``rank_ring``'s ``adaptive``): every
    rank's summaries, sparse rounds, census and exchanges the other
    ranks', the rows gathered in rank order held to 4u's records
    (``EXPECTED_1M``, ``EXPECTED_RING_SEEN``, ``EXPECTED_ADAPTIVE_HOP``,
    ``EXPECTED_RING_REC``, ``EXPECTED_LANE_REC``) and 4r(e)'s
    (``EXPECTED_RING_FAULTED``, its fault counts on every rank), the
    sparse rounds to 4u's one-process run's (``sparse1``), the census to
    the reference's (``EXPECTED_RING_HOP_CENSUS``), each rank's launches
    and exchanges to their prediction. Prints a ``rank-adaptive-path``
    line; returns the launches summed over the ranks by kernel row."""
    counts = collections.Counter()
    record = {}
    sched_sites = None
    for name in parts[0]["adaptive"]:
        recs = [p["adaptive"][name] for p in parts]
        base, _, layout = name.partition("-")
        label = f"rank {name} at world {world}"
        for key in ("out", "sparse", "census", "summary", "exchanges",
                    "round", "faults", "rows"):
            if key in recs[0] and any(canon(r[key]) != canon(recs[0][key])
                                      for r in recs):
                fail(f"{label}: the ranks' {key} disagree")
        rec = recs[0]

        def rows(key):
            return np.concatenate([r[key] for r in recs])

        rounds = (rec["out"]["rounds"] if "out" in rec else
                  rec["summary"]["rounds"] if "summary" in rec else 1)
        threefry = [0] * len(recs)
        if base == "adaptive":
            if rec["out"] != EXPECTED_1M or np_sha(rows("seen")) \
                    != EXPECTED_RING_SEEN:
                fail(f"{label} returned {rec['out']}: not 4u's records")
            want_x = 2 * rounds + 3
        elif base == "adaptive_hop":
            want = EXPECTED_ADAPTIVE_HOP
            if (rec["out"], np_sha(rows("dist")), np_sha(rows("frontier")),
                    rec["round"]) != (want["summary"], want["dist"],
                                      want["frontier"], want["round"]):
                fail(f"{label} returned {rec['out']}: not 4u's records")
            want_x = 2 * rounds + 2
        elif base == "recorded":
            if rec["out"] != EXPECTED_1M or np_sha(rows("seen")) \
                    != EXPECTED_RING_SEEN:
                fail(f"{label} returned {rec['out']}: not 4u's records")
            ici = rec["rows"][0, -1]
            if np_sha(rec["rows"]) != EXPECTED_RING_REC["rows"] or int(
                    ici) != EXPECTED_RING_REC["ici"]:
                fail(f"{label}: rows differ from 4u's (ici_bytes {ici})")
            want_x = rounds + 1
        elif base == "faulted":
            want = dict(EXPECTED_RING_FAULTED)
            want_sha, want_faults = want.pop("seen_sha256"), want.pop(
                "faults")
            check_run(label, rec["out"], want)
            if np_sha(rows("seen")) != want_sha:
                fail(f"{label}: seen differs from 4r(e)'s")
            for r in recs:  # every rank replays the whole ring's sites
                if r["faults"] != want_faults:
                    fail(f"{label} counted {r['faults']}, 4r(e) "
                         f"{want_faults}")
            if sched_sites is None:
                from p2pnetwork_tpu_torch.chaos import device as chaos

                sched_sites = chaos.FaultSchedule(**RING_FAULTS) \
                    .sites_between(0, rounds, RING_SHARDS - 1, RING_SHARDS)
            n_local = RING_SHARDS // world
            threefry = [sum(1 for _, _, d, kind in sched_sites
                            if kind == "corrupt"
                            and d // n_local == p["shard_lo"] // n_local)
                        for p in parts]
            want_x = rounds + 1
        elif base == "census":
            got = rec["census"]
            if {k: got[k] for k in EXPECTED_RING_HOP_CENSUS} \
                    != EXPECTED_RING_HOP_CENSUS or (
                        got["hops"], got["hops_within"], got["hops_cross"],
                        got["exchanges"], got["exchanges_cross"]) != (
                        RING_SHARDS - 1, 6 * (RING_SHARDS - 1),
                        2 * (RING_SHARDS - 1), 1, 1):
                fail(f"{label}: {got} differs from the reference's "
                     f"{EXPECTED_RING_HOP_CENSUS}")
            want_x = 1
        else:  # the recorded lane ring
            if rec["summary"] != rec["bare"]:
                fail(f"{label}: the recorder changed the summary")
            ici = rec["rows"][0, -1]
            if np_sha(rec["rows"]) != EXPECTED_LANE_REC["rows"] or int(
                    ici) != EXPECTED_LANE_REC["ici"]:
                fail(f"{label}: rows differ from 4u's (ici_bytes {ici})")
            want_x = rec["bare_exchanges"]
        if base.startswith("adaptive") and rec["sparse"] != sparse1.get(
                name):
            fail(f"{label}: sparse rounds {rec['sparse']}, one process "
                 f"{sparse1.get(name)}")
        if rec["exchanges"] != want_x:
            fail(f"{label}: {rec['exchanges']} exchanges, want {want_x}")
        for r, n3 in zip(recs, threefry):
            if base == "lanes_recorded":
                want_l = {"put": 0, "land": 0, "gather": rounds,
                          "pass_segsum": 0, "segsum": 0, "threefry": 0,
                          "rowsum": rounds + 1}
            elif base == "faulted":
                # A fault-spec comm hops one step at a time (ring_put) and
                # applies B1's stacked sum at every step.
                want_l = _rank_hops(rounds, RING_SHARDS * rounds, n3)
            elif base == "census":
                want_l = _rank_hops(1, RING_SHARDS)
            else:
                dense = rounds - len(r.get("sparse", ()))
                want_l = _rank_or(layout, dense)
            check_launches(label, r["launches"], want_l)
            lane = base == "lanes_recorded"
            counts["gather_lanes" if lane else "gather"] += \
                r["launches"]["gather"]
            counts["put"] += r["launches"]["put"]
            counts["pass_segsum"] += r["launches"]["pass_segsum"]
            counts["segsum"] += r["launches"]["segsum"]
            counts["threefry"] += r["launches"]["threefry"]
            counts["rowsum_lanes"] += r["launches"]["rowsum"]
        record[name] = {
            "rounds": rounds, "sparse": rec.get("sparse"),
            "exchanges": rec["exchanges"], "syncs": rec["syncs"],
            "launches": rec["launches"],
            "first_run_s": [r["first_run_s"] for r in recs],
            "wall_s": [r.get("wall_s") for r in recs],
            **({"census": rec["census"]} if base == "census" else {}),
            **({"faults": rec["faults"]} if base == "faulted" else {})}
    print(json.dumps({
        "phase": "rank-adaptive-path", "world": world, "runs": record,
        "adaptive_s": {lay: [p["floods"][lay].get("adaptive_s")
                             for p in parts] for lay, _ in RING_LAYOUTS},
        "t_s": time.perf_counter() - T_START}), flush=True)
    return counts


def rank_ring_path(g, ring, segsum, device_mod, sharded, mesh_mod,
                   multihost, gpu: str, world1: dict,
                   sparse1: dict) -> dict:
    """Phase 4v: the ring split over 2 and 8 rank processes on the card
    (``RANK_WORLDS``; 4 and 1 shards a rank). First, in this process, the
    dense floods' walls at world 1 and the churn step, on phase 4's graph.
    Then each world's ranks (``rank_ring``), held to phase 4b's records
    (``EXPECTED_1M``, ``EXPECTED_RING_SEEN``), 4t's gossip rung
    (``EXPECTED_RING_GOSSIP``), the world-1 churn step, the launches of
    ``RANK_LAUNCHES`` and the kernels' checks; a rank that raises must
    fail its launch. Prints ``rank-ring-path`` lines; returns the kernel
    rows of rank 0 at each world and, by world, the launches of the
    checked floods and churn steps (and the gossip rung's f32 puts,
    ``gather_f32``) summed over every rank. Slice 15's runs at each world
    (``RANK_PROTOCOLS``) are held by :func:`check_rank_protocols`, their
    launches added by kernel row; world 8 saves SIR's status, which world
    2 restores (equal to ``EXPECTED_SIR``'s, the uninterrupted run's)."""
    t_phase = time.perf_counter()
    ckpt = tempfile.TemporaryDirectory(prefix="p2p-rank-ckpt-")
    mesh = mesh_mod.ring_mesh(RING_SHARDS)
    one = {}
    for layout, kw in RING_LAYOUTS:
        sg = sharded.shard_graph(g, mesh, **kw)

        def run():
            return sharded.flood_until_coverage(
                sg, mesh, 0, coverage_target=0.99, max_rounds=64)

        run()
        walls = []
        for _ in range(3):
            device_mod.SYNCS = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        one[layout] = {"wall_s": statistics.median(walls),
                       "wall_s_all": walls, "syncs": device_mod.SYNCS}
        if layout == "segment":
            seen_c, out_c = rank_churn(sharded, sg, mesh)
            churn = {"out": out_c, "seen": digest(seen_c)}
        del sg
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "rank-ring-path", "world": 1,
                      "floods": one, "churn": churn["out"], "gpu": gpu}),
          flush=True)
    rows, totals = {}, {}
    for world in RANK_WORLDS:
        totals[world] = counts = collections.Counter()
        t0 = time.perf_counter()
        try:
            parts = multihost.launch(f"{Path(__file__).resolve()}:rank_ring",
                                     world, (3, ckpt.name),
                                     timeout=RANK_TIMEOUT, device="cuda")
        except (multihost.RankError, TimeoutError) as e:
            fail(f"phase 4v at world {world}: {e}")
        launch_s = time.perf_counter() - t0
        floods = {}
        for layout, _ in RING_LAYOUTS:
            recs = [p["floods"][layout] for p in parts]
            seen = torch.from_numpy(np.concatenate([r["seen"] for r in recs]))
            for r in recs:
                if r["out"] != EXPECTED_1M:
                    fail(f"rank ring {layout} at world {world} returned "
                         f"{r['out']}, the reference gives {EXPECTED_1M}")
                check_launches(f"rank ring {layout} at world {world}",
                               r["launches"], RANK_LAUNCHES[layout])
                counts.update(r["launches"])
            if digest(seen) != EXPECTED_RING_SEEN:
                fail(f"rank ring {layout} at world {world}: seen differs "
                     f"from phase 4b's")
            floods[layout] = {
                "wall_s": [r["wall_s"] for r in recs],
                "first_run_s": [r["first_run_s"] for r in recs],
                "syncs": recs[0]["syncs"], "launches": recs[0]["launches"],
                "build_s": recs[0]["build_s"]}
            if layout == "segment":
                churn_recs = [r["churn"] for r in recs]
                for r in churn_recs:
                    if r["out"] != churn["out"]:
                        fail(f"rank churn step at world {world} returned "
                             f"{r['out']}, one process {churn['out']}")
                    counts.update(r["launches"])
                seen_c = torch.from_numpy(np.concatenate(
                    [r["seen"] for r in churn_recs]))
                if digest(seen_c) != churn["seen"]:
                    fail(f"rank churn step at world {world}: seen differs "
                         f"from one process's")
                floods[layout]["churn_s"] = [r["s"] for r in churn_recs]
        gossip = [p["gossip"] for p in parts]
        for r in gossip:
            if r["stats"] != gossip[0]["stats"]:
                fail(f"rank gossip at world {world}: ranks disagree")
        record = {**gossip[0]["stats"], "values_sha256": np_sha(
            np.concatenate([r["values"] for r in gossip]))}
        check_close(f"rank gossip at world {world}", record,
                    EXPECTED_RING_GOSSIP, RING_TOL["gossip"])
        check_launches(f"rank gossip at world {world}",
                       gossip[0]["launches"],
                       {"put": 0, "gather": GOSSIP_ROUNDS})
        counts["gather_f32"] += sum(r["launches"]["gather"] for r in gossip)
        for p in parts:
            for key in ("ordering", "gather_ordering"):
                if p[key]["bad"]:
                    fail(f"rank {key} check at world {world}: "
                         f"{p[key]['bad']} elements of rank "
                         f"{p['rank']}'s landed blocks differ")
        proto_counts, proto_walls, proto_err = check_rank_protocols(
            world, parts, world1)
        counts.update(proto_counts)
        counts.update(check_rank_adaptive(world, parts, sparse1))
        if world == 2:
            got = [p["restored"] for p in parts]
            if (np_sha(np.concatenate([r["rows"] for r in got]))
                    != EXPECTED_SIR["status_sha256"]
                    or any((r["key"], r["round"]) != (KEY.tolist(),
                                                      SIR_ROUNDS)
                           for r in got)):
                fail("SIR's status saved at world 8 and restored at world "
                     "2 differs from the uninterrupted run's")
        print(json.dumps({
            "phase": "rank-ring-path", "run": "protocols", "world": world,
            "walls": proto_walls, "max_abs_err_vs_reference": proto_err,
            "launches_rank0": {k: v["launches"]
                               for k, v in parts[0]["protocols"].items()},
            "syncs_rank0": {k: v["syncs"]
                            for k, v in parts[0]["protocols"].items()},
            "node_walls": [p["protocols"]["mesh_pagerank"]["node_walls"]
                           for p in parts] if world == 2 else None,
            "layout_protocols_s": {
                lay: [p["floods"][lay]["protocols_s"] for p in parts]
                for lay, _ in RING_LAYOUTS},
            "restored_s": [p["restored"]["s"] for p in parts]
            if world == 2 else None,
            "t_s": time.perf_counter() - T_START}), flush=True)
        rows[world] = parts[0]["rows"]
        for row in parts[0]["rows"]:
            print(json.dumps({"phase": "kernel", **row}), flush=True)
        print(json.dumps({
            "phase": "rank-ring-path", "world": world, "launch_s": launch_s,
            "graph_s": [p["graph_s"] for p in parts],
            "devices": sorted({p["device"] for p in parts}),
            "floods": floods, "gossip_s": [r["first_run_s"] for r in gossip],
            "gossip_syncs": gossip[0]["syncs"],
            "ordering": [p["ordering"] for p in parts],
            "gather_ordering": [p["gather_ordering"] for p in parts],
            "move": [p["move"] for p in parts],
            "t_s": time.perf_counter() - T_START}), flush=True)
    t0 = time.perf_counter()
    try:
        multihost.launch(f"{Path(__file__).resolve()}:rank_fails", 2,
                         timeout=120, device="cuda")
    except multihost.RankError as e:
        if "fails on purpose" not in str(e):
            fail(f"phase 4v: a failing rank raised {e}")
    else:
        fail("phase 4v: a rank that raises did not fail its launch")
    print(json.dumps({"phase": "rank-ring-path", "failing_rank_s":
                      time.perf_counter() - t0,
                      "phase_s": time.perf_counter() - t_phase}), flush=True)
    ckpt.cleanup()
    return {"rows": rows, "launches": totals}


def traced_path(g, segsum, Flood) -> int:
    """Phase 4w (g): ``utils/trace.run_traced`` of phase 4's ``hybrid``
    flood for its rounds, the JSON lines into a temporary file and the
    profile into a temporary directory. Each round's record against phase
    4's stats (``EXPECTED_1M``: the rounds, the messages summed, the last
    coverage, the occupancy's f32 mean), the summary line the reference's
    fields, B1 once a round, the trace non-empty and naming B1's kernel.
    Returns B1's launches."""
    from p2pnetwork_tpu_torch.utils import trace

    rounds = EXPECTED_1M["rounds"]
    with tempfile.TemporaryDirectory(prefix="p2p-trace-") as tmp:
        sink, prof = Path(tmp) / "rounds.jsonl", Path(tmp) / "profile"
        segsum.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, records = trace.run_traced(
            g, Flood(source=0, method="hybrid"), KEY, rounds, sink=str(sink),
            label="4w", profile_dir=str(prof))
        wall = time.perf_counter() - t0
        launches = segsum.LAUNCHES
        lines = [json.loads(line) for line in sink.read_text().splitlines()]
        traces = sorted(prof.glob("trace-*.json"))
        text = traces[0].read_text() if traces else ""
    occ = np.float32(0.0)
    for r in records:  # the engine's running f32 sum, then the mean
        occ = np.float32(occ + np.float32(r["frontier_occupancy"]))
    got = {"rounds": len(records), "coverage": records[-1]["coverage"],
           "messages": int(sum(r["messages"] for r in records)),
           "frontier_occupancy_mean": float(occ / np.float32(rounds))}
    check_run("traced flood", got, EXPECTED_1M)
    summary = lines[-1]
    if lines[:-1] != records or [r["round"] for r in records] != list(
            range(rounds)) or not summary.get("summary") or (
            summary["rounds"], summary["compile_seconds"],
            summary["device_transfer_bytes"], summary["n_nodes"]) != (
            rounds, 0.0, 4 * rounds * len(Flood.STATS), g.n_nodes):
        fail(f"traced flood: its JSON lines are not its records and the "
             f"reference's summary ({summary})")
    if launches != rounds:
        fail(f"traced flood launched B1 {launches} times, want {rounds}")
    if "segsum_kernel" not in text:
        fail("traced flood: the profile's trace does not name B1's kernel")
    print(json.dumps({
        "phase": "rank-adaptive-path", "run": "traced", "rounds": rounds,
        "launches": launches, "wall_s": wall, "trace_bytes": len(text),
        "summary": summary, "t_s": time.perf_counter() - T_START}),
        flush=True)
    return launches


# --------------------------------------------------------------- phase 4x

#: Phase 4x (c): schedules of serve_admit_storm's body on phase 4's graph.
RACE_1M_SCHEDULES = 4
#: Phase 4q's SimService settings, and the seen hashes that make a ticket's
#: result its bits.
RACE_1M_SERVICE = dict(capacity=BATCH_B, queue_depth=BATCH_B, chunk_rounds=4,
                       seed=0, record_seen_hash=True)
#: A done ticket's result: the same source's in every schedule.
RACE_RESULT = ("source", "status", "rounds", "seen_count", "seen_sha256")
#: Phase 4x's wall bound (seconds).
RACE_PHASE_S = 60.0


def lint_tree(root: Path) -> dict:
    """Phase 4x (a): graftlint's CLI over the port tree in a process of
    its own; it must exit 0 with no finding and the empty baseline."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "p2pnetwork_tpu_torch.analysis",
         "p2pnetwork_tpu_torch", "--json", "--no-suppressions"],
        cwd=root, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"graftlint exited {res.returncode}:\n{res.stdout[-4000:]}"
             f"{res.stderr[-4000:]}")
    doc = json.loads(res.stdout)
    files = len(list((root / "p2pnetwork_tpu_torch").rglob("*.py")))
    if not doc["ok"] or doc["findings"] or doc["baselined"]:
        fail(f"graftlint: the port tree is not clean ({doc['findings']}, "
             f"{doc['baselined']} baselined)")
    return {"files": files, "findings": len(doc["findings"]),
            "suppressions": len(doc["suppressed"]), "wall_s": wall,
            "python": sys.version.split()[0]}


def admit_results(explore, scenarios, g, seeds) -> list:
    """serve_admit_storm's body on ``g`` with ``RACE_1M_SERVICE``, drained,
    under each seed's schedule; each schedule's ticket records."""
    out = []
    for seed in seeds:
        records = []
        body = scenarios.admit_storm(g, service=RACE_1M_SERVICE, drain=True,
                                     results=records)
        res = explore(body, seed=seed)
        if res.findings or res.errors:
            fail(f"serve_admit_storm on phase 4's graph, seed {seed}: "
                 f"{[f.render() for f in res.findings]} {res.errors}")
        out.append((res, records))
    return out


def unscheduled_results(serve, g, sources) -> dict:
    """Each source's result from a service driven with no scheduler."""
    svc = serve.SimService(g, **RACE_1M_SERVICE)
    for s in sources:
        svc.submit(s)
    while svc.busy():
        svc.tick()
    recs = {r["source"]: {k: r.get(k) for k in RACE_RESULT}
            for r in svc.tickets().values()}
    svc.close()
    return recs


def analysis_path(g, serve, telemetry, segsum, threefry, rowsum,
                  device="cuda") -> None:
    """Phase 4x (slice 17), after 4w: the threaded plane's analysers.
    (a) graftlint over the port tree exits 0 (``lint_tree``); (b)
    graftrace's ten builtins at its default 8 schedules, the watchdog and
    serving scenarios' graphs and state on ``device``, each clean and none
    unavailable, a line a scenario; (c) serve_admit_storm's body on phase
    4's graph with 4q's service settings over ``RACE_1M_SCHEDULES``
    schedules: every ticket done under a schedule equals, field for field
    (its seen bits' hash among them), the same source's from a service
    driven with no scheduler. The phase's kernel launches are counted on
    its last line."""
    from p2pnetwork_tpu_torch.analysis.race import __main__ as race_cli
    from p2pnetwork_tpu_torch.analysis.race import explore, scenarios

    t_phase = time.perf_counter()
    segsum.LAUNCHES = threefry.LAUNCHES = rowsum.LAUNCHES = 0
    lint = lint_tree(Path(__file__).resolve().parent)
    print(json.dumps({"phase": "race-path", "run": "graftlint", **lint,
                      "t_s": time.perf_counter() - T_START}), flush=True)

    for name in scenarios.builtin_names():
        entry = scenarios.SCENARIOS[name]
        t0 = time.perf_counter()
        findings, stats = race_cli.run_battery(
            [name], seed=0, schedules=race_cli.DEFAULT_SCHEDULES,
            device=device, registry=telemetry.Registry())
        wall = time.perf_counter() - t0
        row = stats[0]
        if row["skipped"] or findings or row["errors"] \
                or row["schedules"] != race_cli.DEFAULT_SCHEDULES:
            fail(f"graftrace {name}: skipped={row['skipped']} "
                 f"{[f.render() for f in findings]} {row['errors']}")
        print(json.dumps({
            "phase": "race-path", "run": "battery", "scenario": name,
            "device": device if entry.device else "host",
            "schedules": row["schedules"], "steps": row["steps"],
            "wall_s": wall, "t_s": time.perf_counter() - T_START}),
            flush=True)

    t0 = time.perf_counter()
    runs = admit_results(explore, scenarios, g, range(RACE_1M_SCHEDULES))
    t1 = time.perf_counter()
    want = unscheduled_results(serve, g, range(1, 6))
    t2 = time.perf_counter()
    done = []
    for seed, (res, records) in enumerate(runs):
        mine = [r for r in records if r["status"] == "done"]
        for r in mine:
            got = {k: r.get(k) for k in RACE_RESULT}
            if got != want.get(r["source"]) or got["seen_sha256"] is None:
                fail(f"serve_admit_storm seed {seed}: ticket {r['ticket']} "
                     f"{got} != the unscheduled service's "
                     f"{want.get(r['source'])}")
        done.append(len(mine))
    if not all(done):
        fail(f"serve_admit_storm on phase 4's graph: a schedule completed "
             f"no ticket ({done})")
    launches = segsum.LAUNCHES + threefry.LAUNCHES + rowsum.LAUNCHES
    wall = time.perf_counter() - t_phase
    print(json.dumps({
        "phase": "race-path", "run": "admit-storm-1m",
        "n_nodes": g.n_nodes, "schedules": RACE_1M_SCHEDULES,
        "done_per_schedule": done,
        "steps": [res.steps for res, _ in runs],
        "sources": {str(s): want[s]["rounds"] for s in sorted(want)},
        "scheduled_s": t1 - t0, "unscheduled_s": t2 - t1,
        "phase_s": wall, "launches": launches,
        "t_s": time.perf_counter() - T_START}), flush=True)
    if wall > RACE_PHASE_S:
        fail(f"phase 4x took {wall:.1f} s, over its {RACE_PHASE_S:g} s")


RING_EXPECT = {"segment": ("ring_shift",),
               "mxu": ("ring_segsum", "segsum"),
               "hybrid": ("ring_shift", "segsum")}


def ring_counts(ring, segsum) -> dict:
    return {"segsum": segsum.LAUNCHES, "ring_shift": ring.SHIFT_LAUNCHES,
            "ring_segsum": ring.SEGSUM_LAUNCHES}


def reset_counts(ring, segsum, device_mod) -> None:
    segsum.LAUNCHES = ring.SHIFT_LAUNCHES = ring.SEGSUM_LAUNCHES = 0
    device_mod.SYNCS = 0


def ring_path(g, want_seen, ring, segsum, device_mod, sharded, mesh_mod):
    """Phase 4b: phase 4's graph sharded 8 ways on the card, flooded to
    99% in each layout with the default comm; phase 3b on the ``mxu``
    shards before their flood. Returns each kernel's launches summed over
    the three checked runs, and phase 3b's rows and max abs error."""
    mesh = mesh_mod.ring_mesh(RING_SHARDS)
    totals = dict.fromkeys(ring_counts(ring, segsum), 0)
    step_rows, step_err = [], 0.0
    for layout, kw in RING_LAYOUTS:
        t0 = time.perf_counter()
        sg = sharded.shard_graph(g, mesh, **kw)
        torch.cuda.synchronize()
        print(json.dumps({
            "phase": "ring-graph", "layout": layout,
            "build_s": time.perf_counter() - t0, "block": sg.block,
            "bkt": list(sg.bkt_src.shape),
            "mxu": None if sg.mxu_src is None else list(sg.mxu_src.shape),
            "live_slots": int(sg.bkt_mask.sum().item()),
            "mxu_live_slots": None if sg.mxu_mask is None
            else int(sg.mxu_mask.sum().item()),
            **({} if sg.mxu_extent is None else {
                "mxu_step_live_slots": sg.mxu_mask.sum((0, 2, 3)).tolist(),
                "mxu_step_extent_mean":
                    sg.mxu_extent.float().mean((0, 2)).tolist(),
                "mxu_step_extent_max": sg.mxu_extent.amax((0, 2)).tolist()}),
            "diag_pieces": len(sg.diag_pieces)}), flush=True)
        if layout == "mxu":
            step_rows, step_err = real_step_phase(ring, sg)

        def run():
            return sharded.flood_until_coverage(
                sg, mesh, 0, coverage_target=0.99, max_rounds=64)

        reset_counts(ring, segsum, device_mod)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seen, out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ring_counts(ring, segsum)
        syncs = device_mod.SYNCS
        if out != EXPECTED_1M:
            fail(f"ring {layout} returned {out}, the reference gives "
                 f"{EXPECTED_1M}")
        if seen.shape != (RING_SHARDS, sg.block) or not torch.equal(
                seen.reshape(-1)[:N_PAD], want_seen):
            fail(f"ring {layout}: final seen differs from phase 4's")
        missing = [k for k in RING_EXPECT[layout] if launches[k] == 0]
        if missing:
            fail(f"ring {layout} never launched {missing}")
        for k, n in launches.items():
            totals[k] += n
        record = {"layout": layout, "first_run_s": wall,
                  "launches": launches, "syncs": syncs}
        if layout == "mxu":
            gen = torch.Generator(device="cuda").manual_seed(2)
            sig = torch.randint(0, 16, (RING_SHARDS, sg.block),
                                generator=gen, device="cuda").to(torch.float32)
            if not torch.equal(
                    sharded.propagate(sg, mesh, sig, "sum"),
                    sharded.propagate(sg, mesh, sig, "sum", comm="ppermute")):
                fail("ring mxu: integer-valued propagate(sum) differs "
                     "between the kernels and comm='ppermute'")
            record["propagate_sum_exact"] = True
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        record["wall_s"] = sorted(times)[len(times) // 2]
        record["wall_s_all"] = times
        steps = RING_SHARDS - 1 if layout == "mxu" else None
        record["profile"] = profile_run(run, ring_steps=steps)
        if layout == "mxu":
            # The same flood with every row at full width (no extents):
            # B3 on the paths of a launch without them.
            full = dataclasses.replace(sg, mxu_extent=None)

            def run_full():
                return sharded.flood_until_coverage(
                    full, mesh, 0, coverage_target=0.99, max_rounds=64)

            seen_full, out_full = run_full()
            if out_full != EXPECTED_1M or not torch.equal(seen_full, seen):
                fail("ring mxu at full width differs from the run with "
                     "extents")
            record["profile_full_width"] = profile_run(run_full,
                                                       ring_steps=steps)
        print(json.dumps({"phase": "ring-path", **record}), flush=True)
        del sg
        torch.cuda.empty_cache()
    return totals, step_rows, step_err


def profile_run(run, ring_steps=None) -> dict:
    """One ``run()`` under torch.profiler: wall time, device kernel time
    and launches, and the kernels that take the most device time. With
    ``ring_steps`` (the fused steps of a ring pass), B3's device time
    split by ring step: its launches in device order, step = launch index
    mod ``ring_steps`` (each pass fuses steps 0 to ring_steps - 1).
    Only the device's activity is recorded (every number read here is
    device-side), and its records are summed from the profiler's raw
    events: on a walk run of 186K launches ``key_averages()`` took 77 s
    with host events and 38 s without, the raw sum 1.7 s, the device
    totals within 0.3% (``tools/profiler_cost.py``, H100 80GB HBM3,
    700.00 W). ``post_s`` is the summing's host time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t_post = time.perf_counter()
    by_name, b3 = {}, []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.duration_ns() / 1e3
        if not us:
            continue
        name = ev.name()
        total, count = by_name.get(name, (0.0, 0))
        by_name[name] = (total + us, count + 1)
        if ring_steps and "ring_segsum" in name:
            b3.append((ev.start_ns(), us))
    rows = sorted(((us, k, c) for k, (us, c) in by_name.items()),
                  reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    split = {}
    if ring_steps:
        b3.sort()
        per_step = [[us for i, (_, us) in enumerate(b3)
                     if i % ring_steps == t] for t in range(ring_steps)]
        split = {"b3_launches": len(b3),
                 "b3_step_us": [sum(v) for v in per_step],
                 "b3_step_launches": [len(v) for v in per_step]}
    return {"wall_s": wall, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / wall,
            "post_s": time.perf_counter() - t_post,
            "kernel_launches": sum(r[2] for r in rows),
            "segsum_us": sum(us for us, k, _ in rows
                             if "segsum" in k and "ring" not in k),
            "ring_us": sum(us for us, k, _ in rows if "ring_" in k),
            "top": [{"kernel": k[:100], "us": us, "count": c}
                    for us, k, c in rows[:6]], **split}


#: The script's start, on the host clock (``t_s`` of the timed lines).
T_START = time.perf_counter()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing checked", file=sys.stderr)
        return 2
    from p2pnetwork_tpu_torch import _build, _device, prng
    from p2pnetwork_tpu_torch import models as models_mod
    from p2pnetwork_tpu_torch.models import (SIR, AdaptiveFlood, Flood,
                                             Gossip, HopDistance, PageRank,
                                             PushSum, base, messagebatch,
                                             querybatch)
    from p2pnetwork_tpu_torch.analysis.ir import capacity
    from p2pnetwork_tpu_torch.ops import frontier as frontier_ops
    from p2pnetwork_tpu_torch.ops import ring, rowsum, segsum, threefry
    from p2pnetwork_tpu_torch.parallel import mesh as mesh_mod
    from p2pnetwork_tpu_torch.parallel import multihost, sharded
    from p2pnetwork_tpu_torch import chaos, serve, supervise, telemetry
    from p2pnetwork_tpu_torch import config as config_mod
    from p2pnetwork_tpu_torch import node as node_mod
    from p2pnetwork_tpu_torch.chaos import crashstorm, storm
    from p2pnetwork_tpu_torch.supervise import heal
    from p2pnetwork_tpu_torch.telemetry import httpd
    from p2pnetwork_tpu_torch.telemetry import slo as slo_mod
    from p2pnetwork_tpu_torch.sim import (checkpoint, engine, failures,
                                          flightrec, layout, layoutcache,
                                          topology)
    from p2pnetwork_tpu_torch.sim import graph as graph_mod
    from p2pnetwork_tpu_torch.sim import simnode

    # 1. Device.
    gpu = gpu_line()
    print(gpu, flush=True)
    print(json.dumps({"phase": "device", "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "name": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count()}), flush=True)

    # 2. Build.
    _build.library()
    print(_build.LAST_BUILD["log"], flush=True)
    print(json.dumps({"phase": "build",
                      "seconds": _build.LAST_BUILD["seconds"],
                      "compiled": _build.LAST_BUILD["compiled"]}), flush=True)

    # 3. Kernel vs plain version, edge geometries.
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    rows, max_err = kernel_phase(segsum, flush)
    ring_rows, ring_err = ring_kernel_phase(ring, segsum, flush)
    for row in rows + ring_rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    edge_phase(ring, segsum)
    del flush

    # 4. Main path.
    models = (Flood, AdaptiveFlood)
    launches, g, seen = main_path(engine, segsum, _device, graph_mod, models,
                                  frontier_ops)

    # 4b. Ring.
    ring_launches, step_rows, step_err = ring_path(
        g, seen, ring, segsum, _device, sharded, mesh_mod)

    # 4c. Churn on the same graph. The phases new in slice 3 run after the
    # timed rows and runs that earlier slices had, which so see the same
    # device allocations as before (phase 3b's small kernels moved by
    # ~0.3 us when 4c ran before 4b).
    launches += churn_path(g, engine, segsum, _device, models, frontier_ops,
                           topology, failures)

    # 4d. Skew: the 1M BA rung.
    skew_path(engine, _device, models, graph_mod, failures)

    # The phases new in slice 4 run after every earlier timed row and run,
    # for the same reason: 3c (threefry), then the keyed protocols on
    # phase 4's graph (4e, 4f) and the gossip rung (4g).
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    threefry_rows, threefry_err = threefry_phase(prng, threefry, _build,
                                                 flush)
    del flush
    sir_launches = sir_path(g, engine, prng, segsum, threefry, _device, SIR)
    cons_launches = consensus_path(g, engine, prng, segsum, threefry,
                                   _device, PushSum, PageRank)
    gossip_launches = gossip_path(engine, prng, base, threefry, segsum,
                                  _device, graph_mod, Gossip)

    # The phases new in slice 5, after every earlier timed row and run:
    # 4h (the weighted routing rung and its methods), 4i (analytics).
    ba, rung = routing_path(g, engine, segsum, threefry, _device,
                            graph_mod, frontier_ops,
                            models_mod.DistanceVector)
    new_launches = analytics_path(g, ba, engine, prng, segsum, threefry,
                                  _device, models_mod)
    del ba

    # The phases new in slice 7, after every earlier 1M run: 4l (the
    # discovery rung), 4m (the Plumtree rung), 4n (the protocol library).
    walk_launches = discovery_path(g, engine, segsum, threefry, _device,
                                   models_mod.RandomWalks)
    plumtree_path(rung, engine, segsum, threefry, _device, models_mod)
    del rung
    lib_launches = library_path(g, engine, prng, segsum, threefry, _device,
                                models_mod)
    # 4p (slice 8), after every earlier 1M run: a churn epoch, growth, the
    # recorder, checkpoints and graph files on phase 4's graph.
    io_launches = state_io_path(g, seen, engine, prng, segsum, threefry,
                                _device, graph_mod, Flood, SIR, checkpoint,
                                flightrec, layoutcache, telemetry)
    # The row-sum kernel (slice 8's repair of the ordered sums), then
    # PageRank by ``gather`` on the same graph, its main-path use.
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    rowsum_rows = rowsum_phase(rowsum, _build, g, flush)
    del flush
    rowsum_launches = {"gather": pagerank_gather(
        g, engine, rowsum, segsum, threefry, _device, PageRank)}
    # 4q's supervised flood (slice 9), after every earlier run on phase
    # 4's graph: B1's OR launches join the kernels line.
    sup_launches = supervise_path(g, seen, engine, segsum, threefry,
                                  _device, Flood, supervise)
    # 4r (slice 10), after 4q on phase 4's graph: (d) the supervised flood
    # healed through a chip preemption, (e) the faulted 1M ring flood.
    heal_launches = heal_flood_path(g, seen, segsum, threefry, _device,
                                    Flood, supervise, chaos, heal, telemetry)
    fault_launches = fault_ring_path(g, seen, ring, segsum, threefry,
                                     _device, sharded, mesh_mod, chaos,
                                     telemetry)
    # 4s (slice 11), after 4r on phase 4's graph: the user bridge, whose
    # re-mask runs B2 in reverse.
    sim_launches, back_row = simnode_path(
        g, ring, segsum, threefry, _device, topology, mesh_mod, sharded,
        Flood, simnode, node_mod, config_mod, chaos, telemetry)
    # 4t (slice 12), after 4s on phase 4's graph: the ring's other
    # protocols, the gossip rung and TorchSimNode's mesh backend for them.
    proto_launches, proto_rows, world1 = ring_protocol_path(
        g, ring, segsum, threefry, rowsum, _device, sharded, mesh_mod,
        models_mod, graph_mod, simnode)
    ring_walk_path(g, ring, segsum, threefry, rowsum, _device, sharded,
                   mesh_mod, models_mod.RandomWalks)
    # 4u (slice 13), after 4t on phase 4's graph: the frontier-adaptive
    # ring loop, the ring's recorder and the adaptive mesh node.
    sparse1 = {}
    adaptive_launches = adaptive_ring_path(
        g, seen, ring, segsum, threefry, rowsum, _device, sharded, mesh_mod,
        flightrec, HopDistance, sparse1)
    node_launches = adaptive_node_path(
        g, ring, segsum, threefry, rowsum, _device, mesh_mod, simnode,
        node_mod, Flood, HopDistance)
    for k, n in node_launches.items():
        adaptive_launches[k] += n
    # 4v (slice 14), after 4u: the ring split over 2 and 8 rank processes
    # on the card, its hops the cross-rank kernels.
    rank = rank_ring_path(g, ring, segsum, _device, sharded, mesh_mod,
                          multihost, gpu, world1, sparse1)
    # 4w (slice 16): its rank runs rode 4v's launches; the traced flood.
    traced_launches = traced_path(g, segsum, Flood)
    # 4x (slice 17): graftlint, graftrace's battery on the card, and the
    # admission storm's schedules on phase 4's graph.
    analysis_path(g, serve, telemetry, segsum, threefry, rowsum)
    del g, seen
    torch.cuda.empty_cache()

    # Phase 3's C1 check of B1 (B3's ran at the end of phase 3b).
    c1_phase(segsum)

    # The phases new in slice 6, after every earlier timed row, run and
    # check: 4j (the batched message plane), 4k (the query plane). They
    # launch no kernel (push-sum's seed draws aside, which their own lines
    # count), so the kernels line below is as before.
    bg = batch_path(engine, segsum, threefry, _device, graph_mod,
                    frontier_ops, Flood, messagebatch)
    query_path(bg, engine, segsum, threefry, _device, graph_mod, querybatch)
    # 4t's batched call on the segment ring of the same graph.
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    lane_hops, lane_row = ring_batch_path(bg, ring, segsum, threefry, rowsum,
                                          _device, sharded, mesh_mod,
                                          messagebatch, flush)
    del flush
    # 4u (e): the same batched call with the ring's recorder.
    lane_rec = lane_recorder_path(bg, ring, segsum, threefry, rowsum,
                                  _device, sharded, mesh_mod, engine,
                                  flightrec, messagebatch)
    # 4p's batch call with a recorder (slice 8), after 4j's and 4k's runs.
    rowsum_launches["dense"] = batch_recorder(
        bg, engine, segsum, threefry, _device, flightrec, messagebatch)
    # 4q's serving drives (slice 9), after every earlier run on 4j's graph.
    serve_path(bg, serve, segsum, threefry, _device, telemetry)
    # 4r (a), (b), (g) after 4q's drives on the same graph.
    chaos_serve_path(bg, serve, chaos, heal, slo_mod, httpd, telemetry,
                     segsum, threefry, _device)
    # 4u (f): the memory planner against 4q's drive, and its gate.
    planner_path(bg, serve, graph_mod, capacity, gpu)
    del bg

    # 4o (slice 7): the reordered builds, last.
    reorder_launches = reorder_path(engine, segsum, threefry, _device,
                                    graph_mod, layout, Flood)
    # 4r (c) and (f), last: the 100k churn soak and the crash campaign,
    # whose children start CUDA of their own.
    soak_path(serve, storm, chaos, heal, graph_mod, telemetry)
    torch.cuda.empty_cache()
    campaign_path(crashstorm, serve, graph_mod, telemetry)

    # 5. Result. Each kernel's row is its main-path use: B1's OR entry on
    # the hybrid remainder (the adaptive and hybrid floods), B2's forward
    # hop of the bool frontier, B3's OR entry on the mxu layout's real
    # step 0 (phase 3b); launches summed over the checked runs of phases
    # 4, 4c, 4b and 4i.
    # B1's sum entry has a row per layout: the hybrid remainder's timing
    # with its launches in 4e's hybrid run, 4f and 4i's KCore(hybrid), the
    # blocked layout's with those of 4e's pallas run and KCore(pallas).
    # The threefry row (port-only, no TPU kernel: it replaces XLA's fused
    # jax.random draw) is its uniform entry, SIR's draw, launched in
    # 4e-4g and (its bits entry) 4i. Slice 10's 4r adds B1's OR launches
    # of (d), the healed supervised flood, and (e), the faulted ring flood
    # (the stacked apply), B2's hops of (e) and threefry's corrupt-bit
    # draws of (e).
    def rank_row(world, kernel, entry):
        return next(r for r in rank["rows"][world]
                    if r["kernel"] == kernel and r["entry"] == entry)

    def rank_sum(key):  # a kernel row's launches at every world's ranks
        return sum(rank["launches"][w][key] for w in RANK_WORLDS)

    def row(name, source, replaces, at, n, err):
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return {"name": name, "route": "cuda",
                "source": f"p2pnetwork_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n, "max_abs_err": err,
                **{k: at[k] for k in keys}}

    print(json.dumps({"kernels": [
        row("segsum", "segsum.cu", "p2pnetwork_tpu/ops/pallas_edge.py:41",
            rows[0], launches + ring_launches["segsum"] + new_launches["or"]
            + lib_launches["or"] + reorder_launches + io_launches["or"]
            + sup_launches + heal_launches + fault_launches["segsum"]
            + sim_launches["segsum"] + adaptive_launches["segsum"]
            + rank_sum("segsum") + traced_launches,
            max(max_err, ring_err["segsum"])),
        row("ring_shift", "ring.cu", "p2pnetwork_tpu/ops/pallas_ring.py:72",
            ring_rows[0], ring_launches["ring_shift"]
            + fault_launches["ring_shift"] + sim_launches["ring_shift"]
            + proto_launches["ring_shift"] + adaptive_launches["ring_shift"],
            ring_err["ring_shift"]),
        row("ring_shift_f32", "ring.cu",
            "p2pnetwork_tpu/ops/pallas_ring.py:72 (f32 payload)",
            next(r for r in ring_rows if r["kernel"] == "ring_shift"
                 and r["entry"] == "f32"),
            proto_launches["ring_shift_f32"], ring_err["ring_shift"]),
        row("ring_shift_lanes", "ring.cu",
            "p2pnetwork_tpu/ops/pallas_ring.py:72 (the lane-word stack)",
            lane_row, lane_hops + lane_rec["ring_shift"], 0.0),
        row("ring_shift_i32", "ring.cu",
            "p2pnetwork_tpu/ops/pallas_ring.py:72 (i32 payload)",
            proto_rows["ring_shift_i32"], proto_launches["ring_shift_i32"],
            0.0),
        row("ring_shift_back", "ring.cu",
            "p2pnetwork_tpu/ops/pallas_ring.py:72 (reverse=True)", back_row,
            sim_launches["ring_shift_back"]
            + proto_launches["ring_shift_back"], back_row["max_abs_err"]),
        row("ring_segsum", "ring.cu",
            "p2pnetwork_tpu/ops/pallas_ring.py:126",
            next(r for r in step_rows
                 if r["step"] == 0 and r["entry"] == "or"),
            ring_launches["ring_segsum"] + sim_launches["ring_segsum"]
            + adaptive_launches["ring_segsum"],
            max(ring_err["ring_segsum"], step_err)),
        row("ring_segsum_sum", "ring.cu",
            "p2pnetwork_tpu/ops/pallas_ring.py:126",
            next(r for r in step_rows
                 if r["step"] == 0 and r["entry"] == "sum"),
            proto_launches["ring_segsum_sum"],
            max(ring_err["ring_segsum"], step_err)),
        row("segsum_ring_sum", "segsum.cu",
            "p2pnetwork_tpu/ops/pallas_edge.py:41",
            next(r for r in ring_rows if r["kernel"] == "segsum"
                 and r["entry"] == "sum"),
            proto_launches["segsum_ring_sum"] + rank_sum("segsum_sum"),
            ring_err["segsum"]),
        row("segsum_sum", "segsum.cu",
            "p2pnetwork_tpu/ops/pallas_edge.py:41", rows[1],
            sir_launches["hybrid"] + cons_launches["segsum"]
            + new_launches["sum"] + lib_launches["sum"] + io_launches["sum"],
            max_err),
        row("segsum_sum_blocked", "segsum.cu",
            "p2pnetwork_tpu/ops/pallas_edge.py:41", rows[3],
            sir_launches["pallas"] + new_launches["sum_blocked"]
            + lib_launches["sum_blocked"], max_err),
        row("threefry", "threefry.cu",
            "p2pnetwork_tpu/models/sir.py:65 (jax.random.uniform, fused "
            "by XLA; no TPU kernel)",
            next(r for r in threefry_rows
                 if r["entry"] == "uniform" and r["n"] == N_PAD),
            sir_launches["threefry"] + cons_launches["threefry"]
            + gossip_launches + new_launches["threefry"] + walk_launches
            + lib_launches["threefry"] + io_launches["threefry"]
            + fault_launches["threefry"] + sim_launches["threefry"]
            + proto_launches["threefry"] + rank_sum("threefry"),
            threefry_err),
        row("gather_row_sum", "rowsum.cu",
            "p2pnetwork_tpu/ops/segment.py:287 (jnp.sum of the gathered "
            "row, an XLA reduce; no TPU kernel)", rowsum_rows["ws-1m"],
            rowsum_launches["gather"], rowsum_rows["ws-1m"]["max_abs_err"]),
        row("row_sum", "rowsum.cu",
            "p2pnetwork_tpu/sim/engine.py:556 (jnp.sum of the lanes' "
            "counts, an XLA reduce; no TPU kernel)",
            rowsum_rows[f"lanes-{BATCH_B}"], rowsum_launches["dense"]
            + proto_launches["row_sum"] + lane_rec["rowsum"]
            + rank_sum("rowsum") // 2 + rank_sum("rowsum_lanes"),
            rowsum_rows[f"lanes-{BATCH_B}"]["max_abs_err"]),
        row("row_sum_shards", "rowsum.cu",
            "p2pnetwork_tpu/parallel/sharded.py:2446 (jnp.sum of a "
            "shard's block, an XLA reduce; no TPU kernel)",
            proto_rows["row_sum_shards"], proto_launches["row_sum_shards"]
            + rank_sum("rowsum") // 2, 0.0),
        row("ring_put", "ring_peer.cu",
            "p2pnetwork_tpu/ops/pallas_ring.py:72 (across ranks: world 2, "
            "bool [4, 125008])", rank_row(2, "ring_put", "bool"),
            rank["launches"][2]["put"], 0.0),
        row("ring_put_w8", "ring_peer.cu",
            "p2pnetwork_tpu/ops/pallas_ring.py:72 (across ranks: world 8, "
            "bool [1, 125008])", rank_row(8, "ring_put", "bool"),
            rank["launches"][8]["put"], 0.0),
        row("ring_gather", "ring_peer.cu",
            "p2pnetwork_tpu/ops/pallas_ring.py:72 (across ranks, a pass's "
            "blocks in one exchange: world 2, bool [4, 125008])",
            rank_row(2, "ring_gather", "bool"),
            rank["launches"][2]["gather"], 0.0),
        row("ring_gather_w8", "ring_peer.cu",
            "p2pnetwork_tpu/ops/pallas_ring.py:72 (across ranks, a pass's "
            "blocks in one exchange: world 8, bool [1, 125008])",
            rank_row(8, "ring_gather", "bool"),
            rank["launches"][8]["gather"], 0.0),
        row("ring_gather_f32", "ring_peer.cu",
            "p2pnetwork_tpu/ops/pallas_ring.py:72 (across ranks, a pass "
            "at a time: world 2, f32 [4, 125008])",
            rank_row(2, "ring_gather", "f32"), rank_sum("gather_f32"), 0.0),
        row("ring_gather_i32", "ring_peer.cu",
            "p2pnetwork_tpu/ops/pallas_ring.py:72 (across ranks, a pass "
            "at a time: world 2, i32 [4, 125008], election's ids)",
            rank_row(2, "ring_gather", "i32"), rank_sum("gather_i32"), 0.0),
        row("ring_gather_lanes", "ring_peer.cu",
            "p2pnetwork_tpu/ops/pallas_ring.py:72 (across ranks, a pass "
            "at a time: world 2, the lane words i32 [4, 32, 12512])",
            rank_row(2, "ring_gather", "lanes"), rank_sum("gather_lanes"),
            0.0),
        row("ring_pass_segsum", "ring_peer.cu",
            "p2pnetwork_tpu/ops/pallas_ring.py:126 (across ranks, every "
            "step of a pass in one launch: world 2, OR [4, 8, 245, 4864])",
            rank_row(2, "ring_pass_segsum", "or"),
            rank["launches"][2]["pass_segsum"], 0.0),
        row("ring_pass_segsum_w8", "ring_peer.cu",
            "p2pnetwork_tpu/ops/pallas_ring.py:126 (across ranks, every "
            "step of a pass in one launch: world 8, OR [1, 8, 245, 4864])",
            rank_row(8, "ring_pass_segsum", "or"),
            rank["launches"][8]["pass_segsum"], 0.0),
        row("ring_pass_segsum_sum", "ring_peer.cu",
            "p2pnetwork_tpu/ops/pallas_ring.py:126 (across ranks, every "
            "step of a pass in one launch: world 2, the sum form)",
            rank_row(2, "ring_pass_segsum", "sum"),
            rank_sum("pass_segsum_sum"), 0.0),
        row("row_sum_shards_100k", "rowsum.cu",
            "p2pnetwork_tpu/parallel/sharded.py:2446 (jnp.sum of a "
            "shard's block on the 100K gossip ring, an XLA reduce; no TPU "
            "kernel)", proto_rows["row_sum_shards_100k"],
            proto_launches["row_sum_shards_100k"], 0.0),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
