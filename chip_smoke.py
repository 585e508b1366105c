"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Every solve goes through ``ops/binpack_kernel.kernel_route``: the
one-block kernel (``csrc/binpack.cu``) when the node slice fits one CTA,
else the cluster kernel (``csrc/binpack_cluster.cu``) at the CTA count
the route names, its slices in shared memory, or past what 16 CTAs hold
in a device-memory workspace (the L2 form). Each phase prints the route
and the kernel's time (CUDA events, after a warm-up), the plain twin's,
the microseconds per pod and the bound (see :func:`bound`).

1. Prints the card's name and power limit; builds the CUDA kernel
   library from ``koordinator_tpu_torch/csrc`` with nvcc and prints
   ptxas's registers, shared memory and spills for each instance.
2. The routed kernel against the twin of the chosen kernel, bit for bit
   (assignments and every carry): the example problem at 5,000 nodes x
   10,000 pods (the cluster kernel), and 1,000 nodes with 5,000 pods in
   50 quota groups plus 200 gangs x 32 members (the one-block kernel,
   driven through ``kernel_solve_batch`` with the launch counts zeroed);
   then 1,000 nodes with 2,000 pods in 2,000 quota groups, whose tables
   do not fit shared memory (the one-block kernel with its quota carries
   in device memory).
3. The main path: ``PlacementModel().schedule`` on a seeded snapshot of
   5,000 nodes, 10,000 assigned pods with metrics and 10,000 pending pods
   in 50 quota groups and 200 gangs of 32. The launch counts are zeroed
   just before and read just after; the solve must take the route
   asserted here (the cluster kernel, its CTA count printed), respect
   node capacity, and equal ``PlacementModel(device="cpu")`` on an
   identical snapshot. A second run on a fresh model prints the timings
   of a process whose torch kernels are loaded.
4. Holds and times the routed kernel against its twin on the main path's
   own kernel inputs.
5. The reservation main path: phase 3's snapshot plus 256 Available
   reservations (200 owned by gang label, 56 migration reservations
   naming one solo pending pod each). ``PlacementModel().schedule`` must
   go through the routed kernel's reservation instance, consume
   reservations, respect node capacity with the remaining holds counted,
   and equal the CPU run: placements, waiting pods, consumption records
   and every mutated ``ReservationSpec``. The kernel is then held against
   its twin on that solve's inputs and timed.
6. The fused solve of the reference's bench config #8 (quota, Strict
   gangs, NUMA, reservations) at 5,000 nodes x 10,000 pods, with the
   NUMA least- and most-allocated scorers: ``kernel_solve_batch`` routed
   by ``kernel_routing_ok``, the kernel held against its twin on every
   output on the solve's first 1,000 pods (the full solve's first
   assignments equal to that cut's; the kernel timed at full size), and
   the whole kernel solve held against the loop
   ``solve_batch`` on the card at 1,000 x 2,000 (the loop runs a few
   dozen torch ops per pod). Then the one-block kernel's NUMA and
   reservation instances on config #8 cut to 800 x 2,000 (NUMA least,
   most, and reservations without NUMA).
7. The cluster kernel through ``parallel/mesh.shard_kernel_solver(k)``,
   for k in 2, 4, 8, 16, at the main path's solve (phase 3) and at
   config #8 with NUMA least and reservations (phase 6): each solve
   driven with the launch counts zeroed just before and read just after,
   held bit for bit against the routed solve (every output) and its
   kernel (every kernel output), and timed against it in the same
   process; a k whose slices do not fit shared memory runs the L2 form.
   At the fastest k the cluster kernel is held against its plain twin
   ``binpack_sharded_plain`` on the solve's first 1,000 pods (the full
   solve's first assignments equal to that cut's); the twin also checks it at
   k = 8 on phase 2's quota+gang problem (1,000 nodes) and at k = 4 on
   config #8 cut to 1,000 x 2,000 with NUMA most.
8. A solve beyond what 16 CTAs' shared memory holds (40,000 nodes x
   1,000 pods, quota and gangs): the L2 form at 16 CTAs, held against its
   twin and timed.
9. The scheduling round on the card: ``Scheduler(enable_preemption=
   False)`` fed through its intake methods. (a) Phase 3's world as a
   burst: ``schedule_pending`` must launch the routed cluster kernel once
   and equal the same feed through a Scheduler on ``PlacementModel(
   device="cpu")``; a second round with no new events must take the
   staging cache's delta path and equal the CPU run again. (b) The
   reference's bench config #9 (churn ticks: 5,000 nodes, 50 metric
   refreshes and a 64-pod wave per tick, 12 ticks) through three
   Schedulers fed the same events: on the card with the staging cache, on
   the card restaging in full every tick (``model.reset_staging()``), and
   on the CPU. Every tick's placements and waiting pods must be equal
   across the three, every card tick must launch the kernel once, and
   every delta tick after the first must take the delta path; after the
   last tick the cache, brought up to the cache's snapshot, must equal a
   fresh staging of it. Prints the median tick wall and the lower/stage/
   solve split of both card runs (ticks 0-1 excluded) and their ratio,
   then holds the kernel against its twin on the last tick's inputs.
10. The fine-grained burst through the Scheduler: phase 3's world with a
   ``zone`` label on every node, a NUMA topology on every 4th node, 8
   GPUs on every 10th, and, by a seeded draw, 100 cpuset (LSR) pods, 100
   GPU pods, 50 host-port pods (20 distinct ports) and 2,000 node-selector
   pods among the 10,000 pending (``testing.add_fine_grained``), fed with
   ``update_node_topology``/``update_node_devices``. Two rounds; each
   prints its wall and split, the refine iterations and the solver of
   every solve, the host time in ``FineGrained.rows``, the kernel's ms
   per launch, and the committed and waiting counts. Every solve must
   launch the routed kernel (none on the loop) and the final solve's
   launch must equal its twin bit for bit. The same stream cut to 1,000
   nodes x 2,000 pending (the same shares) must give, on the card and on
   the CPU, the same placements, annotations, NUMA and device
   allocations. A sub-run with node policy ``SingleNUMANode`` (every pod
   with requests special) at 200 x 400 records its host rows' cost.
   Beside phase 6's loop check, one extras solve (config #8 cut to 1,000
   x 2,000 with 20% selector rows and 5% fine-grained rows) runs on the
   kernel and on the loop, with equal results; both are timed.
11. Preemption on the card, on the reference's bench config #19 world
   (``testing.preemption_storm(seed=11, n_nodes=1250,
   residents_per_node=4, n_arrivals=1000)``: 5,000 preemptible BE
   residents packed tight, 1,000 PROD arrivals that fit nowhere without
   eviction). (a) The storm through ``Scheduler()`` with the reference's
   defaults (preemption on, victim selection on the device): rounds until
   no arrival is pending (at most 40); every round must launch the
   routed kernel once and give the same placements, nominations and
   evicted uids as a Scheduler on ``PlacementModel(device="cpu")`` fed
   the same events, and the final caches must be equal. Each round
   prints its wall, the model's lower/stage/solve split, the preemption
   time, the preemptors tried, the evictions and the placements; the
   kernel is held against its twin on round 0's inputs (all 1,000
   arrivals pending) and on the last round's. (b) The per-pod sweep of
   the first 24 arrivals: ``select_victims_device`` plus
   ``evict_resident_rows`` on the card against the host walk
   ``find_preemption`` plus a full re-lower per hit, identical (node,
   ordered victims) answers, pods/s of each and their ratio (median and
   range of 5 repeats, the arms in turns, each on a fresh world), at
   config #19's shape and at 5,000 nodes x 4 residents. (c) ``preempt_scan_
   device`` over all 1,000 arrivals in one call, equal to the CPU run,
   with its wall. (d) ``Scheduler.defrag_headroom`` (one arrival's
   requests, residents below priority 5,000) with ``preemption_backend=
   "verify"``: the device plan must equal the host plan.
12. Descheduling on the card: ``LowNodeLoad`` (``descheduler/
   loadaware.py``) whose "device" backend runs the balance sweep's scan
   kernel (``csrc/rebalance_sweep.cu``; every batch LowNodeLoad builds
   takes the "scan" route, and a pass must launch no serial kernel).
   (a) The reference's bench config #5
   (``testing.rebalance_world_spec``: 5,000 nodes, 30,000 running pods,
   seed 5; pool low CPU 45 / memory 60, high 65 / 80): "host", "device"
   and "verify" give the same ordered evictions as the port's
   ``RebalanceOracle``; ``balance()`` timed per backend, 5 repeats in
   turns. (b) Bench config #22 at its default (``testing.
   rebalance_storm_spec``: 400 nodes, 10 pods per hot node, seed 22; low
   30 / 30, high 60 / 60): device == host, then the budgeted arm
   (``MigrationArbiter(MigrationBudget(max_per_node=1))`` asked by the
   sink) must hold the reference's ``budget_bounded``, with its sweep
   launches (one per refusal), the wall of each re-scan (``DeviceSweep.
   refuse``: one launch, one read-back of the suffix) and, in a second
   run of the arm, the kernel's time per re-scan (CUDA events); then the
   same world and arbiter through ``Scheduler.rebalance_sweep`` must
   evict the same pods, and the next round's delta staging must equal a
   fresh staging. (c) Config #22 widened to 5,000 nodes (25,000
   candidates), device == host. For each of the three, both kernels (scan
   and serial) are held against the plain version on the pass's batch
   (every stream and the final headroom, exact) and timed in turns. (d)
   The serial route: a batch of 4,991 candidates whose ``high_q`` varies
   inside its nodes through ``run_balance_sweep`` (it must launch the
   serial kernel and no scan kernel), held and timed the same way; an
   empty kernel at the scan kernel's launch shape is timed beside it.
   Each pass is driven with the launch counts zeroed just before and read
   just after.
13. Serving: the solver sidecar on the card (phase 3's world through
   ``PlacementModel(backend=RemoteSolver)``, config #10's concurrent
   clients inline and gated, config #16's tenant pool, the lane kernel
   alone at K = 1-16, the solver binary).
14. The colocation loop on the card, on a seeded world at the scale of
   the overcommit calculator's own docstring (``testing.
   colocation_world_spec``: 5,000 nodes with native CPU and memory, 10%
   under a node-selector strategy override, 2% with a cpu-normalization
   ratio and 2% with a node reservation; 50,000 running pods, 60% prod
   LS, 10% LSE, 30% BE or free, 20% of the prod pods without usage;
   2,000 dangling usage entries; a NodeMetric per node, 5% stale, 5% with
   a BE host application; then 10,000 pending BE pods on batch CPU and
   memory). (a) ``NodeResourceController(device="cuda").reconcile_all``
   equals the same call on the CPU, every update field; its lowering,
   the step (CUDA events around ``_overcommit_step``), the read-back and
   the wall (median of 5 after a warm-up), the step's launches (torch
   profiler) and bound. (b) One ``APIServer``, ``Scheduler()`` on the
   card through ``wire_scheduler`` and ``wire_manager`` on the card: the
   world and the wave applied, round 1 places no BE pod, a reconcile
   PATCHes the batch columns, round 2 places the wave through the routed
   kernel (its delta restage == the synced nodes), 1% of the metrics
   change, a second reconcile syncs only nodes past the diff threshold
   and round 3 restages only the rows those events touched. Every round's
   placements, every published bind and every PATCHed node equal the same
   loop on the CPU; batch capacity holds on every node a round placed
   onto. Round 2's kernel is timed; the placement kernel is held against
   its twin on round 3's inputs and timed (``binpack_colocation``).
15. The pipelined and streaming loops on the card. (a) Bench config #13
   (5,000 nodes of 64,000 mCPU and 131,072 MiB, a metric each and 5,000
   assigned pods from ``default_rng(42)``; each tick 50 metric refreshes
   and 64 pods; a 50 ms cadence, 2 warm-up, 2 settle and 12 timed ticks)
   through ``wire_scheduler`` three ways: the serial loop on the card,
   ``TickPipeline`` on the card (tick t+1's arrivals applied while tick t
   is in flight) and the serial loop on the CPU. Placements are equal
   tick for tick and the bus's node accounting at the end; the route, the
   round critical path p50/p99 of each loop and ``TICK_STAGE_DURATION``
   by stage are printed. Then ``DEVICE_OBS.request_profile(rounds=8)``
   opens a ``torch.profiler`` window over 8 more pipelined ticks (closed
   by one more tick right after the 8th retired): from its trace, the
   device idle share (one minus the union of kernel, memcpy and memset
   intervals over the window's wall), its kernel count and the longest
   idle gap with the annotation it falls under. The placement kernel is
   held against its twin on a tick's inputs (``binpack_pipelined``).
   (c) A manual flight-recorder dump, taken while the pipelined
   Scheduler is alive, holds its ticks' records, the card's allocator
   numbers and its staged cache's bytes. (b) Bench config #18 (500 nodes,
   ``heavy_tail_trace(23, 4 s, R, cpu_cap=8000)``, watermark 64, lane
   deadlines 2/10/50 ms) at R = 200 and 800 pods/s: the adaptive
   ``StreamingLoop`` and the fixed 50 ms cadence, both pipelined on the
   card; every submitted pod resolves, submit->bind p50/p99 and rounds by
   trigger are printed, and the adaptive arm's round log replayed
   through the fixed-round loop equals it bit for bit (on the card, and
   on the CPU at 200). The shed-point ladder (1,000-16,000 pods/s, 1.5 s
   a rung) prints the highest rung that sheds nothing; a profiled 1 s
   run at 800 pods/s prints its idle share. One fixed watermark round
   (the 800 pods/s trace's first 64 arrivals on a fake clock, 500 x 64)
   is driven and its inputs held against the twin
   (``binpack_streaming``). A deferred
   publish-side error or a skipped round anywhere in the phase fails it.
16. The serving failure domain on the card. (a) Bench config #11
   (``testing.failure_domain.OUTAGE``: 512 nodes, 16 metric refreshes and
   32 pods a tick, 40 ticks) through ``build_scheduler(placement_backend=
   "sidecar", solver_failover=True)`` (threshold 2, recovery probes 2,
   a 0.5 s deadline) over a ``SolverSupervisor``'s real ``python -m
   koordinator_tpu_torch.cmd.solver`` child on the card (probe 0.2 s,
   backoff 8 s), the child SIGKILLed at tick 13: every tick equals the
   fault-free run on the card and the CPU run, no round is skipped, the
   modes run remote, local-fallback, local-degraded, remote, and the
   supervisor restarts once and ends running; the kill's anatomy, the
   child's boot, and the first local solve with and without ``prewarm``
   (each in a fresh process) are printed. The first local solve's inputs
   (``binpack_failover_local``) and the first remote solve after the
   flip back, a full restage the child solved (``binpack_sidecar_
   restaged``, its answer equal to the same kernel here), are held
   against the twin. (d) The child serves ``--debug-port`` and
   ``--hbm-budget-bytes``: ``debug_port_probe`` sees it healthy,
   ``/metrics`` carries the admission, device and working-set series and
   the ``solver`` and ``workingset`` services answer. Then the same stack
   under ``TickPipeline`` with the child killed mid-pipeline: no deferred
   error, every tick equal to the serial loop. (b) Bench config #21 (16
   tenants, 1,024-node worlds, 64-pod bursts) through
   ``solve_from_request`` and ``NodeStateCache`` at the f100, f50 and f25
   budget lines: every (tenant, round) placement and ``used_req`` equal to
   the unbudgeted arm, a host-rung demotion lowering
   ``torch.cuda.memory_allocated()`` by the world's bytes, and a
   host-rung tenant's first solve after its restage held against the twin
   (``binpack_workingset_restage``); then one real
   ``torch.cuda.OutOfMemoryError`` (the small pool's free blocks filled,
   the process capped with ``set_per_process_memory_fraction``) absorbed
   by the ladder: it demotes, the retry stages, the cap is lifted and the
   solve equals its twin. (c) Bench config #20's controller arm (16
   nodes, a 6 s diurnal trace at 50 pods/s at three regimes, target ls
   p99 5 ms, a 1 ms fake-clock grid) on the card and on the CPU: the
   target attained at each regime, at most 12 decisions, the decision log
   replayed bit for bit and equal to the CPU run's.
17. The plugin chain, the aggregated LoadAware mode and the explainer on
   the card. (a) Phase 3's world with seeded percentiles on every
   NodeMetric (``testing.plugin_chain.add_aggregated_usage``: p50 <= p90
   <= p95 <= p99 around the average, a 300 s and a 1,800 s window)
   through ``build_scheduler`` with upstream's aggregated LoadAware args
   (thresholds CPU 65 / memory 95 at p99) and score p99, then score p50
   (``est_extra`` goes negative): each round on the cluster kernel,
   capacity respected, its placements different from the unaggregated
   round's on the same world, the kernel held against its twin on the
   round's first 1,000 pods (the full round's first assignments equal to
   that cut's, the kernel timed at full size); then 4
   churn ticks of config #9 in the aggregated mode, delta staging == a
   full restage every tick (placements and every staged field). (b) The
   chain world (``plugin_chain.chain_world_spec``: 500 nodes, 256 pending
   in 8 quota groups, 16 reservations, no gangs): ``Scheduler()``'s
   batched round (one block) == ``build_scheduler(BatchedPlacement=
   false)`` through ``run_loop(once=True)`` (placements, reservations),
   the chain's ms per pod printed, the kernel held against its twin.
   (c) ``PlacementExplainer`` on the card for 16 pods of that world: the
   winner is ``schedule_one``'s node (or the quota verdict refuses), the
   feasible nodes' weighted totals are the chain's scores, the columns
   equal the CPU run; one ``explain_scores`` at 5,000 nodes, timed.
18. The binaries on the card, on a seeded cluster-spec JSON at the main
   path's width (5,000 nodes, 2 running pods a node, 10,000 pending).
   (a) ``python -m koordinator_tpu_torch.cmd.scheduler --once
   --cluster-json`` as a child: exit 0, its round line equal to the same
   round in this process (``build_scheduler`` + ``wire_scheduler`` +
   ``seed_bus_from_json`` + ``run_loop(once=True)``, the cluster kernel at
   5 CTAs, held against its twin); the child's wall split into start-up
   and imports, the kernel library's load, the bus seeding and the round.
   (b) ``run_loop(auditor=StateAuditor(interval_rounds=1, probe_rows=64))``
   on that scheduler: a clean sweep after the kernel round, its probe read
   back from the card; one staged CUDA row drifted (its host row
   untouched), reported as ``<node>:device:usage`` and restaged, the next
   round equal to a clean run's; a sweep at 5,000 nodes timed with its
   read-back's share. (c) ``cmd/descheduler.main(["--once",
   "--cluster-json", ...])`` (no usage: nothing migrates), then
   ``build_descheduler``'s ``Descheduler`` through
   ``DeschedulerLoop.run_once`` with 10 nodes over LowNodeLoad's high
   threshold, as many cycles as the anomaly debounce needs: equal to the
   same loop on the CPU (migrated uids, reservations' nodes, jobs' phases,
   the bus's pods after the scheduler's next round, which places every
   evicted pod on its reserved node); every probe's kernel == its twin,
   launches counted by route. (d) ``run_loop`` with
   ``build_rebalance_plugin`` at ``rebalance_backend="verify"`` over 3
   rounds, 100 nodes hot: the sweep kernel's decisions == the host walk.
   The child's split also prints the host cutoff probe's wall (its
   ``build_scheduler`` measures the cutoff), and the in-process round
   measures too.
19. The host route for tiny solves on the card. (a) ``models.placement.
   measure_host_fallback_cells()`` on ``cuda``, measured afresh with the
   launch counts zeroed (phase 18's build memoised it): the host's ns per
   cell, the device round's best ms (the routed kernel's launch and the
   read-back of ``assign``), the cutoff and the probe's wall; the probe's
   kernel held against its twin. (b) Seeded ``example_problem`` worlds of
   64, 512 and 5,000 nodes x 1, 4, 16 and 64 pods through
   ``PlacementModel(host_fallback_cells=1<<18)`` (n x p where that is
   more: 5,000 x 64) and ``PlacementModel(host_fallback_cells=0)`` on the
   card: the host route's
   result == the kernel's == the kernel's plain twin on every shape, each
   route's solve timed (best of 5, back to back, the read-back included;
   the kernel's staging, which a host-routed round skips, not counted);
   for each width the largest cell count at which the host was faster,
   beside the probe's cutoff. (c) ``churn_world(5000)`` through a default
   ``build_scheduler(SchedulerConfig())`` and one pinned at
   ``host_fallback_cells=0``, churn ticks of 1-64 pending pods: every
   tick's cells and ``last_solver`` printed, the route as the cutoff says,
   placements equal; with a cutoff under 5,000 cells the ticks are
   repeated on config #11's 512-node world. (d) The kill-the-leader chaos
   drive (``testing.chaos.drive_audited_cluster``: 8 nodes, 24 ticks of 4
   pods, the leader killed at tick 10, a sweep every 4 rounds) with a
   seeded schedule over the three ``STATE_FAULT_KINDS`` planted in the
   standby and the cutoff at 32 cells on even ticks and 0 on odd ones, on
   the card and on the CPU: equal saboteur logs, detections, repairs,
   per-tick placements and buses, equal to the crash-free run; the
   staged-row desync wrote a CUDA row and its sweep reported it. The
   kernel-routed solves of (a)-(d) are held against their twins.
20. The wire under faults, the eviction storm and the manager binary on
   the card. (a) Bench config #11 (512 nodes, 16 dirty and 32 pending a
   tick, 40 ticks) through ``RemoteSolver`` -> ``FailoverSolver`` ->
   ``testing.chaos.ChaosProxy`` with the six wire faults of
   ``FAULT_KINDS`` at the reference's request ordinals -> an
   ``InProcessSidecar`` on the card, supervised by ``check_once()`` on a
   fake clock (no backoff, no monitor thread), the stalled request alone
   under a per-solve deadline: every tick completes, the placements and
   staged node accounting equal the fault-free run on the card and on the
   CPU, every fault fired once, the failover flipped degraded and back;
   the one-block kernel held against its twin. (b) ``testing.chaos.
   eviction_storm_world`` at 10 and 256 nodes under the reference's
   schedule (``preemption-storm`` at tick 2, ``rebalance-wave`` at 5,
   ``budget-squeeze-mid-wave`` at 7) through a budgeted
   ``MigrationArbiter``, preemption on the card: no budget exceeded in
   any window (``check_budget_compliance``), each victim evicted once,
   typed deferrals, placements and node accounting equal to the
   fault-free arm and the CPU run; the storm rounds' kernel held against
   its twin. (c) ``python -m koordinator_tpu_torch.cmd.manager --once
   --cluster-json`` (phase 18's 5,000-node world, 10,000 running pods) as
   a child, its wall split into imports, wiring, the reconcile and the
   exit; in process, ``build_manager`` reconciles the running cluster and
   PATCHes the batch allocatable onto a bus (its step timed by CUDA
   events, with its launches), the 10,000 pending pods pass
   ``Manager.admit_pod`` (a ``ClusterColocationProfile`` makes a seeded
   half BE pods on batch resources), and a wired ``build_scheduler``
   runs one round (the cluster kernel at 5 CTAs); the same on the CPU,
   every pod's node equal; the round's kernel held against the CPU
   round's plain twin on the same inputs.
21. The node agents feed the colocation loop, at phase 18's width (5,000
   nodes, 10,000 running pods, 10,000 pending). (a) Every node has a
   ``StatesInformer``, a ``MetricCache`` and a ``NodeMetricReporter``
   (collect policy 300 s / 60 s, windows 300, 900 and 1,800 s); the first
   64 are wired through ``wire_koordlet`` and run ``MetricsAdvisor`` with
   ``default_collectors()`` over a fake procfs and cgroupfs tree of their
   own (seeded cumulative /proc/stat jiffies, meminfo, each running pod's
   ``cpuacct.usage`` and ``memory.usage_in_bytes``; every second agent's
   tree is cgroup v2: ``cpu.stat``'s ``usage_usec`` and ``memory.current``,
   and the cache its report is held to is fed the same whole
   microseconds), 11 ticks 30 s apart on
   a fake clock; the rest get the same kinds of samples appended directly
   at the same times. Every report goes onto the bus (the agents' through
   ``KoordletLoop.report``) with its percentiles and windows; each agent's
   report equals the report of a cache fed its samples directly, and
   every report equals the same fleet run beside a CPU manager. (b)
   ``wire_manager(bus, device=...)`` reconciles from those reports (the
   step timed by CUDA events, with its launches): the PATCHed batch
   allocatable equals the CPU run's. (c) A wired ``build_scheduler`` in
   the aggregated LoadAware mode (phase 17's filter, score p99) places the
   10,000 pending pods, a seeded half BE pods on batch resources (the
   cluster kernel at 5 CTAs); the kernel is held against its plain twin on
   the CPU (one torch thread) on the solve's first 1,000 pods, the full
   solve's first assignments equal to that cut's, and timed at full size.
   (d) On 200 nodes, each agent also wired with a ``NodeTopologyReporter``
   (``read_cpu_infos`` over a fake sysfs of 2 NUMA nodes, 32-64 CPUs) and a
   ``DeviceReporter`` over a seeded source of 8 GPUs, both through
   ``koordlet_report_sinks``: the NRT and Device CRs on the bus reach the
   NUMA manager and the device cache, and a round of 400 cpuset and GPU
   pods runs the one-block kernel with extras rows on every solve, equal
   to a CPU scheduler's round on copies of the same objects (placements,
   annotations, NUMA and device holds); its final solve held against its
   twin. Every tree lives under a temporary directory; every series keeps
   64 points (30 minutes at 30 s).
22. The node agents act on pressure and the card re-places their victims,
   on phase 21's world after its round 1 (the CPU run, in phase 21's child
   process, takes round 1's binds from the card's run: its wired scheduler
   observes them as another scheduler's). (a) Each of the 64 agents gets
   a ``QoSContext`` wired as the koordlet binary wires it (the informer as
   pod provider, its ``MetricCache``, a ``ResourceUpdateExecutor`` over its
   tree, the BE allocatable from the informer's node, the NodeSLO callback)
   and a ``QoSManager`` of the eight strategies; the manager's reconcile,
   with the ``NodeSLOController`` on, publishes every node's NodeSLO (BE
   thresholds on: memory evict at 70%, CPU suppress at 65%, the CPU evict
   satisfaction band 60-80%; the suppress policy cpuset on half the agents,
   cfsQuota on the other half, an extender) and the agents take it from
   the bus. (b) Seeded pressure: the kubelet's dirs of every running pod,
   a topology, a fake resctrl tree and /proc/sys/vm in each agent's tree;
   an LS pod with a CPU limit on each agent; 16 agents over the memory
   threshold; 16 agents' BE tier starved (three BE pods requesting plain
   CPU, the tier's cfs quota at half their request, their usage at that
   limit); 2 collector ticks; 600 of the other nodes (of those running a
   BE pod) over the memory threshold in their caches, each with a
   ``QoSManager`` of the memory evictor alone. (c) One QoS tick on every
   node; the eviction glue (here, not in the package) deletes each victim
   from the bus, removes its pod's dirs from its agent's tree (a ``PLEG``
   over each tree reports exactly the victims as deleted) and re-creates
   it unbound under a new name. (d) The agents collect again, every node
   reports, the manager reconciles, and the wired scheduler's round on the
   card places the re-created pods with round 1's leftovers (the cluster
   kernel at 5 CTAs), every placement within its node's allocatable as the
   bus holds it after the PATCH; the kernel held against its plain twin on
   the round's inputs. The CPU run's victims in order, trees, reports,
   batch allocatable and placements equal the card's.
23. The koordlet binary acts on the card's placements, on phase 21 (d)'s
   world after its round (the CPU run, in phase 21 (d)'s child process,
   after its own round). (a) Each of the 200 nodes gets a
   ``build_koordlet`` agent over its tree (cgroup v1 on even nodes, v2 on
   odd ones; NRI mode on half, crossed with the version; ``AuditEvents``
   on), the kubelet's dirs of every pod bound to it, ``wire_koordlet``, a
   NodeSLO with group identity on, its share pools from its NRT, and one
   tick on the fake clock: every pinned container holds its cpuset with
   cfs quota -1, every GPU pod's ``create_container`` env names exactly
   its minors, the bvt files are the rule's, no hook raised (each
   registry's ``run_hooks`` collects into a list). (b) 100 more cpuset
   and GPU pods are placed on the card (every solve on the one-block
   kernel with extras rows; the last held against its twin), their dirs
   made; the NRI half runs their hooks off the PLEG alone, the
   reconciler half on its next tick; 50 pinned pods are deleted and
   their dirs removed, the NRI half's stop stages run, no stale cpuset
   stays. (c) A cpu-normalization ratio of 1.25 on half the nodes
   rescales the cpu-share pods' quotas to ``ceil(q / 1.25)``; its removal
   from a quarter restores their spec quotas. (d) ``python -m
   koordinator_tpu_torch.cmd.koordlet --once --now`` in NRI mode over a
   copy of one agent's tree, its wall split into imports, build and the
   tick: its files equal an in-process ``build_koordlet(...).tick(now)``
   on a second copy. (e) ``PerfGroup.open_self()`` around the wave's
   round (or why it is refused), and the CPI collector over
   ``PerfGroup.fake`` sources in one agent. The CPU run's trees, ordered
   writes, server responses, audit events, NRI counts, quotas, CPI
   series and wave placements equal the card's. Phase 23 runs before
   phase 22 on the card (``node_agents``), so that its CPU half, which
   starts after phase 21 (d)'s CPU round, is done when the card's is.
24. The warm pool and the CRI proxy on the card. (a) Config #11's world
   (512 nodes; solves of 32 and 16 pods) on a ``cmd.solver`` child under
   ``SolverSupervisor`` with a store of the phase's own
   (``KTPU_COMPILATION_CACHE_DIR``; phases 1-23 run with it empty): the
   first child serves both signatures and persists them and the kernel
   library; SIGKILLed, it is respawned, restores before it binds (its
   report printed: restored, failed 0, rows, seconds), the supervisor
   reads its warm outcome off the debug mux (``respawns_warm_total`` 1,
   the warm ready grace), and its first remote solve is served from a
   replayed CUDA graph (``served`` + 1), equal to the plain twin and to
   a cold child's (``--no-warm-pool``) answer; the first solve's wall of
   each, in a fresh process. (b) The six ``WARM_POOL_FAULT_KINDS``, two
   to a copy of that store (one on each signature's entry, by
   ``testing.chaos.sabotage_store``), a child each: each reason counted,
   both entries quarantined, both first solves cold on the kernel and
   equal to the twin; the next respawn of each retries neither. (c) The
   main path's solve (phase 7's arguments, the cluster route at 5 CTAs)
   through an adopted binding, persisted, restored into a fresh pool as
   a graph and served twice with different pods: the first result
   unchanged by the second, both equal to the ordinary solve and to the
   plain twin on every pod (the first call's inputs are phase 4's, whose
   twin is reused; ``binpack_warm_served``: the replay's ms, the launches
   the replays counted). (d) In phase 23's run,
   after its wave: a kubelet stand-in's RunPodSandbox, CreateContainer,
   StartContainer and StopContainer for 50 of the wave's pods through a
   ``RuntimeManagerCriServer`` a node over each agent's hook server and
   a recording runtime (hook errors fail the call): every CreateContainer
   the runtime sees carries its cpuset and GPU env; a restarted proxy's
   ``fail_over`` rebuilds its store from the runtime's pods; ``python -m
   koordinator_tpu_torch.cmd.runtimeproxy --once`` on a short UDS path
   answers the frames as this process's proxy does, byte for byte.
   (e) (d)'s requests, stores and frames equal phase 23's CPU run.
Then one JSON line of kernels, and the result line ``{"ok": true,
"device": {...}}`` last.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import enum
import io
import json
import math
import os
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request
from collections import Counter
from contextlib import nullcontext, redirect_stdout

import numpy as np
import torch

from koordinator_tpu_torch import resolve_device, testing
from koordinator_tpu_torch.apis import types as ttypes
from koordinator_tpu_torch.apis.extension import (
    ANNOTATION_CPU_NORMALIZATION_RATIO,
    ANNOTATION_DEVICE_ALLOCATED,
    ANNOTATION_RESOURCE_STATUS,
    QoSClass,
    ResourceName,
)
from koordinator_tpu_torch.apis.types import (
    ClusterSnapshot,
    ReservationState,
    resources_to_vector,
)
from koordinator_tpu_torch.client import (
    APIServer,
    Kind,
    wire_koordlet,
    wire_manager,
    wire_scheduler,
)
from koordinator_tpu_torch.control import slo
from koordinator_tpu_torch.control.migration import (
    MigrationArbiter,
    MigrationBudget,
)
from koordinator_tpu_torch.descheduler import (
    LowNodeLoad,
    LowNodeLoadArgs,
    NodePool,
    loadaware,
)
from koordinator_tpu_torch.descheduler.framework import Evictor
from koordinator_tpu_torch.manager import noderesource, sloconfig
from koordinator_tpu_torch.manager.noderesource import NodeResourceController
from koordinator_tpu_torch.client.wiring import (
    koordlet_report_sinks,
    snapshot_from_bus,
    wire_descheduler,
    wire_pod_webhook,
)
from koordinator_tpu_torch.koordlet.metriccache import MetricCache, MetricKind
from koordinator_tpu_torch.koordlet.metricsadvisor import (
    CollectorContext,
    MetricsAdvisor,
)
from koordinator_tpu_torch.koordlet.metricsadvisor.collectors import (
    default_collectors,
)
from koordinator_tpu_torch.device.cache import (
    DeviceEntry,
    DeviceResourceName,
    DeviceType,
)
from koordinator_tpu_torch.koordlet.audit import Auditor
from koordinator_tpu_torch.koordlet.pleg import PLEG
from koordinator_tpu_torch.koordlet.qosmanager import (
    BlkIOReconcile,
    CgroupResourcesReconcile,
    CPUBurst,
    CPUEvictor,
    CPUInfo,
    CPUSuppress,
    MemoryEvictor,
    QoSContext,
    QoSManager,
    ResctrlReconcile,
    SystemConfigReconcile,
)
from koordinator_tpu_torch.koordlet.resourceexecutor import (
    ResourceUpdateExecutor,
)
from koordinator_tpu_torch.koordlet.resourceexecutor.executor import (
    ensure_cgroup_dir,
)
from koordinator_tpu_torch.koordlet.statesinformer import (
    DeviceReporter,
    NodeMetricReporter,
    NodeTopologyReporter,
    StatesInformer,
    pod_meta_from_spec,
)
from koordinator_tpu_torch.koordlet.statesinformer.states_informer import (
    StateKind,
)
from koordinator_tpu_torch.koordlet.system.cgroup import (
    CPU_ACCT_USAGE,
    CPU_BVT_WARP_NS,
    CPU_CFS_QUOTA,
    CPU_SET,
    CPU_STAT,
    MEMORY_USAGE,
    V1_SUBSYSTEMS,
    SystemConfig,
)
from koordinator_tpu_torch.koordlet.metricsadvisor.performance import (
    PerformanceCollector,
)
from koordinator_tpu_torch.koordlet.runtimehooks import (
    FailurePolicy,
    NodeTopoInfo,
    Stage,
    milli_cpu_to_quota,
)
from koordinator_tpu_torch.koordlet.runtimehooks.cpuset import (
    cpuset_from_annotation,
)
from koordinator_tpu_torch.native import PerfGroup, PerfUnavailable
from koordinator_tpu_torch.cmd.koordlet import KoordletConfig, build_koordlet
from koordinator_tpu_torch.koordlet.system.cpuinfo import read_cpu_infos
from koordinator_tpu_torch.manager.nodemetric import NodeMetricCollectPolicy
from koordinator_tpu_torch.manager.nodeslo import NodeSLOController
from koordinator_tpu_torch.metrics.components import (
    PIPELINE_DEFERRED_ERRORS,
    POD_E2E,
    ROUNDS_SKIPPED,
    STREAM_TRIGGERS,
    TICK_STAGE_DURATION,
)
from koordinator_tpu_torch.cmd import descheduler as desched_cmd
from koordinator_tpu_torch.cmd.manager import ManagerConfig, build_manager
from koordinator_tpu_torch.cmd.scheduler import (
    SchedulerConfig,
    build_rebalance_plugin,
    build_scheduler,
    run_loop,
    seed_bus_from_json,
)
from koordinator_tpu_torch.models import placement
from koordinator_tpu_torch.models.placement import PlacementModel
from koordinator_tpu_torch.ops import binpack_kernel as bk
from koordinator_tpu_torch.ops.binpack import (
    ExtrasRows,
    SolverConfig,
    solve_batch,
)
from koordinator_tpu_torch.ops.binpack import STAGED_NODE_FIELDS
from koordinator_tpu_torch.ops import rebalance as rb
from koordinator_tpu_torch.obs.device import DEVICE_OBS
from koordinator_tpu_torch.obs.explain import PlacementExplainer, explain_scores
from koordinator_tpu_torch.obs.flight import FLIGHT
from koordinator_tpu_torch.obs.timeline import PodTimelines
from koordinator_tpu_torch.obs.trace import TRACER
from koordinator_tpu_torch.oracle.rebalance import RebalanceOracle
from koordinator_tpu_torch.parallel.mesh import shard_kernel_solver
from koordinator_tpu_torch.scheduler.auditor import StateAuditor
from koordinator_tpu_torch.scheduler.plugins.reservation import reservation_free
from koordinator_tpu_torch.scheduler.preemption import find_preemption
from koordinator_tpu_torch.scheduler.pipeline import TickPipeline
from koordinator_tpu_torch.scheduler.scheduler import Scheduler
from koordinator_tpu_torch.scheduler.streaming import (
    StreamingConfig,
    StreamingLoop,
)
from koordinator_tpu_torch.service import failover
from koordinator_tpu_torch.service import server as srv
from koordinator_tpu_torch.service import tenancy
from koordinator_tpu_torch.service.client import PlacementClient, RemoteSolver
from koordinator_tpu_torch.service.codec import (
    SolveRequest,
    decode_response,
    encode_request,
    read_frame,
    write_frame,
)
from koordinator_tpu_torch.service.supervisor import (
    SolverSupervisor,
    connection_probe,
    debug_port_probe,
    debug_port_warm_outcome,
)
from koordinator_tpu_torch.service import warmpool
from koordinator_tpu_torch.service.warmpool import WarmPool
from koordinator_tpu_torch.runtimeproxy import (
    CRIRequest,
    RuntimeManagerCriServer,
)
from koordinator_tpu_torch.cmd import runtimeproxy as proxy_cmd
from koordinator_tpu_torch.state.cluster import (
    ClusterDeltaTracker,
    evict_resident_rows,
    lower_nodes,
)
from koordinator_tpu_torch.state.workingset import WORKING_SET
from koordinator_tpu_torch.testing import chaos, plugin_chain
from koordinator_tpu_torch.testing.arrivals import (
    REGIMES,
    diurnal_trace,
    heavy_tail_trace,
    regime_scale,
    trace_pods,
)
from koordinator_tpu_torch.webhook import ClusterColocationProfile
from koordinator_tpu_torch.testing.failure_domain import (
    DENSITY,
    OUTAGE,
    SLO,
    density_arm,
    density_stream,
    mode_runs,
    outage_churn,
    slo_arm,
)

# phases 1-23 run with the warm pool inert (so every solve is issued as
# it was before the pool existed); phase 24 gives its children a store
os.environ["KTPU_COMPILATION_CACHE_DIR"] = ""

# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
#: scalar 32-bit operations per second outside the tensor cores (the
#: data sheet's float32 rate; int32 issues at no higher rate)
SCALAR_OPS_PER_S = 67e12
#: integer operations per (pod, node) pair the placement must do: per
#: resource, fit (add, compare, and), LeastAllocated and LoadAware terms
#: (2 adds for the estimate, 2 x (sub, mul, clamp, divide, compare,
#: select, weight mul, add)) = 21; then 2 divides, the score add, the
#: mask, the packed key (shift, or) and the max
OPS_PER_PAIR = 8 * 21 + 8
#: more per (pod, node) pair with NUMA: per resource the requested test,
#: the count, nreq (sub, add), cap > 0, nreq <= cap, and, the numerator
#: (sub), * 100, divide, the sum (11); then the divide, the count test
#: and the add into the score
NUMA_OPS_PER_PAIR = 8 * 11 + 3
#: per (pod, reservation) pair: the match test; per matched pair the 8
#: subtractions of the credit
CREDIT_OPS_PER_MATCH = 8
#: per (pod with an extras row, node) pair: the mask test, the score add
EXTRAS_OPS_PER_PAIR = 2

# the flagship burst (BASELINE.json north star) and BASELINE configs #3/#4
NODES, ASSIGNED_PER_NODE, PENDING = 5000, 2, 10000
QUOTA_NODES, QUOTA_PODS, QUOTAS, GANGS, GANG_SIZE = 1000, 5000, 50, 200, 32
# phase 5: reservations owned by gang label, and migration reservations
LABEL_RESV, MIGRATION_RESV = 200, 56
# phase 6: bench config #8 at its own shape; the loop comparison's cut;
# the cut whose NUMA + reservation slice fits one CTA
FUSED_NODES, FUSED_PODS = 5000, 10000
LOOP_NODES, LOOP_PODS = 1000, 2000
BLOCK_NODES, BLOCK_PODS = 800, 2000
# phase 7: CTAs of the cluster kernel; the reduced checks' CTA counts
SHARDS = (2, 4, 8, 16)
QUOTA_SHARDS, LOOP_SHARDS = 8, 4
# phase 8: past 16 CTAs' shared memory (quota pods, gangs x members)
L2_NODES, L2_QUOTA_PODS, L2_GANGS, L2_GANG_SIZE = 40000, 600, 20, 20
# phase 2: quota tables beyond shared memory (nodes, pods, groups)
WIDE_NODES, WIDE_PODS, WIDE_QUOTAS = 1000, 2000, 2000
# phase 9: bench config #9 (nodes, metric refreshes and pending per tick,
# ticks; ticks before WARM_TICKS are left out of the times)
CHURN_NODES, CHURN_DIRTY, CHURN_PENDING, CHURN_TICKS = 5000, 50, 64, 12
WARM_TICKS = 2
# phase 10: the fine-grained pods of the burst (cpuset, GPU, host-port,
# node-selector pods; distinct host ports), the cut held against the
# CPU, the SingleNUMANode sub-run, and the extras solve's row shares
FINE_CPUSET, FINE_GPU, FINE_PORTS, FINE_SELECTOR, FINE_DISTINCT = (
    100, 100, 50, 2000, 20)
FINE_CUT_NODES, FINE_CUT_PENDING = 1000, 2000
SNN_NODES, SNN_PENDING = 200, 400
EXTRAS_SELECTOR, EXTRAS_SCORED = 0.2, 0.05
# phase 11: bench config #19 (seed, nodes, residents per node, arrivals),
# the round cap, the per-pod sweep's pods and its wider node count, and
# the defrag's drain priority bound
STORM_SEED, STORM_NODES, STORM_RPN, STORM_ARRIVALS = 11, 1250, 4, 1000
STORM_MAX_ROUNDS = 40
SWEEP_PODS, SWEEP_WIDE_NODES, SWEEP_REPEATS = 24, 5000, 5
DEFRAG_MAX_PRIORITY = 5000
# phase 12: bench config #5 (nodes, running pods, seed) and its pool (low,
# high percent of CPU and memory); config #22 (nodes, pods per hot node,
# seed) and its pool, at the reference's default and widened to the main
# path's node count; balance() repeats per backend, in turns
REBAL_NODES, REBAL_PODS, REBAL_SEED = 5000, 30000, 5
REBAL_LOW, REBAL_HIGH = (45, 60), (65, 80)
STORM22_NODES, STORM22_PPN, STORM22_SEED = 400, 10, 22
STORM22_WIDE_NODES = 5000
STORM22_LOW, STORM22_HIGH = (30, 30), (60, 60)
BALANCE_REPEATS = 5
# the serial route's batch (candidates, seed); empty launches timed;
# the budgeted arm's re-scans replayed per queue of launches
VARIED_K, VARIED_SEED = 4991, 23
EMPTY_REPS = 200
REPLAY_CHUNK = 200
#: cycles the card sleeps per queued call in :func:`device_ms` (~115 us
#: at 1.7 GHz, above the host's time to launch one sweep)
SLEEP_CYCLES_PER_CALL = 200_000
#: integer operations per candidate of the balance sweep: per resource
#: the start select, the over test and its mask, the headroom test and its
#: mask, the two subtractions (48); the two votes, the propose logic and
#: the store (6)
SWEEP_OPS_PER_CANDIDATE = 8 * 6 + 6

# phase 13: bench config #10 (clients, nodes x pods, timed and warm-up
# rounds) and #16 cut to 5 timed rounds (tenants, nodes x pods a tenant,
# timed and warm-up rounds); the lane kernel's K and shapes
CONC_CLIENTS, CONC_NODES, CONC_PODS, CONC_ROUNDS, CONC_WARMUP = (
    8, 500, 32, 30, 2)
POOL_TENANTS, POOL_NODES, POOL_PODS, POOL_ROUNDS, POOL_WARMUP = (
    16, 1024, 64, 5, 3)
LANE_KS = (1, 2, 8, 16)
#: cycles the card sleeps per queued lane launch (~2.3 ms at 1.7 GHz,
#: above the host's ~0.5 ms to issue one: records, checks, the launch)
LANE_SLEEP_CYCLES = 4_000_000
LANE_SHAPES = ((500, 32), (1024, 64))
#: pod counts of config #10's lanes held at unequal counts on its base
CONC_UNEQUAL_PODS = (32, 1, 17, 32, 5, 9, 31, 24)
SOCKET_TIMEOUT_S = 600.0
#: the reference's lane batches: the jax.vmap of the scan over K plain
#: solves (admission.py: one shared base; tenancy.py: a base per lane)
LANES_REPLACES = ("koordinator_tpu/service/admission.py:238",
                  "koordinator_tpu/service/tenancy.py:409")

# phase 14: the overcommit docstring's scale (nodes, running pods a node,
# dangling usage entries, pending BE pods, seed); the share of metrics
# changed before the second reconcile; the controller's timed repeats
COLOC_NODES, COLOC_PPN, COLOC_DANGLING, COLOC_PENDING, COLOC_SEED = (
    5000, 10, 2000, 10000, 11)
COLOC_CHANGED = 0.01
COLOC_REPEATS = 5
# phase 15: bench config #13 (nodes, metric refreshes and pending per
# tick, cadence, warm-up, settle and timed ticks) and the profile
# window's rounds; bench config #18 (nodes, trace seed and seconds, the
# rates, the fixed arm's cadence, the watermark), its shed-point ladder
# (rates, seconds a rung, seed) and the profiled run's seconds
PIPE_NODES, PIPE_DIRTY, PIPE_PENDING = 5000, 50, 64
PIPE_INTERVAL_S, PIPE_WARMUP, PIPE_SETTLE, PIPE_TIMED = 0.05, 2, 2, 12
PROFILE_ROUNDS = 8
STREAM_NODES, STREAM_SEED, STREAM_SECONDS = 500, 23, 4.0
STREAM_RATES = (200.0, 800.0)
STREAM_INTERVAL_S, STREAM_WATERMARK = 0.05, 64
LADDER_RATES, LADDER_SECONDS, LADDER_SEED = (
    (1000.0, 2000.0, 4000.0, 8000.0, 16000.0), 1.5, 31)
STREAM_PROFILE_SECONDS = 1.0
# phase 16: bench config #11 (testing.failure_domain.OUTAGE) and its
# pipelined form (ticks, the tick before which the child is killed, the
# tick that waits for the respawn, the respawn backoff); the supervised
# child's working-set budget in 512-node worlds; config #21's timed
# rounds (the rest in testing.failure_domain.DENSITY; #20's in SLO)
OUTAGE_PIPE_TICKS, OUTAGE_PIPE_KILL, OUTAGE_PIPE_WAIT = 16, 5, 9
OUTAGE_PIPE_BACKOFF_S = 2.0
OUTAGE_BUDGET_WORLDS = 4
DENSITY_TIMED = 6
#: the supervised solver's extra arguments and the device of the
#: first-local-solve processes (a CPU rehearsal passes ("--device",
#: "cpu") and "cpu")
CHILD_ARGV = ()
CHILD_DEVICE = "cuda"
# phase 17: the percentile seed of the aggregated world; the filter
# thresholds and percentile (upstream LoadAwareSchedulingArgs.aggregated)
# and the two score percentiles (p99, and p50, the negative-est_extra
# arm); the aggregated churn ticks; the chain world (nodes, pending,
# quota groups, reservations) and the pods the explainer is asked about
AGG_SEED = 5
AGG_THRESHOLDS = {ResourceName.CPU: 65, ResourceName.MEMORY: 95}
AGG_USAGE_PCT, AGG_SCORE_PCTS = 99, (99, 50)
AGG_CHURN_TICKS = 4
CHAIN_NODES, CHAIN_PENDING, CHAIN_QUOTAS, CHAIN_RESV = 500, 256, 8, 16
EXPLAIN_PODS = 16
#: gates of the phase's batched rounds: its solves alone, as phase 9's
#: ``enable_preemption=False``
NO_PREEMPTION = "ElasticQuotaPreemption=false"

# phase 18: the binaries' world (the main path's width; its seed and the
# running pods a node), the auditor's probe rows and arrivals a round, the
# descheduler's hot nodes and the in-loop rebalance's hot nodes and rounds
BIN_SEED = 18
BIN_ASSIGNED = 2
AUDIT_PROBE = 64
AUDIT_ARRIVALS = 64
DESCHED_HOT = 10
REBAL_LOOP_HOT = 100
REBAL_LOOP_ROUNDS = 3
BINARY_TIMEOUT_S = 300
# phase 19: the crossover's widths, pod counts and timed repeats; the
# churn ticks' pending pods at the main path's width; the chaos drive's
# seed and its host cutoff on even ticks (8 nodes x 4 pods)
HOST_WIDTHS = (64, 512, 5000)
HOST_PODS = (1, 4, 16, 64)
HOST_REPS = 5
HOST_TICK_PODS = (1, 2, 4, 8, 16, 32, 64)
CHAOS_SEED = 31
CHAOS_HOST_CELLS = 32
# phase 20: (a) the six wire faults at the reference's request ordinals
# (tests/test_chaos.py), the stalled request's ordinal, the stall and the
# per-solve deadline set for that one request, the tick of the
# supervisor's respawn; (b) the eviction storm's seed, schedule and sizes
# (nodes, ticks; the reference's 10 nodes and 256), its budgets' caps a
# node count (the reference's at 10 nodes, 8x at 256); (c) the admission
# wave's seed (a seeded half of the pending pods becomes BE)
WIRE_FAULTS = {6: "torn-response", 10: "corrupt-response", 14: "stall",
               18: "drop-base", 22: "reset-request", 26: "kill-server"}
WIRE_STALL_ORDINAL = 14
WIRE_STALL_S, WIRE_STALL_DEADLINE_S = 0.6, 0.25
WIRE_RESPAWN_TICK = 28
EVSTORM_SEED = 11
EVSTORM_SCHEDULE = {2: "preemption-storm", 5: "rebalance-wave",
                    7: "budget-squeeze-mid-wave"}
EVSTORM_SIZES = ((10, 14), (256, 24))
ADMIT_SEED = 20
#: torch's intra-op threads for the CPU rounds (phases 14, 20-23)
CPU_ROUND_THREADS = 1
# phase 21: the node agents. The fleet's collect policy (primary window
# and report interval, s), the nodes whose agent runs the collectors over
# a fake procfs/cgroupfs tree, the collectors' ticks, their spacing (s)
# and the fake clock's start; the seeds of the usage draw, of the BE half
# and of the GPU inventories; round 2's GPUs a node and their memory
# sizes (MiB); the points a series keeps (the 30-minute retention at the
# collectors' 30 s: 60)
KOORD_POLICY = (300, 60)
KOORD_AGENTS = 64
KOORD_CAPACITY = 64
KOORD_TICKS, KOORD_STEP_S, KOORD_T0 = 11, 30.0, 1_000_000.0
KOORD_SEED, KOORD_BE_SEED, KOORD_GPU_SEED = 21, 22, 23
KOORD_GPUS, KOORD_GPU_MIB = 8, (16384, 40960, 81920)
# phase 22: the agents act. The NodeSLO's BE thresholds (percent: memory
# evict, CPU suppress, the CPU evict satisfaction band), the collectors'
# ticks under pressure, the agents over the memory threshold and those
# whose BE tier is starved, the nodes fed directly that go over the memory
# threshold, and the seed of the pressure
QOS_MEMORY_EVICT, QOS_CPU_SUPPRESS, QOS_SATISFACTION = 70, 65, (60, 80)
QOS_PRESSURE_TICKS = 2
QOS_MEMORY_AGENTS, QOS_STARVED_AGENTS, QOS_FED_PRESSED = 16, 16, 600
QOS_SEED = 24
# phase 23: the koordlet binary acts on the card's placements. The second
# wave's pods and its seed, the pods deleted after it, the normalization
# ratio, the agents' reconcile interval (s) and the clock of their first
# tick (after round 2's), the binary child's gates, the CPI collector's
# ticks
HOOKS_WAVE, HOOKS_DELETED, HOOKS_SEED = 100, 50, 25
HOOKS_RATIO = 1.25
HOOKS_RECONCILE_S = 10.0
HOOKS_GATES = "AuditEvents=true"
HOOKS_CHILD_GATES = "CPICollector=true,AuditEvents=true"
HOOKS_CPI_TICKS = 3
#: the pods the full-size plain twins of phases 6, 7 and 17 are cut to
#: (their kernels still timed at full size)
TWIN_CUT_PODS = 1000
# phase 24: the warm respawn's two signatures (config #11's 512 nodes at
# two pod counts), the respawned child's warm ready grace, the store
# faults applied two to a store (each pair of distinct reasons), and the
# CRI proxy's pods of phase 23's second wave
WARM_PODS = (32, 16)
WARM_GRACE_S = 30.0
WARM_FAULT_PAIRS = (("truncated-entry", "bitflipped-entry"),
                    ("stale-host-fingerprint", "wrong-magic"),
                    ("torn-concurrent-write", "oversize-entry"))
WARM_REASONS = {"truncated-entry": "truncated",
                "bitflipped-entry": "fingerprint",
                "stale-host-fingerprint": "stale-host",
                "torn-concurrent-write": "fingerprint",
                "wrong-magic": "corrupt", "oversize-entry": "oversized"}
PROXY_PODS = 50
#: phase 24 (d)'s walls on the card: the proxies, the binary child
PHASE24_TIMES = {}
SOURCE = "koordinator_tpu_torch/csrc/binpack.cu"
CLUSTER_SOURCE = "koordinator_tpu_torch/csrc/binpack_cluster.cu"
REPLACES = "koordinator_tpu/ops/pallas_binpack.py"
SWEEP_SOURCE = "koordinator_tpu_torch/csrc/rebalance_sweep.cu"
SWEEP_REPLACES = "koordinator_tpu/ops/rebalance.py:211"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, cycles_per_call=None):
    """ms per call of ``fn`` (which must not synchronise) on the card,
    the calls queued behind a sleeping kernel of ``cycles_per_call``
    cycles a call (default ``SLEEP_CYCLES_PER_CALL``; it must outlast the
    host's time to issue a call) so that the card runs them back to back
    (a kernel of a few microseconds is otherwise timed at the host's
    launch rate)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep((cycles_per_call or SLEEP_CYCLES_PER_CALL) * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    err = 0
    for g, w, name in zip(got, want, got._fields):
        if g is None and w is None:
            continue
        if not bool((g == w).all()):
            raise AssertionError(f"kernel != plain twin on {name}")
        err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def bound(inp):
    """(bound_ms, bound_by): the larger of every input read once and every
    output written once at the memory rate, and the operations this
    data needs at the scalar rate: the (pod, schedulable node) pairs,
    with the NUMA terms when NUMA is on, plus one match test per (pod,
    reservation) pair and the credit's subtractions per matched pair,
    and the extras rows' mask test and score add per (pod with a row,
    schedulable node) pair."""
    return bound_of(*bound_parts(inp))


def bound_of(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_parts(inp):
    """(bytes, operations) of :func:`bound`."""
    tensors = [t for x in inp if isinstance(x, (torch.Tensor, tuple))
               for t in (x if isinstance(x, tuple) else (x,))]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    p, n = inp.req.shape[0], inp.alloc.shape[0]
    out_words = p + 3 * n * 8                          # assign, carries
    if inp.quota is not None:
        out_words += 2 * inp.quota[0].numel()          # qused, qnp
    if inp.numa is not None:
        out_words += n * 8 + p                         # numa_free, consumed
    per_pair = OPS_PER_PAIR
    if inp.numa is not None:
        per_pair += NUMA_OPS_PER_PAIR
    ops = p * int(inp.sched.sum()) * per_pair
    if inp.resv is not None:
        match = inp.resv[4]
        out_words += p + 2 * p * 8 + inp.resv[0].numel()  # vstar, delta, rem, free
        ops += match.numel() + CREDIT_OPS_PER_MATCH * int(match.sum())
    if inp.extras is not None:
        # the compact rows are inputs, read once (counted above); per
        # (pod with a row, schedulable node) pair the mask test and the
        # score add
        ops += (EXTRAS_OPS_PER_PAIR * int((inp.extras[0] >= 0).sum())
                * int(inp.sched.sum()))
    nbytes += 4 * out_words
    return nbytes, ops


def variant(inp) -> str:
    """The kernel instance's variant, from its inputs."""
    parts = []
    if inp.numa is not None:
        parts.append("numa_most" if inp.most_allocated else "numa_least")
    if inp.resv is not None:
        parts.append("resv")
    if inp.quota is not None:
        parts.append("quota")
    return "_".join(parts) or "plain"


def route_name(route) -> str:
    return ("block" if route.kind == "block"
            else f"{route.kind}_k{route.shards}")


def twin(inp, route):
    """The plain twin of the kernel ``route`` names."""
    if route.kind == "block":
        return bk.binpack_plain(inp)
    return bk.binpack_sharded_plain(inp, route.shards)


def compare(inp, label, card, reps=3, shards=None) -> dict:
    """Run ``inp`` on the kernel the route names (or the cluster kernel
    at ``shards`` CTAs), hold it against that kernel's plain twin
    (tolerance: exact, every output) and time both on the card: the
    kernel over ``reps`` launches after the comparison's launch as
    warm-up, the twin over its one comparison run."""
    def run():
        return (bk.binpack(inp) if shards is None
                else bk.binpack_sharded(inp, shards))

    got = run()
    route = bk.route_of(inp, shards)
    torch.cuda.synchronize()
    want = []
    plain_ms = cuda_ms(lambda: want.append(twin(inp, route)), 1)
    err = max_abs_err(got, want[0])
    ms = cuda_ms(run, reps)
    bound_ms, bound_by = bound(inp)
    p = inp.req.shape[0]
    placed = int((got.assign >= 0).sum())
    quota_in = "shared" if route.quota_shared else "device"
    print(f"{label}: {route_name(route)} kernel == plain twin ({placed}/{p} "
          f"placed, max_abs_err {err}) [{card}]: kernel {ms:.3f} ms "
          f"({ms / p * 1e3:.3f} us/pod, {route.n_loc} rows per CTA, smem "
          f"{route.smem} B, quota tables in {quota_in} memory), plain twin "
          f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by})",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, route=route,
                variant=variant(inp), twin_out=want[0])


def first_pods(inp, pods):
    """The solve of ``inp``'s first ``pods`` pods alone: the same instance
    on the same node state with its pod axis cut (the kernel places pods
    in order, so its assignments are the full solve's first ones)."""
    cut = dict(req=inp.req[:pods], est=inp.est[:pods],
               flags=inp.flags[:pods])
    if inp.numa is not None:
        cut["numa"] = (*inp.numa[:3], inp.numa[3][:pods])
    if inp.resv is not None:
        cut["resv"] = (*inp.resv[:4], inp.resv[4][:pods])
    if inp.extras is not None:
        cut["extras"] = (inp.extras[0][:pods], *inp.extras[1:])
    return inp._replace(**cut)


def compare_cut(inp, label, card, reps=3, shards=None,
                pods=TWIN_CUT_PODS) -> dict:
    """:func:`compare` for a full-size solve whose plain twin would take
    tens of seconds: the kernel held against its twin (every output) on
    the solve's first ``pods`` pods, the full solve's first assignments
    equal to that cut's, and the kernel timed at full size (``ms``; the
    twin's ``plain_ms`` is the cut's; the bound is the full solve's)."""
    def run(x):
        return (bk.binpack(x) if shards is None
                else bk.binpack_sharded(x, shards))

    cut = first_pods(inp, pods)
    stats = compare(cut, f"{label}, cut to its first {pods} pods", card,
                    reps=reps, shards=shards)
    assert torch.equal(run(inp).assign[:pods], run(cut).assign), (
        f"{label}: the full solve's first {pods} assignments != the cut's")
    ms = cuda_ms(lambda: run(inp), reps)
    bound_ms, bound_by = bound(inp)
    p = inp.req.shape[0]
    print(f"{label}: the full solve's first {pods} assignments == the cut's; "
          f"full-size kernel {ms:.3f} ms ({ms / p * 1e3:.3f} us/pod), bound "
          f"{bound_ms:.5f} ms ({bound_by})", flush=True)
    stats.update(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                 variant=variant(inp))
    return stats


def entry(name_prefix, launches, stats, replaces_line) -> dict:
    """A ``kernels`` line entry from :func:`compare`'s stats."""
    route = stats["route"]
    return dict(name=f"{name_prefix}_{route_name(route)}_{stats['variant']}",
                replaces=f"{REPLACES}:{replaces_line}",
                source=SOURCE if route.kind == "block" else CLUSTER_SOURCE,
                launches=launches, **{k: stats[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by")})


def capacity_ok(snap, result) -> None:
    """Independent check: on every node, the assigned pods, the holds of
    the reservations still Available after the solve, and the committed
    and waiting placements fit its allocatable on each resource a placed
    pod requests."""
    alloc = {n.name: resources_to_vector(n.allocatable) for n in snap.nodes}
    load = {n: np.zeros_like(v) for n, v in alloc.items()}
    for pod in snap.pods:
        load[pod.node_name] += resources_to_vector(pod.requests)
    for resv in snap.reservations:
        if resv.state == ReservationState.AVAILABLE and resv.node_name in load:
            load[resv.node_name] += reservation_free(resv)
    placed = {**{u: n for u, n in result.items() if n is not None},
              **result.waiting}
    by_uid = {p.uid: p for p in snap.pending_pods}
    for uid, node in placed.items():
        load[node] += resources_to_vector(by_uid[uid].requests)
    for uid, node in placed.items():
        req = resources_to_vector(by_uid[uid].requests)
        over = (req > 0) & (load[node] > alloc[node])
        assert not over.any(), f"{node} overcommitted"


def drive(run, wrapper="binpack", clone=False):
    """Run one path with every kernel input it hands ``bk.<wrapper>``
    captured with the route it took (with ``clone``, copies: a later
    round scatters the staged state in place), every launch count zeroed
    just before and read just after (a device synchronise ends the timed
    span). Returns ``(result, launches by route kind, wall_s, captured
    [(inputs, route)])``."""
    captured = []
    launch = getattr(bk, wrapper)

    def capture(inp, *args):
        kept = clone_args(inp) if clone else inp
        out = launch(inp, *args)
        captured.append((kept, bk.route_of(inp, *args)))
        return out

    setattr(bk, wrapper, capture)
    try:
        for kind in bk.LAUNCHES:
            bk.LAUNCHES[kind] = 0
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(bk.LAUNCHES)
    finally:
        setattr(bk, wrapper, launch)
    return result, launches, wall, captured


def routed(label, launches, captured, kind=None):
    """The one solve a driven path made: it launched the kernel its route
    names once and no other (and ``kind`` when given). Returns
    ``(inputs, route)``."""
    assert len(captured) == 1, f"{label}: {len(captured)} solves"
    inp, route = captured[0]
    want = {k: int(k == route.kind) for k in bk.LAUNCHES}
    assert launches == want, f"{label}: launches {launches}, route {route}"
    assert kind is None or route.kind == kind, f"{label}: route {route}"
    return inp, route


def _specs(snap):
    return [(r.name, r.allocated, r.allocated_pod_uids, r.state)
            for r in snap.reservations]


def _records(book):
    return {uid: (name, delta.tolist()) for uid, (name, delta) in book.items()}


def schedule_path(snapshot, label, card, kind):
    """``PlacementModel().schedule`` on ``snapshot()`` through the kernel,
    checked: every pod decided, some committed, node capacity respected,
    and equal to ``PlacementModel(device="cpu")`` on an identical
    snapshot (placements, waiting pods, reservation records and specs);
    the route must be ``kind``. Returns ``(result, launches of the routed
    kernel, captured kernel inputs)``."""
    snap = snapshot()
    model = PlacementModel()
    result, launches, wall, captured = drive(lambda: model.schedule(snap))
    assert model.last_solver == "kernel", model.last_solver
    _, route = routed(label, launches, captured, kind)
    assert len(result) == len(snap.pending_pods)
    committed = sum(n is not None for n in result.values())
    assert committed > 0
    capacity_ok(snap, result)
    cpu_model = PlacementModel(device="cpu")
    cpu_snap = snapshot()
    reference = cpu_model.schedule(cpu_snap)
    assert cpu_model.last_solver == "kernel"
    assert dict(result) == dict(reference), "cuda != cpu placements"
    assert result.waiting == reference.waiting
    assert _records(result.resv_allocs) == _records(reference.resv_allocs)
    assert (_records(result.resv_committed)
            == _records(reference.resv_committed))
    assert _specs(snap) == _specs(cpu_snap), "cuda != cpu reservations"
    tm = model.last_timings
    print(f"{label} [{card}]: {len(snap.nodes)} nodes, "
          f"{len(snap.pending_pods)} pending: {committed} committed, "
          f"{len(result.waiting)} waiting; lower_s {tm['lower_s']:.4f} "
          f"stage_s {tm['stage_s']:.4f} solve_s {tm['solve_s']:.4f} wall "
          f"{wall:.4f} s = {len(snap.pending_pods) / wall:.1f} pending pods/s "
          f"(n_pending / wall); cuda == cpu; route {route_name(route)} "
          f"({route.n_loc} rows per CTA); launches {launches[route.kind]}",
          flush=True)
    warm = PlacementModel()
    warm_snap = snapshot()
    t0 = time.perf_counter()
    warm.schedule(warm_snap)
    wall = time.perf_counter() - t0
    tm = warm.last_timings
    print(f"{label}, a second run on a fresh model [{card}]: lower_s "
          f"{tm['lower_s']:.4f} stage_s {tm['stage_s']:.4f} solve_s "
          f"{tm['solve_s']:.4f} wall {wall:.4f} s = "
          f"{len(warm_snap.pending_pods) / wall:.1f} pending pods/s",
          flush=True)
    return result, launches[route.kind], captured


def same_solve(got, want) -> None:
    """Two SolveResults equal on every tensor, the node and quota states
    included (tolerance: exact)."""
    for name, g, w in zip(want._fields, got, want):
        if w is None:
            assert g is None, name
        elif isinstance(w, tuple):
            same_solve(g, w)
        else:
            assert torch.equal(g, w), f"kernel solve != loop solve on {name}"


def loop_check(most, card) -> None:
    """The whole kernel solve (the kernel and the gang epilogue) against
    the loop ``solve_batch`` on the card, on bench config #8 cut to
    LOOP_NODES x LOOP_PODS."""
    s_, p_, pr, q, g, rv, aux = testing.full_features_problem(
        LOOP_NODES, LOOP_PODS, seed=8)
    got = []
    ms = cuda_ms(lambda: got.append(bk.kernel_solve_batch(
        s_, p_, pr, q, g, numa_aux=aux, resv=rv, most_allocated=most)), 1)
    want = []
    loop_ms = cuda_ms(lambda: want.append(solve_batch(
        s_, p_, pr, SolverConfig(numa_most_allocated=most), q, g, resv=rv,
        numa=aux)), 1)
    same_solve(got[0], want[0])
    print(f"kernel_solve_batch == loop solve_batch, config #8 cut to "
          f"{LOOP_NODES} nodes x {LOOP_PODS} pods, NUMA "
          f"{'most' if most else 'least'} [{card}]: "
          f"{int(got[0].commit.sum())} committed; kernel solve {ms:.3f} ms, "
          f"loop {loop_ms:.3f} ms", flush=True)


def main_path_solve_args(snapshot):
    """The solve ``PlacementModel().schedule(snapshot())`` hands its kernel
    binding, as ``kernel_solve_batch``'s arguments: ``(args, kwargs)``."""
    calls = []
    binding = placement._jit_solve

    def record(state, pods, params, config, quota, gang, numa, resv,
               extras):
        calls.append(((state, pods, params, quota, gang, config.wsum), dict(
            numa_aux=numa, resv=resv, most_allocated=config.most_allocated,
            resv_score_checked=True, extras=extras,
            extras_score_checked=True)))
        return binding(state, pods, params, config, quota, gang, numa, resv,
                       extras)

    placement._jit_solve = record
    try:
        PlacementModel().schedule(snapshot())
    finally:
        placement._jit_solve = binding
    assert len(calls) == 1, len(calls)
    return calls[0]


def trimmed(out, n):
    """Kernel outputs with the node axis cut to the first ``n`` rows."""
    return out._replace(**{f: getattr(out, f)[:n]
                           for f in ("used", "est", "prod", "nfree")
                           if getattr(out, f) is not None})


def cluster_path(label, name, solve_one, sharded_solver, card) -> dict:
    """Phase 7 at one input: ``solve_one()`` is the routed solve,
    ``sharded_solver(k)`` the solve through ``shard_kernel_solver(k)``.
    For each k in SHARDS, the sharded solve is driven with the launch
    counts zeroed, held against the routed solve on every output and its
    kernel against the routed kernel on every kernel output, and both
    kernels are timed (5 launches after a warm-up, CUDA events, in
    turns). At the fastest k the cluster kernel is held against its
    plain twin on the solve's first TWIN_CUT_PODS pods. Returns the
    ``kernels`` entry."""
    want, _, _, captured = drive(solve_one)
    single_in, single_route = captured[0]
    single = bk.binpack(single_in)
    n = single_in.alloc.shape[0]
    p = single_in.req.shape[0]
    bound_ms, bound_by = bound(single_in)
    runs = {}
    for k in SHARDS:
        got, launches, wall, captured = drive(
            lambda: sharded_solver(k), "binpack_sharded")
        inp, route = routed(f"{label}, k={k}", launches, captured)
        same_solve(got, want)
        err = max_abs_err(trimmed(bk.binpack_sharded(inp, k), n), single)
        one_ms = cuda_ms(lambda: bk.binpack(single_in), 5)
        ms = cuda_ms(lambda: bk.binpack_sharded(inp, k), 5)
        one_ms = (one_ms + cuda_ms(lambda: bk.binpack(single_in), 5)) / 2
        runs[k] = dict(launches=launches[route.kind], max_abs_err=err, ms=ms,
                       inp=inp, route=route)
        print(f"{label}, {k} CTAs, {route.kind} ({route.n_loc} rows per CTA) "
              f"[{card}]: shard_kernel_solver == routed solve (every "
              f"output), kernel == routed kernel (max_abs_err {err}); "
              f"{ms:.3f} ms ({ms / p * 1e3:.3f} us/pod), routed "
              f"{route_name(single_route)} kernel {one_ms:.3f} ms "
              f"({one_ms / p * 1e3:.3f} us/pod), bound {bound_ms:.5f} ms "
              f"({bound_by}); solve wall {wall:.4f} s; launches "
              f"{launches[route.kind]}", flush=True)
    k = min(runs, key=lambda x: runs[x]["ms"])
    best = runs[k]
    twin_stats = compare_cut(best["inp"], f"{label}, {k} CTAs", card,
                         reps=5, shards=k)
    return dict(name=f"{name}_{route_name(best['route'])}",
                replaces=f"{REPLACES}:317", launches=best["launches"],
                max_abs_err=max(best["max_abs_err"],
                                twin_stats["max_abs_err"]),
                ms=best["ms"], plain_ms=twin_stats["plain_ms"],
                bound_ms=bound_ms, bound_by=bound_by, source=CLUSTER_SOURCE)


def solve_entry(label, solve, card, kind, replaces_line, reps=3,
                name="binpack", quota_shared=True) -> dict:
    """Drive ``solve()`` (a ``kernel_solve_batch`` call) with the launch
    counts zeroed, assert its route is ``kind`` (its quota tables in
    shared memory or not, as ``quota_shared``), then hold and time the
    routed kernel against its twin on the captured inputs. Returns the
    ``kernels`` entry."""
    _, launches, _, captured = drive(solve)
    inp, route = routed(label, launches, captured, kind)
    assert route.quota_shared == quota_shared, f"{label}: route {route}"
    stats = compare(inp, label, card, reps=reps)
    return entry(name, launches[route.kind], stats, replaces_line)


def fed_scheduler(snap, device=None) -> Scheduler:
    """A Scheduler on ``PlacementModel(device=device)`` fed ``snap``."""
    sched = Scheduler(model=PlacementModel(device=device),
                      enable_preemption=False)
    testing.feed_scheduler(sched, snap)
    return sched


def same_round(got, want, label) -> None:
    """Two schedulers' rounds: equal placements and waiting pods."""
    assert dict(got) == dict(want), f"{label}: cuda != cpu placements"
    assert got.waiting == want.waiting, f"{label}: cuda != cpu waiting"


def scheduler_burst(snapshot, card) -> None:
    """Phase 9 (a): phase 3's world through the Scheduler's intake, two
    rounds, each on the routed kernel once and equal to the CPU run."""
    gpu, cpu = fed_scheduler(snapshot()), fed_scheduler(snapshot(), "cpu")
    for rnd, now, path in ((1, 20.0, "full"), (2, 21.0, "delta")):
        label = f"scheduler burst, round {rnd}"
        pending = len(gpu.cache.pending)
        result, launches, wall, captured = drive(
            lambda: gpu.schedule_pending(now=now))
        _, route = routed(label, launches, captured, "cluster")
        assert gpu.model.last_staging == path, gpu.model.last_staging
        same_round(result, cpu.schedule_pending(now=now), label)
        assert cpu.model.last_staging == path
        committed = sum(n is not None for n in result.values())
        assert committed > 0 or rnd == 2
        tm = gpu.model.last_timings
        print(f"{label} [{card}]: {len(gpu.cache.nodes)} nodes, {pending} "
              f"pending: {committed} committed, {len(result.waiting)} "
              f"waiting; {path} staging; lower_s {tm['lower_s']:.4f} "
              f"stage_s {tm['stage_s']:.4f} solve_s {tm['solve_s']:.4f} "
              f"wall {wall:.4f} s; cuda == cpu; route {route_name(route)}; "
              f"launches {launches[route.kind]}", flush=True)


def churn_ticks(card):
    """Phase 9 (b): bench config #9 through three Schedulers fed the same
    events. Returns ``(launches of the delta run, the last delta tick's
    kernel inputs)``."""
    snap, _ = testing.churn_world(CHURN_NODES, assigned_per_node=2, seed=42)
    delta, full = fed_scheduler(snap), fed_scheduler(snap)
    cpu = fed_scheduler(snap, "cpu")
    rng = np.random.default_rng(7)
    times = {"delta": [], "full": []}
    node_lower = {"delta": [], "full": []}   # the cache's own lower_s
    dirty_rows = []                          # rows a delta tick rewrote
    for name, sched in (("delta", delta), ("full", full)):
        ensure = sched.model.staged_cache.ensure

        def timed(snapshot, want_device=True, ensure=ensure, name=name):
            out = ensure(snapshot, want_device)
            node_lower[name].append(out[2]["lower_s"])
            if name == "delta" and out[3][1].idx is not None:
                dirty_rows.append(out[3][1].idx.size)
            return out

        sched.model.staged_cache.ensure = timed
    launches_delta, last_inp = 0, None
    for t in range(CHURN_TICKS):
        now = 20.0 + t
        testing.feed_churn_tick((delta, full, cpu), snap, rng,
                                dirty=CHURN_DIRTY, pending=CHURN_PENDING,
                                t=t, now=now)
        results = {}
        for name, sched in (("delta", delta), ("full", full)):
            if name == "full":
                sched.model.reset_staging()
            result, launches, wall, captured = drive(
                lambda: sched.schedule_pending(now=now))
            inp, route = routed(f"churn tick {t}, {name}", launches,
                                captured, "cluster")
            want_path = "full" if name == "full" or t == 0 else "delta"
            assert sched.model.last_staging == want_path, (
                name, t, sched.model.last_staging)
            results[name] = result
            if name == "delta":
                launches_delta += launches[route.kind]
                last_inp = inp
            if t >= WARM_TICKS:
                times[name].append((wall, dict(sched.model.last_timings)))
        want = cpu.schedule_pending(now=now)
        for name, result in results.items():
            same_round(result, want, f"churn tick {t}, {name}")
    now = 20.0 + CHURN_TICKS
    for name, sched in (("delta", delta), ("cpu", cpu)):
        snapshot = sched.cache.snapshot(now=now)
        sched.model.prestage(snapshot)
        assert sched.model.staged_cache.last_path == "delta", name
        fresh = sched.model.stage_nodes(
            lower_nodes(snapshot, **sched.model.lowering_kwargs()))
        for f in STAGED_NODE_FIELDS:
            assert torch.equal(getattr(sched.model.staged_cache.state, f),
                               getattr(fresh, f)), f"{name} cache: {f}"
    medians = {}
    for name, rows in times.items():
        medians[name] = {"wall": float(np.median([w for w, _ in rows]))}
        for k in ("lower_s", "stage_s", "solve_s"):
            medians[name][k] = float(np.median([tm[k] for _, tm in rows]))
        m = medians[name]
        nodes_s = float(np.median(node_lower[name][WARM_TICKS:CHURN_TICKS]))
        print(f"churn ticks, {name} staging [{card}]: {CHURN_NODES} nodes, "
              f"{CHURN_DIRTY} metrics + {CHURN_PENDING} pending per tick, "
              f"median of ticks {WARM_TICKS}-{CHURN_TICKS - 1}: tick wall "
              f"{m['wall']:.4f} s, lower_s {m['lower_s']:.4f} (node rows "
              f"{nodes_s:.4f}) stage_s {m['stage_s']:.4f} solve_s "
              f"{m['solve_s']:.4f}", flush=True)
    print(f"churn ticks [{card}]: every tick equal across delta, full and "
          f"cpu; ticks 1-{CHURN_TICKS - 1} delta (median {np.median(dirty_rows):.0f} "
          f"node rows re-lowered); cache == fresh staging; "
          f"tick wall full / delta = "
          f"{medians['full']['wall'] / medians['delta']['wall']:.2f}",
          flush=True)
    return launches_delta, last_inp


def extras_loop_check(card) -> dict:
    """Beside phase 6's loop check: one extras solve, config #8 cut to
    LOOP_NODES x LOOP_PODS with EXTRAS_SELECTOR of the pods on shared
    selector rows and EXTRAS_SCORED on their own scored rows, on the
    kernel and on the loop ``solve_batch`` (which expands the rows); the
    results must be equal on every output. Returns the ``kernels`` entry
    of the kernel's extras instance at this shape."""
    s_, p_, pr, q, g, rv, aux = testing.full_features_problem(
        LOOP_NODES, LOOP_PODS, seed=8)
    row, mask, score = testing.extras_arrays(
        LOOP_NODES, LOOP_PODS, selector_frac=EXTRAS_SELECTOR,
        scored_frac=EXTRAS_SCORED, seed=13)
    extras = ExtrasRows(*(torch.as_tensor(a, device=s_.alloc.device)
                          for a in (row, mask, score)))
    got = []
    _, launches, _, captured = drive(lambda: got.append(
        bk.kernel_solve_batch(s_, p_, pr, q, g, numa_aux=aux, resv=rv,
                              extras=extras)))
    inp, route = routed("extras solve", launches, captured)
    ms = cuda_ms(lambda: bk.kernel_solve_batch(
        s_, p_, pr, q, g, numa_aux=aux, resv=rv, extras=extras), 3)
    want = []
    loop_ms = cuda_ms(lambda: want.append(solve_batch(
        s_, p_, pr, SolverConfig(), q, g, extras, resv=rv, numa=aux)), 1)
    same_solve(got[0], want[0])
    n_rows = int((extras.row_of_pod >= 0).sum())
    print(f"extras solve == loop solve_batch, config #8 cut to {LOOP_NODES} "
          f"nodes x {LOOP_PODS} pods, {n_rows} pods with a row "
          f"({mask.shape[0]} distinct rows) [{card}]: "
          f"{int(got[0].commit.sum())} committed, placements equal; kernel "
          f"solve {ms:.3f} ms, loop {loop_ms:.3f} ms", flush=True)
    stats = compare(inp, f"extras, config #8 cut to {LOOP_NODES} x "
                    f"{LOOP_PODS}", card, reps=3)
    return entry("binpack_extras", launches[route.kind], stats, 259)


def fine_world(n_nodes, n_pending, node_policy=""):
    """Phase 3's world at ``n_nodes`` x ``n_pending`` with the phase's
    fine-grained shares (:func:`testing.add_fine_grained`): ``(snapshot,
    topologies, devices)``."""
    f = n_pending / PENDING
    snap, _ = testing.churn_world(n_nodes, assigned_per_node=ASSIGNED_PER_NODE,
                                  seed=42)
    testing.add_pending_wave(
        snap, n_pending, n_quota=max(1, round(QUOTAS * f)),
        n_gangs=max(1, round(GANGS * f)),
        gang_size=GANG_SIZE if n_pending >= 2000 else 4, seed=7)
    topo, dev = testing.add_fine_grained(
        snap, n_cpuset=round(FINE_CPUSET * f), n_gpu=round(FINE_GPU * f),
        n_ports=round(FINE_PORTS * f), n_selector=round(FINE_SELECTOR * f),
        n_distinct_ports=max(2, round(FINE_DISTINCT * f)),
        node_policy=node_policy)
    return snap, topo, dev


class FineProbe:
    """A Scheduler on ``PlacementModel(device=device)`` fed a fine
    world, with its model's ``FineGrained.rows`` timed (host seconds and
    calls) and the solver of every solve recorded."""

    def __init__(self, world, device=None):
        import copy

        snap, topo, dev = world
        self.sched = fed_scheduler(copy.deepcopy(snap), device)
        testing.feed_fine_grained(self.sched, topo, dev)
        model = self.sched.model
        self.rows_s, self.rows_calls, self.solvers = 0.0, 0, []
        rows, dispatch = model.fine.rows, model._dispatch_solve

        def timed_rows(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return rows(*args, **kwargs)
            finally:
                self.rows_s += time.perf_counter() - t0
                self.rows_calls += 1

        def recorded(*args, **kwargs):
            out = dispatch(*args, **kwargs)
            self.solvers.append(model.last_solver)
            return out

        model.fine.rows = timed_rows
        model._dispatch_solve = recorded

    def round(self, now):
        """One round, driven with the launch counts zeroed: ``(result,
        launches, wall, captured)``; the probe's counters restart."""
        self.rows_s, self.rows_calls, self.solvers = 0.0, 0, []
        return drive(lambda: self.sched.schedule_pending(now=now))

    def state(self):
        """Placements, annotations, NUMA and device holds, plain data."""
        return fine_state(self.sched)


def fine_round_line(label, probe, result, launches, wall, card, ms) -> str:
    """The printed line of one phase-10 round."""
    tm = probe.sched.model.last_timings
    committed = sum(n is not None for n in result.values())
    kinds = {k: v for k, v in launches.items() if v}
    return (f"{label} [{card}]: {len(probe.sched.cache.nodes)} nodes: "
            f"{committed} committed, {len(result.waiting)} waiting "
            f"({len(probe.sched._fine_waiting)} with fine-grained holds); "
            f"wall {wall:.4f} s, lower_s {tm['lower_s']:.4f} stage_s "
            f"{tm['stage_s']:.4f} solve_s {tm['solve_s']:.4f}; refine "
            f"iterations {len(probe.solvers) - 1}, solvers {probe.solvers}; "
            f"FineGrained.rows {probe.rows_s:.4f} s host over "
            f"{probe.rows_calls} calls; launches {kinds}, kernel "
            f"{ms:.3f} ms per launch (the final solve's inputs)")


def fine_rounds(label, probe, card, rounds=2, reference=None):
    """``rounds`` rounds of ``probe``: every solve kernel-routed and
    launched once, the final solve's launch == its twin bit for bit and
    timed; with ``reference`` (a CPU probe) every round equal to it.
    Returns the first round's ``compare`` stats (the whole burst) and the
    launches of all rounds."""
    first, total = None, 0
    for r in range(rounds):
        now = 20.0 + r
        result, launches, wall, captured = probe.round(now)
        assert probe.solvers and set(probe.solvers) == {"kernel"}, (
            label, probe.solvers)
        assert len(captured) == len(probe.solvers) == sum(
            launches.values()), (label, len(captured), launches)
        if reference is not None:
            want, _, _, _ = reference.round(now)
            assert set(reference.solvers) == {"kernel"}, reference.solvers
            same_round(result, want, f"{label}, round {r + 1}")
            assert probe.state() == reference.state(), (
                f"{label}, round {r + 1}: cuda != cpu fine-grained state")
        inp, _ = captured[-1]
        stats = compare(inp, f"{label}, round {r + 1}, final solve", card,
                        reps=3)
        first = first or stats
        total += sum(launches.values())
        print(fine_round_line(f"{label}, round {r + 1}", probe, result,
                              launches, wall, card, stats["ms"])
              + ("; cuda == cpu (placements, annotations, NUMA and device "
                 "holds)" if reference is not None else ""), flush=True)
    return first, total


def fine_grained_burst(card) -> list:
    """Phase 10. Returns its ``kernels`` entries."""
    probe = FineProbe(fine_world(NODES, PENDING))
    stats, launches = fine_rounds("fine-grained burst", probe, card)
    _, numa, devices, _ = probe.state()
    held = sum(len(v) for v in numa.values())
    gpus = sum(len(v) for v in devices.values())
    assert held > 0 and gpus > 0, (held, gpus)
    print(f"fine-grained burst: {held} pods hold NUMA resources or a "
          f"cpuset, {gpus} hold GPUs", flush=True)
    kernels = [entry("binpack_extras", launches, stats, 259)]
    world = fine_world(FINE_CUT_NODES, FINE_CUT_PENDING)
    stats, launches = fine_rounds(
        "fine-grained burst cut", FineProbe(world), card,
        reference=FineProbe(world, "cpu"))
    kernels.append(entry("binpack_extras_cut", launches, stats, 259))
    world = fine_world(SNN_NODES, SNN_PENDING, node_policy="SingleNUMANode")
    stats, launches = fine_rounds(
        "SingleNUMANode nodes", FineProbe(world), card, rounds=1,
        reference=FineProbe(world, "cpu"))
    kernels.append(entry("binpack_extras_single_numa", launches, stats, 259))
    return kernels


def storm_scheduler(device=None, backend="device") -> Scheduler:
    """``Scheduler()`` with the reference's preemption defaults (or
    ``backend``) on ``PlacementModel(device=device)``, fed config #19's
    storm: nodes, residents, then the arrivals."""
    nodes, residents, arrivals = testing.preemption_storm(
        seed=STORM_SEED, n_nodes=STORM_NODES, residents_per_node=STORM_RPN,
        n_arrivals=STORM_ARRIVALS)
    sched = Scheduler(model=PlacementModel(device=device),
                      preemption_backend=backend)
    for node in nodes:
        sched.add_node(node)
    for pod in residents + arrivals:
        sched.add_pod(pod)
    return sched


class PreemptProbe:
    """Times a Scheduler's ``_preempt_unplaced`` (host seconds, a device
    synchronise included) and counts the preemptors it tried (its
    ``select_victims_device`` calls)."""

    def __init__(self, sched):
        self.seconds, self.tried = 0.0, 0
        preempt = sched._preempt_unplaced
        select = sched.model.select_victims_device

        def timed(*args):
            t0 = time.perf_counter()
            preempt(*args)
            if sched.model.device.type == "cuda":
                torch.cuda.synchronize()
            self.seconds = time.perf_counter() - t0

        def counted(*args, **kwargs):
            self.tried += 1
            return select(*args, **kwargs)

        sched._preempt_unplaced = timed
        sched.model.select_victims_device = counted


def frozen(inp):
    """A copy of kernel inputs ``inp`` that later rounds cannot change
    (the staging cache rewrites the staged node tensors in place)."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if type(x) is tuple:
            return tuple(copy(y) for y in x)
        return x
    return inp._replace(**{f: copy(getattr(inp, f)) for f in inp._fields})


def storm_rounds(card) -> list:
    """Phase 11 (a). Returns the ``kernels`` entries of the storm rounds'
    placement kernel: held against its twin and timed on round 0's
    inputs (every arrival pending) and on the last round's."""
    gpu, cpu = storm_scheduler(), storm_scheduler("cpu")
    probe = PreemptProbe(gpu)
    launches, rounds, first, inp = {}, 0, None, None
    t_storm = time.perf_counter()
    for r in range(STORM_MAX_ROUNDS):
        now = 100.0 + r
        label = f"preemption storm, round {r}"
        pending = len(gpu.cache.pending)
        before = set(gpu.cache.pods)
        probe.tried = 0
        result, launched, wall, captured = drive(
            lambda: gpu.schedule_pending(now=now))
        inp, route = routed(label, launched, captured)
        launches[route.kind] = launches.get(route.kind, 0) + 1
        if first is None:
            first = frozen(inp)
        want = cpu.schedule_pending(now=now)
        same_round(result, want, label)
        assert result.nominations == want.nominations, label
        evicted = before - set(gpu.cache.pods)
        assert evicted == before - set(cpu.cache.pods), label
        placed = [u for u, n in result.items() if n is not None]
        tm = gpu.model.last_timings
        print(f"{label} [{card}]: {pending} pending; wall {wall:.4f} s, "
              f"lower_s {tm['lower_s']:.4f} stage_s {tm['stage_s']:.4f} "
              f"solve_s {tm['solve_s']:.4f}, preemption {probe.seconds:.4f}"
              f" s; {probe.tried} preemptors tried, {len(evicted)} "
              f"evictions, {len(result.nominations)} nominations, "
              f"{len(placed)} placements; cuda == cpu; route "
              f"{route_name(route)}; launches {launched[route.kind]}",
              flush=True)
        for uid in placed:
            gpu.cache.finish_binding(uid)
            cpu.cache.finish_binding(uid)
        rounds += 1
        if not gpu.cache.pending:
            break
    storm_s = time.perf_counter() - t_storm
    assert not gpu.cache.pending, f"storm not drained in {rounds} rounds"
    assert ({u: p.node_name for u, p in gpu.cache.pods.items()}
            == {u: p.node_name for u, p in cpu.cache.pods.items()})
    assert list(gpu.cache.pending) == list(cpu.cache.pending)
    print(f"preemption storm [{card}]: {STORM_ARRIVALS} arrivals placed in "
          f"{rounds} rounds; final cache == cpu; kernel launches {launches}; "
          f"phase wall {storm_s:.2f} s (cpu rounds included)", flush=True)
    entries = []
    for which, name, x in (("round 0", "binpack_preempt_storm", first),
                           ("last round", "binpack_preempt_storm_last_round",
                            inp)):
        stats = compare(x, f"preemption storm, {which} ({STORM_NODES} "
                        f"nodes)", card, reps=5)
        kind = stats["route"].kind
        entries.append(entry(name, launches[kind], stats,
                             93 if kind == "block" else 317))
    return entries


def storm_world(n_nodes, n_arrivals):
    """Config #19's storm at ``n_nodes``: ``(snapshot, arrivals)``."""
    nodes, residents, arrivals = testing.preemption_storm(
        seed=STORM_SEED, n_nodes=n_nodes, residents_per_node=STORM_RPN,
        n_arrivals=n_arrivals)
    return ClusterSnapshot(nodes=nodes, pods=residents, now=50.0), arrivals


def sweep_device(n_nodes, model, pods):
    """The device arm of phase 11 (b) on a fresh world: ``(answers,
    seconds)``, timed after one warm-up selection."""
    kw = model.lowering_kwargs()
    snapshot, _ = storm_world(n_nodes, 0)
    arrays = lower_nodes(snapshot, **kw)
    resident = model.lower_residents(snapshot, arrays)
    world = model.resident_world(resident)
    model.select_victims_device(arrays, resident, pods[0], world=world)
    torch.cuda.synchronize()
    hits = []
    t0 = time.perf_counter()
    for pod in pods:
        got = model.select_victims_device(arrays, resident, pod, world=world)
        if got is not None:
            evict_resident_rows(snapshot, arrays, resident, *got, **kw)
        hits.append(got)
    return hits, time.perf_counter() - t0


def sweep_host(n_nodes, model, pods):
    """The host arm of phase 11 (b) on a fresh world: ``(answers,
    seconds)``."""
    kw = model.lowering_kwargs()
    snapshot, _ = storm_world(n_nodes, 0)
    arrays = lower_nodes(snapshot, **kw)
    thresholds = (model.params.thresholds.cpu().numpy(),
                  model.params.prod_thresholds.cpu().numpy())
    hits = []
    t0 = time.perf_counter()
    for pod in pods:
        got = find_preemption(snapshot, pod, arrays=arrays,
                              thresholds=thresholds[0],
                              prod_thresholds=thresholds[1])
        if got is not None:
            gone = {v.uid for v in got[1]}
            snapshot.pods = [p for p in snapshot.pods if p.uid not in gone]
            arrays = lower_nodes(snapshot, **kw)
            got = (got[0], [v.uid for v in got[1]])
        hits.append(got)
    return hits, time.perf_counter() - t0


def spread(values, fmt="{:.1f}") -> str:
    """``median (min-max)`` of ``values``."""
    values = sorted(values)
    return (fmt.format(statistics.median(values)) + " ("
            + fmt.format(values[0]) + "-" + fmt.format(values[-1]) + ")")


def victim_sweep(n_nodes, card) -> None:
    """Phase 11 (b): the first SWEEP_PODS arrivals, evicting as they go,
    on the card (``select_victims_device`` + ``evict_resident_rows``)
    and on the host (``find_preemption`` + a full re-lower per hit),
    SWEEP_REPEATS times each, the arms in turns, each on a fresh world."""
    model = PlacementModel()
    _, pods = storm_world(n_nodes, SWEEP_PODS)
    device_rate, host_rate, ratio = [], [], []
    for rep in range(SWEEP_REPEATS):
        device_hits, device_s = sweep_device(n_nodes, model, pods)
        host_hits, host_s = sweep_host(n_nodes, model, pods)
        assert device_hits == host_hits, f"device sweep != host walk ({rep})"
        hits = sum(h is not None for h in device_hits)
        assert hits == len(pods), hits
        device_rate.append(len(pods) / device_s)
        host_rate.append(len(pods) / host_s)
        ratio.append(host_s / device_s)
    evictions = sum(len(h[1]) for h in device_hits)
    print(f"victim sweep, {n_nodes} nodes x {STORM_RPN} residents, "
          f"{len(pods)} preemptors, {SWEEP_REPEATS} repeats [{card}]: "
          f"device == host walk every repeat ({hits} hits, {evictions} "
          f"evictions); median (min-max): device {spread(device_rate)} "
          f"pods/s, host {spread(host_rate)} pods/s, device / host "
          f"{spread(ratio, '{:.2f}')}; per repeat device "
          f"{[round(x, 1) for x in device_rate]}, host "
          f"{[round(x, 2) for x in host_rate]}", flush=True)


def scan_wave(card) -> None:
    """Phase 11 (c): ``preempt_scan_device`` over the whole wave in one
    call on the card (timed after a warm-up call), equal to the CPU
    model's."""
    snapshot, pods = storm_world(STORM_NODES, STORM_ARRIVALS)
    out = {}
    for device in ("cuda", "cpu"):
        model = PlacementModel(device=device)
        arrays = lower_nodes(snapshot, **model.lowering_kwargs())
        resident = model.lower_residents(snapshot, arrays)
        world = model.resident_world(resident)
        model.preempt_scan_device(arrays, resident, pods[:4], world=world)
        t0 = time.perf_counter()
        out[device] = model.preempt_scan_device(arrays, resident, pods,
                                                world=world)
        out[device + "_s"] = time.perf_counter() - t0
    assert out["cuda"] == out["cpu"], "preempt_scan_device: cuda != cpu"
    hits = sum(h is not None for h in out["cuda"])
    print(f"preempt_scan_device, {STORM_NODES} nodes x {STORM_RPN} "
          f"residents, {len(pods)} preemptors in one call [{card}]: cuda == "
          f"cpu ({hits} hits); wall {out['cuda_s']:.4f} s "
          f"({len(pods) / out['cuda_s']:.1f} pods/s), cpu "
          f"{out['cpu_s']:.4f} s", flush=True)


def defrag_check(card) -> None:
    """Phase 11 (d): ``defrag_headroom`` on the storm world with the
    "verify" backend (device plan == host plan, else it raises)."""
    sched = storm_scheduler(backend="verify")
    arrival = next(iter(sched.cache.pending.values()))
    target = resources_to_vector(arrival.requests)
    t0 = time.perf_counter()
    plan = sched.defrag_headroom(target, DEFRAG_MAX_PRIORITY, now=50.0)
    wall = time.perf_counter() - t0
    assert plan is not None and plan[1], plan
    print(f"defrag_headroom, verify backend [{card}]: device plan == host "
          f"plan: drain {len(plan[1])} pods on {plan[0]} for a hole of "
          f"{target[:2].tolist()}; wall {wall:.4f} s (both plans)",
          flush=True)


class RecordingSink(Evictor):
    """Approves every eviction and mutates nothing, so every pass sees
    the same world (the reference's bench sink); with ``arbiter`` each
    eviction asks the arbiter first."""

    def _do_evict(self, snapshot, pod, reason):
        return True


def rebalance_pool(low, high) -> NodePool:
    cpu, mem = ResourceName.CPU, ResourceName.MEMORY
    return NodePool(low_thresholds={cpu: low[0], mem: low[1]},
                    high_thresholds={cpu: high[0], mem: high[1]})


def rebalance_snapshot(spec):
    return testing.build_snapshot(spec, ttypes, ResourceName)


def zero_launches() -> None:
    rb.LAUNCHES.update({name: 0 for name in rb.LAUNCHES})
    for kind in bk.LAUNCHES:
        bk.LAUNCHES[kind] = 0


def balance_pass(snapshot, pool, backend, arbiter=None):
    """One ``LowNodeLoad.balance`` on ``backend`` ("device": the sweep
    kernel on the card), every launch count zeroed just before and read
    just after (a device synchronise ends the timed span); a device pass
    must take the scan route only. Returns ``(ordered evictions, wall_s,
    scan kernel launches, the DeviceSweeps the pass staged, the sink)``."""
    made = []
    base = loadaware.DeviceSweep

    class Recorded(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    loadaware.DeviceSweep = Recorded
    try:
        plugin = LowNodeLoad(LowNodeLoadArgs(node_pools=[pool],
                                             backend=backend))
        sink = RecordingSink(arbiter=arbiter)
        zero_launches()
        t0 = time.perf_counter()
        plugin.balance(snapshot, sink)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(rb.LAUNCHES)
    finally:
        loadaware.DeviceSweep = base
    assert not any(bk.LAUNCHES.values()), bk.LAUNCHES
    assert launches["rebalance_sweep"] == 0, launches
    if backend == "host":
        assert not any(launches.values()) and not made, (launches, len(made))
    else:
        assert launches["rebalance_scan"] >= 1 and len(made) == 1, (
            launches, len(made))
        assert made[0].route == "scan", made[0].route
    return ([(p.node_name, p.uid) for p in sink.evicted], wall,
            launches["rebalance_scan"], made, sink)


def sweep_bound(sweep):
    """(bound_ms, bound_by) of one sweep over ``sweep``'s batch: every
    input (the batch, the blocked mask, the headroom and the resource
    mask) read once and every output (three bytes per candidate, the
    final headroom) written once at the memory rate, against
    SWEEP_OPS_PER_CANDIDATE at the scalar rate."""
    k = sweep.k
    nbytes = sum(t.numel() * t.element_size() for t in sweep.batch)
    nbytes += k + 4 * 8 + 8           # blocked, available, res_mask
    nbytes += 3 * k + 4 * 8           # the streams, the final available
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = k * SWEEP_OPS_PER_CANDIDATE / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_entry(name, sweep, launches, label, card, reps=5,
                route="scan") -> dict:
    """Both sweep kernels on a pass's staged batch (nothing blocked) held
    against the plain version on the card (tolerance: exact, the three
    streams and the final headroom) and timed in turns (route, other,
    other, route; ``reps`` launches each after the comparison's launch as
    warm-up), the plain version over its one comparison run. Returns the
    ``kernels`` line entry of ``route``'s kernel (``route`` must be the
    batch's own)."""
    assert sweep.route == route, (sweep.route, route)
    blocked = torch.zeros(sweep.k, dtype=torch.bool, device=sweep.device)
    args = (sweep.batch, blocked, sweep.available, sweep.res_mask)
    want = []
    plain_ms = cuda_ms(lambda: want.append(rb._balance_sweep(
        *sweep.batch, *args[1:])), 1)
    streams, avail = want[0]
    other = "serial" if route == "scan" else "scan"
    routes = (route, other) if route == "scan" else (route,)
    err = 0
    for r in routes:
        got = rb._launch(*args, r)
        torch.cuda.synchronize()
        for g, w, what in ((got[0][0], streams[0], "propose"),
                           (got[0][1], streams[1], "over"),
                           (got[0][2], streams[2], "avail_ok"),
                           (got[1], avail, "available")):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"sweep kernel ({r}) != plain version on {what}")
            if g.numel() and r == route:
                err = max(err, int((g.long() - w.long()).abs().max()))
    times = {r: [] for r in routes}
    for r in routes + routes[::-1]:
        times[r].append(device_ms(
            lambda: rb._launch(*args, r), reps))
    ms = min(times[route])
    bound_ms, bound_by = sweep_bound(sweep)
    proposed = int(streams[0].sum())
    beside = "".join(f", the {r} kernel {min(t):.4f} ms" for r, t in
                     times.items() if r != route)
    print(f"{label}: {route} kernel == plain version ({proposed}/{sweep.k} "
          f"proposed, max_abs_err {err}) [{card}]: kernel {ms:.4f} ms "
          f"({ms / max(sweep.k, 1) * 1e6:.1f} ns per candidate; in turns "
          f"{', '.join(f'{t:.4f}' for t in times[route])}){beside}, plain "
          f"version on the card {plain_ms:.3f} ms, bound {bound_ms:.6f} ms "
          f"({bound_by}); launches on the path {launches}", flush=True)
    return dict(name=name, source=SWEEP_SOURCE, replaces=SWEEP_REPLACES,
                launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def rebalance_config5(card) -> dict:
    """Phase 12 (a): bench config #5 at full size through ``LowNodeLoad``
    on every backend, equal to the port's oracle; balance() walls in
    turns; the sweep kernel on the pass's batch."""
    t0 = time.perf_counter()
    snap = rebalance_snapshot(testing.rebalance_world_spec(
        REBAL_NODES, REBAL_PODS, seed=REBAL_SEED))
    build_s = time.perf_counter() - t0
    pool = rebalance_pool(REBAL_LOW, REBAL_HIGH)
    seq, wall, launches, sweeps, _ = balance_pass(snap, pool, "device")
    t0 = time.perf_counter()
    want = RebalanceOracle(LowNodeLoadArgs(node_pools=[pool])).sweep(snap)
    oracle_s = time.perf_counter() - t0
    walls = {"host": [], "device": [], "verify": []}
    for rep in range(BALANCE_REPEATS):
        for backend in walls:
            got, w, *_ = balance_pass(snap, pool, backend)
            assert got == want, f"config #5 {backend} != oracle ({rep})"
            walls[backend].append(w)
    assert seq == want and want, "config #5: device != oracle"
    drained = len({n for n, _ in want})
    print(f"rebalance config #5, {REBAL_NODES} nodes x {REBAL_PODS} pods "
          f"[{card}]: host == device == verify == oracle: {len(want)} "
          f"evictions, {drained} nodes drained, {sweeps[0].k} candidates; "
          f"world built in {build_s:.2f} s, oracle {oracle_s:.2f} s; "
          f"balance() median (min-max) of {BALANCE_REPEATS}, in turns: "
          + ", ".join(f"{b} {spread(v, '{:.4f}')} s"
                      for b, v in walls.items())
          + f"; first device pass {wall:.4f} s, {launches} sweep launch",
          flush=True)
    return sweep_entry("rebalance_scan_config5", sweeps[0], launches,
                       "rebalance config #5's sweep", card)


def storm22_scheduler(spec, budget):
    """``Scheduler()`` on the card fed config #22's world (nodes, node
    metrics, the running pods) and one pod that fits nowhere, so every
    round solves; with the arbiter at ``budget``."""
    sched = Scheduler()
    sched.migration_arbiter = MigrationArbiter(budget)
    snap = rebalance_snapshot(spec)
    for node in snap.nodes:
        sched.add_node(node)
    for metric in snap.node_metrics.values():
        sched.update_node_metric(metric)
    for pod in snap.pods:
        sched.add_pod(pod)
    sched.add_pod(ttypes.PodSpec(name="unplaceable", requests={
        ResourceName.CPU: 10**6}))
    return sched


def rebalance_storm(card) -> dict:
    """Phase 12 (b): bench config #22 at the reference's default, device
    against host, the budgeted arm (``max_per_node=1``), then the same
    world and arbiter through ``Scheduler.rebalance_sweep`` and the next
    round's delta staging against a fresh staging."""
    spec = testing.rebalance_storm_spec(STORM22_NODES, STORM22_PPN,
                                        seed=STORM22_SEED)
    snap = rebalance_snapshot(spec)
    pool = rebalance_pool(STORM22_LOW, STORM22_HIGH)
    dev_seq, dev_wall, dev_launches, sweeps, _ = balance_pass(snap, pool,
                                                              "device")
    host_seq, host_wall, *_ = balance_pass(snap, pool, "host")
    assert dev_seq == host_seq and host_seq, "config #22: device != host"
    arbiter = MigrationArbiter(MigrationBudget(max_per_node=1))
    refuse = rb.DeviceSweep.refuse
    refused, walls = [], []

    def timed_refuse(self, j):
        t0 = time.perf_counter()
        try:
            return refuse(self, j)
        finally:
            walls.append(time.perf_counter() - t0)
            refused.append(j)

    rb.DeviceSweep.refuse = timed_refuse
    try:
        budget_seq, budget_wall, rescans, budgeted, sink = balance_pass(
            snap, pool, "device", arbiter=arbiter)
    finally:
        rb.DeviceSweep.refuse = refuse
    host_budget_seq, host_budget_wall, *_ = balance_pass(
        snap, pool, "host",
        arbiter=MigrationArbiter(MigrationBudget(max_per_node=1)))
    assert budget_seq == host_budget_seq, "budgeted arm: device != host"
    assert rescans == len(refused) + 1, (rescans, len(refused))
    kernel_ms = replay_refusals(budgeted[0], refused)
    status = arbiter.status()
    hot = {n for n, _ in host_seq}
    budget_bounded = (
        len(sink.evicted) <= len(hot)
        and all(c <= 1 for c in status["window_nodes"].values())
        and status["deferred_total"] > 0
        and set(status["deferred_by_reason"]) <= {"node-budget", "cooldown"})
    assert budget_bounded, status
    print(f"rebalance config #22, {STORM22_NODES} nodes x {STORM22_PPN} pods "
          f"per hot node [{card}]: device == host: {len(host_seq)} evictions "
          f"({sweeps[0].k} candidates); balance() device {dev_wall:.4f} s "
          f"({dev_launches} launch), host {host_wall:.4f} s; budgeted arm "
          f"(max_per_node=1): {len(sink.evicted)} evicted, "
          f"{status['deferred_total']} deferred "
          f"{status['deferred_by_reason']}, budget_bounded true, "
          f"{rescans} sweep launches (one per refusal, and the first), "
          f"== the host backend's arm ({host_budget_wall:.4f} s); wall "
          f"{budget_wall:.4f} s, {budget_wall / rescans * 1e3:.4f} ms per "
          f"launch; a re-scan (DeviceSweep.refuse: launch, suffix read-back,"
          f" splice) median {statistics.median(walls) * 1e3:.4f} ms (min "
          f"{min(walls) * 1e3:.4f}, max {max(walls) * 1e3:.4f}), the scan "
          f"kernel per re-scan {kernel_ms:.4f} ms (CUDA events, the "
          f"re-scans replayed back to back)", flush=True)
    sched = storm22_scheduler(spec, MigrationBudget(max_per_node=1))
    _, launched, _, _ = drive(lambda: sched.schedule_pending(now=110.0))
    assert sum(launched.values()) == 1, launched
    plugin = LowNodeLoad(LowNodeLoadArgs(node_pools=[pool],
                                         backend="device"))
    zero_launches()
    t0 = time.perf_counter()
    evicted = sched.rebalance_sweep(plugin, now=120.0)
    torch.cuda.synchronize()
    sweep_wall = time.perf_counter() - t0
    sched_launches = rb.LAUNCHES["rebalance_scan"]
    assert rb.LAUNCHES["rebalance_sweep"] == 0, rb.LAUNCHES
    assert sched_launches == rescans, (sched_launches, rescans)
    assert evicted == [p.uid for p in sink.evicted], "Scheduler != sink arm"
    assert not set(evicted) & set(sched.cache.pods)
    fresh = []
    dispatch = sched.model.schedule_async

    def record(snapshot):
        fresh.append(sched.model.stage_nodes(
            lower_nodes(snapshot, **sched.model.lowering_kwargs())))
        return dispatch(snapshot)

    sched.model.schedule_async = record
    sched.schedule_pending(now=121.0)
    assert sched.model.last_staging == "delta", sched.model.last_staging
    state = sched.model.staged_cache.state
    for f in STAGED_NODE_FIELDS:
        assert torch.equal(getattr(state, f), getattr(fresh[-1], f)), f
    print(f"Scheduler.rebalance_sweep with the arbiter [{card}]: "
          f"{len(evicted)} evicted == the budgeted arm's, "
          f"{sched_launches} scan kernel launches, wall {sweep_wall:.4f} s; the "
          f"next round's delta staging == a fresh staging", flush=True)
    return sweep_entry("rebalance_scan_config22_budgeted", budgeted[0],
                       rescans, "rebalance config #22's sweep", card)


def replay_refusals(sweep, refused) -> float:
    """The scan kernel's ms per re-scan of the budgeted arm: its
    refusals replayed in order on the arm's staged batch (the mask
    cleared, each launch blocking its candidate on the device), queued
    back to back in runs of REPLAY_CHUNK (CUDA events); the replay's
    final mask must equal the arm's."""
    sweep.blocked.zero_()
    streams = torch.empty((3, sweep.k), dtype=torch.bool,
                          device=sweep.device)
    total = 0.0
    for at in range(0, len(refused), REPLAY_CHUNK):
        chunk = refused[at:at + REPLAY_CHUNK]
        it = iter(chunk)
        total += device_ms(lambda: rb._launch(
            sweep.batch, sweep.blocked, sweep.available, sweep.res_mask,
            "scan", next(it), streams), len(chunk)) * len(chunk)
    want = np.zeros(sweep.k, bool)
    want[refused] = True
    assert np.array_equal(sweep.blocked.cpu().numpy(), want)
    return total / max(len(refused), 1)


def rebalance_serial(card) -> dict:
    """Phase 12 (d): a batch whose high_q varies inside its nodes goes
    through ``run_balance_sweep`` on the serial route; the serial kernel
    held against the plain version and timed; an empty launch timed."""
    arrays, available, res_mask, blocked = testing.sweep_batch_arrays(
        VARIED_SEED, VARIED_K)
    rng = np.random.default_rng(VARIED_SEED)
    arrays["high_q"] = arrays["high_q"] + rng.integers(
        -3_000, 3_000, arrays["high_q"].shape)
    batch = rb.SweepBatch(**arrays)
    assert rb.sweep_route(batch.node_start, batch.high_q) == "serial"
    zero_launches()
    got = rb.run_balance_sweep(batch, available, res_mask, blocked)
    torch.cuda.synchronize()
    launches = dict(rb.LAUNCHES)
    assert launches == {"rebalance_scan": 0, "rebalance_sweep": 1}, launches
    want = rb.replay_sweep_host(batch, available, res_mask, blocked)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    empty_ms = device_ms(lambda: rb.launch_empty("cuda"), EMPTY_REPS)
    print(f"serial route [{card}]: {VARIED_K} candidates, high_q varied "
          f"inside nodes: run_balance_sweep launched the serial kernel "
          f"once, == the host replica; an empty kernel at the scan "
          f"kernel's launch shape {empty_ms:.4f} ms per launch (CUDA "
          f"events, {EMPTY_REPS} back to back)", flush=True)
    sweep = rb.DeviceSweep(batch, available, res_mask)
    return sweep_entry("rebalance_sweep_serial_varied_high_q", sweep,
                       launches["rebalance_sweep"],
                       "the serial route's batch", card, route="serial")


def rebalance_wide(card) -> dict:
    """Phase 12 (c): config #22 widened to the main path's node count, no
    budget, device against host; the sweep kernel at that K."""
    snap = rebalance_snapshot(testing.rebalance_storm_spec(
        STORM22_WIDE_NODES, STORM22_PPN, seed=STORM22_SEED))
    pool = rebalance_pool(STORM22_LOW, STORM22_HIGH)
    dev_seq, dev_wall, launches, sweeps, _ = balance_pass(snap, pool,
                                                          "device")
    host_seq, host_wall, *_ = balance_pass(snap, pool, "host")
    assert dev_seq == host_seq and host_seq, "config #22 wide: device != host"
    print(f"rebalance config #22 widened, {STORM22_WIDE_NODES} nodes "
          f"[{card}]: device == host: {len(host_seq)} evictions "
          f"({sweeps[0].k} candidates); balance() device {dev_wall:.4f} s "
          f"({launches} launch), host {host_wall:.4f} s", flush=True)
    return sweep_entry("rebalance_scan_config22_wide", sweeps[0], launches,
                       f"config #22 at {STORM22_WIDE_NODES} nodes' sweep",
                       card)


# -- 13. serving ----------------------------------------------------------------

class Sockets:
    """Unix socket paths in a temporary directory (or, where the temporary
    directory's path is too long for a unix socket, one in the working
    directory), removed by :meth:`close`."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="ks")
        if len(self.dir) > 80:
            shutil.rmtree(self.dir)
            self.dir = tempfile.mkdtemp(prefix=".ks", dir=".")

    def path(self, tag):
        return os.path.join(self.dir, f"{tag}.sock")

    def close(self):
        shutil.rmtree(self.dir, ignore_errors=True)


def sidecar_world():
    snap, tracker = testing.churn_world(
        NODES, assigned_per_node=ASSIGNED_PER_NODE, seed=42,
        with_tracker=True)
    snap = testing.add_pending_wave(snap, PENDING, n_quota=QUOTAS,
                                    n_gangs=GANGS, gang_size=GANG_SIZE,
                                    seed=7)
    return snap, tracker


def sidecar_main_path(sockets, card) -> None:
    """Phase 13 (a): phase 3's world through ``PlacementModel(backend=
    RemoteSolver)`` and an in-process ``PlacementService`` on the card
    (the admission gate at its defaults), two rounds: the full burst, then
    a churn tick (config #9's: 50 metric refreshes, a 64-pod wave, the
    burst's binds folded in) on the delta protocol. Each round must equal
    an in-process ``PlacementModel()`` on the card fed the same world, and
    the server's solve must be one batch of the gate that launches the
    routed kernel once; its time is the gate's ``solve_seconds_total``
    over the round."""
    addr = sockets.path("main")
    service = srv.PlacementService(addr)
    service.start()
    remote = RemoteSolver(addr, timeout=SOCKET_TIMEOUT_S)
    try:
        models = (PlacementModel(backend=remote), PlacementModel())
        worlds = [sidecar_world() for _ in models]
        rngs = [np.random.default_rng(13) for _ in models]
        by_uid = [{p.uid: p for p in w[0].pending_pods} for w in worlds]
        prev = [None, None]
        walls = [0.0, 0.0]
        for rnd, label in enumerate(("full burst", "churn tick (delta)")):
            results = []
            for i, model in enumerate(models):
                snap, tracker = worlds[i]
                if rnd:
                    testing.fold_churn_binds(snap, tracker, prev[i],
                                             by_uid[i], 30.0)
                    by_uid[i] = testing.churn_tick_events(
                        snap, tracker, rngs[i], dirty=CHURN_DIRTY,
                        pending=CHURN_PENDING, t=1, now=30.0)
                if i == 0:
                    for kind in bk.LAUNCHES:
                        bk.LAUNCHES[kind] = 0
                    solved = service.status()["admission"]
                t0 = time.perf_counter()
                results.append(model.schedule(snap))
                torch.cuda.synchronize()
                walls[i] = time.perf_counter() - t0
                if i == 0:
                    launches = dict(bk.LAUNCHES)
                    stats = service.status()["admission"]
                    solve_s = (stats["solve_seconds_total"]
                               - solved["solve_seconds_total"])
                    assert stats["batches_total"] == (
                        solved["batches_total"] + 1), (solved, stats)
            prev = results
            got, want = results
            assert dict(got) == dict(want), f"{label}: sidecar != in-process"
            assert got.waiting == want.waiting, label
            assert models[0].last_solver == "remote"
            assert remote.last_request == ("establish", "delta")[rnd], (
                remote.last_request)
            assert models[1].last_staging == ("full", "delta")[rnd]
            assert launches == {"block": 0, "cluster": 1, "l2": 0,
                                "lanes": 0}, launches
            committed = sum(n is not None for n in got.values())
            print(f"sidecar main path, {label} [{card}]: "
                  f"{len(snap.nodes)} nodes, {len(snap.pending_pods)} "
                  f"pending: {committed} committed, {len(got.waiting)} "
                  f"waiting == in-process on the card; request "
                  f"{remote.last_request} {remote.last_request_bytes} B "
                  f"({len(models[1].staging_delta[1].idx if rnd else [])} "
                  f"dirty rows); wall {walls[0]:.4f} s (in-process "
                  f"{walls[1]:.4f} s), server solve {solve_s:.4f} s; "
                  f"launches {launches}", flush=True)
    finally:
        remote.close()
        service.stop()


def concurrent_clients(sockets, card) -> dict:
    """Phase 13 (b): bench config #10, ``CONC_CLIENTS`` clients sending
    one base's plain request in barrier-synced rounds, inline
    (``admission=False``) against the gate. Every response must equal a
    solo ``solve_from_request`` of the request, and each batch of the
    gate must be one launch (a coalesced batch one lane launch). Returns
    the gated arm's launch counts."""
    groups = testing.concurrent_solve_groups(CONC_NODES, CONC_PODS)
    payload = encode_request(SolveRequest(**groups))
    solo = srv.solve_from_request(SolveRequest(**groups))
    assert not solo.error and (solo.assignments >= 0).any()
    rounds = CONC_WARMUP + CONC_ROUNDS
    out = {}
    for arm, admission in (("inline", False), ("gated", True)):
        addr = sockets.path(arm)
        service = srv.PlacementService(addr, admission=admission)
        service.start()
        lats = [[] for _ in range(CONC_CLIENTS)]
        failures = []
        barrier = threading.Barrier(CONC_CLIENTS)

        def client(i):
            try:
                with PlacementClient(addr, timeout=SOCKET_TIMEOUT_S) as c:
                    for r in range(rounds):
                        barrier.wait(timeout=SOCKET_TIMEOUT_S)
                        t0 = time.perf_counter()
                        write_frame(c._stream, payload)
                        c._stream.flush()
                        resp = decode_response(read_frame(c._stream))
                        wall = time.perf_counter() - t0
                        assert resp.error == "", resp.error
                        assert np.array_equal(resp.assignments,
                                              solo.assignments)
                        if r >= CONC_WARMUP:
                            lats[i].append(wall)
            except Exception as e:  # reported below; frees the barrier
                failures.append(f"{type(e).__name__}: {e}")
                barrier.abort()

        for kind in bk.LAUNCHES:
            bk.LAUNCHES[kind] = 0
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(CONC_CLIENTS)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=SOCKET_TIMEOUT_S)
            torch.cuda.synchronize()
            launches = dict(bk.LAUNCHES)
            stats = service.status()["admission"]
        finally:
            service.stop()
        assert not any(t.is_alive() for t in threads), "a client hung"
        assert not failures, failures[0]
        flat = np.asarray([w for per in lats for w in per])
        p50, p99 = np.percentile(flat, 50), np.percentile(flat, 99)
        line = (f"config #10, {arm} [{card}]: {CONC_CLIENTS} clients x "
                f"{CONC_ROUNDS} rounds, {CONC_NODES} nodes x {CONC_PODS} "
                f"pods: p50 {p50 * 1e3:.3f} ms, p99 {p99 * 1e3:.3f} ms; "
                f"every response == solo; launches {launches}")
        if admission:
            lane_batches = stats["batches_total"] - launches["block"]
            assert lane_batches > 0, "no batch coalesced"
            assert launches["lanes"] == lane_batches, (launches, stats)
            assert stats["requests_total"] == CONC_CLIENTS * rounds
            line += (f"; coalesce ratio {stats['coalesce_ratio']:.3f}, "
                     f"{lane_batches} coalesced batches, lane launches per "
                     f"batch {launches['lanes'] / lane_batches:.3f}")
            out = launches
        else:
            assert launches["block"] == CONC_CLIENTS * rounds, launches
        print(line, flush=True)
    return out


def pool_arm(addresses, payloads):
    """Drive each tenant's round stream against its address (one address
    for every tenant: the pool; one each: solo services): warm-up rounds
    barrier-synced, timed rounds free-running. Returns ``(wall of the
    timed rounds, assignments [tenant][round])``."""
    n = len(payloads)
    stamps = []
    barrier = threading.Barrier(
        n, action=lambda: stamps.append(time.perf_counter()))
    logs = [[None] * len(p) for p in payloads]
    ends = [0.0] * n
    failures = []

    def client(i):
        try:
            with PlacementClient(addresses[i], timeout=SOCKET_TIMEOUT_S) as c:
                for r, payload in enumerate(payloads[i]):
                    if r <= POOL_WARMUP:
                        barrier.wait(timeout=SOCKET_TIMEOUT_S)
                    write_frame(c._stream, payload)
                    c._stream.flush()
                    resp = decode_response(read_frame(c._stream))
                    assert resp.error == "", resp.error
                    logs[i][r] = resp.assignments
                ends[i] = time.perf_counter()
        except Exception as e:  # reported below; frees the barrier
            failures.append(f"{type(e).__name__}: {e}")
            barrier.abort()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SOCKET_TIMEOUT_S)
    assert not any(t.is_alive() for t in threads), "a tenant hung"
    assert not failures, failures[0]
    return max(ends) - stamps[-1], logs


def tenant_pool(sockets, card) -> dict:
    """Phase 13 (c): bench config #16 cut to ``POOL_ROUNDS`` timed rounds:
    ``POOL_TENANTS`` tenants, each delta-churning its own world, through
    one shared sidecar (tenant lanes: one lane launch per batch) and
    through a sidecar each. Every tenant's placements must equal its solo
    run. Returns the pool arm's launch counts."""
    rounds = POOL_WARMUP + POOL_ROUNDS
    payloads = [[encode_request(SolveRequest(**g, admission={
        "tenant": tenancy.tenant_wire_value(f"tenant-{i}")}))
        for g in testing.tenant_stream(i, rounds, POOL_NODES, POOL_PODS)]
        for i in range(POOL_TENANTS)]
    pods = POOL_TENANTS * POOL_ROUNDS * POOL_PODS
    addr = sockets.path("pool")
    service = srv.PlacementService(addr)
    service.start()
    for kind in bk.LAUNCHES:
        bk.LAUNCHES[kind] = 0
    try:
        pool_wall, pool_logs = pool_arm([addr] * POOL_TENANTS, payloads)
        torch.cuda.synchronize()
        launches = dict(bk.LAUNCHES)
        stats = service.status()["admission"]
    finally:
        service.stop()
    assert stats["lane_batches_total"] > 0, "no tenant batch"
    assert launches["lanes"] == stats["lane_batches_total"], (launches,
                                                             stats)
    assert (launches["lanes"] + launches["block"] + launches["cluster"]
            == stats["batches_total"]), (launches, stats)
    addrs = [sockets.path(f"solo{i}") for i in range(POOL_TENANTS)]
    solos = [srv.PlacementService(a) for a in addrs]
    try:
        for s in solos:
            s.start()
        solo_wall, solo_logs = pool_arm(addrs, payloads)
    finally:
        for s in solos:
            s.stop()
    for i in range(POOL_TENANTS):
        for r in range(rounds):
            assert np.array_equal(pool_logs[i][r], solo_logs[i][r]), (i, r)
    print(f"config #16 cut to {POOL_ROUNDS} timed rounds [{card}]: "
          f"{POOL_TENANTS} tenants x {POOL_NODES} nodes, {POOL_PODS}-pod "
          f"delta ticks: pool {pods / pool_wall:.1f} pods/s (wall "
          f"{pool_wall:.4f} s; {stats['lane_batches_total']} lane batches, "
          f"{stats['lane_requests_total']} lane requests, "
          f"{launches['lanes']} lane launches, launches {launches}), "
          f"solo services {pods / solo_wall:.1f} pods/s (wall "
          f"{solo_wall:.4f} s); every tenant == its solo run", flush=True)
    return launches


def lane_bound_parts(inp):
    """(bytes, operations) of a lane batch: every input read once (a
    shared base once), every lane's outputs written once, and per lane
    the (unblocked pod, schedulable node) pairs of its base."""
    k, p = inp.req.shape[:2]
    n = inp.alloc.shape[1]
    nbytes = (sum(t.numel() * t.element_size() for t in inp)
              + 4 * k * (p + 3 * n * 8))               # assign, carries
    pods = (inp.req[..., 0] != bk.BLOCKED_REQ).sum(dim=1)     # [K]
    nodes = inp.sched.sum(dim=1)                              # [B]
    return nbytes, int((pods * nodes).sum()) * OPS_PER_PAIR


def hold_lanes(inp, label, card) -> dict:
    """One lane batch on the card: held against its plain version (exact,
    every output) and against a single launch of the routed kernel on
    each lane (exact), timed (CUDA events, queued) against those single
    launches back to back. Returns its stats."""
    k, p = inp.req.shape[:2]
    route = bk.lane_route(inp)
    singles = [bk.lane(inp, i) for i in range(k)]
    got = bk.binpack_lanes(inp)
    torch.cuda.synchronize()
    want = []
    plain_ms = cuda_ms(lambda: want.append(bk.binpack_lanes_plain(inp)), 1)
    err = max_abs_err(got, want[0])
    for i, one in enumerate(singles):
        solo = bk.binpack(one)
        for f in bk.LaneOutputs._fields:
            assert torch.equal(getattr(got, f)[i], getattr(solo, f)), (
                label, i, f)
    ms = device_ms(lambda: bk.binpack_lanes(inp), 5, LANE_SLEEP_CYCLES)
    singles_ms = device_ms(lambda: [bk.binpack(x) for x in singles], 5,
                           LANE_SLEEP_CYCLES * k)
    call_ms = cuda_ms(lambda: bk.binpack_lanes(inp), 5)
    bound_ms, bound_by = bound_of(*lane_bound_parts(inp))
    placed = int((got.assign >= 0).sum())
    print(f"lane kernel, {label} [{card}]: {route_name(route)} == plain "
          f"version and == {k} single launches ({placed}/{k * p} placed, "
          f"max_abs_err {err}); on the card, queued: lane launch "
          f"{ms:.4f} ms, {k} single launches {singles_ms:.4f} ms "
          f"({singles_ms / ms:.2f}x); a call's wall {call_ms:.4f} ms; plain "
          f"version {plain_ms:.3f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, route=route,
                singles_ms=singles_ms, call_ms=call_ms)


def lane_kernel(card) -> dict:
    """Phase 13 (d): the lane kernel alone, each batch held by
    :func:`hold_lanes`. K tenant worlds (a base per lane, as the pool
    stacks them) at each of ``LANE_SHAPES`` and ``LANE_KS``; and
    ``CONC_CLIENTS`` lanes of different pods on config #10's one base
    (stride 0, as ``solve_coalesced`` stacks them), at its pod count and
    at ``CONC_UNEQUAL_PODS``. Returns the stats by (nodes, pods, K) for
    the tenant worlds and under "coalesced" for config #10's shape."""
    dev = resolve_device()
    out = {}
    for n, p in LANE_SHAPES:
        for k in LANE_KS:
            groups = [testing.tenant_stream(i, 1, n, p)[0] for i in range(k)]
            inp = tenancy.stage_lanes(
                [tenancy.wire_state(g["node"], dev) for g in groups],
                [g["pods"] for g in groups], [g["params"] for g in groups],
                dev)
            out[(n, p, k)] = hold_lanes(
                inp, f"K = {k} tenant worlds at {n} nodes x {p} pods", card)
    base = testing.concurrent_solve_groups(CONC_NODES, CONC_PODS)
    for counts in ((CONC_PODS,) * CONC_CLIENTS, CONC_UNEQUAL_PODS):
        inp = tenancy.stage_lanes(
            [tenancy.wire_state(base["node"], dev)],
            testing.concurrent_pod_sets(counts),
            [base["params"]] * len(counts), dev)
        assert inp.alloc.shape[0] == 1, "not the one-base form"
        stats = hold_lanes(
            inp, f"K = {len(counts)} requests of {list(counts)} pods on "
            f"config #10's one base of {CONC_NODES} nodes", card)
        out.setdefault("coalesced", stats)
    return out


def lane_entry(name, launches, stats, replaces) -> dict:
    route = stats["route"]
    return dict(name=f"{name}_{route_name(route)}_plain", replaces=replaces,
                source=SOURCE if route.kind == "block" else CLUSTER_SOURCE,
                launches=launches, **{k: stats[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by")})


def solver_binary(sockets, card) -> None:
    """Phase 13 (e): ``python -m koordinator_tpu_torch.cmd.solver --once``
    starts the sidecar on the card, writes its ready file and exits 0."""
    ready = os.path.join(sockets.dir, "ready")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "koordinator_tpu_torch.cmd.solver",
         "--listen", sockets.path("binary"), "--once", "--ready-file",
         ready], capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(ready) as f:
        assert f.read().strip().isdigit()
    print(f"solver binary --once [{card}]: rc 0, ready file written, "
          f"{proc.stdout.strip()} ({time.perf_counter() - t0:.2f} s)",
          flush=True)


def serving(card) -> list:
    """Phase 13. Returns its ``kernels`` entries."""
    sockets = Sockets()
    try:
        sidecar_main_path(sockets, card)
        coalesced = concurrent_clients(sockets, card)
        pooled = tenant_pool(sockets, card)
        stats = lane_kernel(card)
        solver_binary(sockets, card)
    finally:
        sockets.close()
    return [
        lane_entry("binpack_lanes_coalesced", coalesced["lanes"],
                   stats["coalesced"], LANES_REPLACES[0]),
        lane_entry("binpack_lanes_tenants", pooled["lanes"],
                   stats[(POOL_NODES, POOL_PODS, POOL_TENANTS)],
                   LANES_REPLACES[1]),
    ]


# -- 14. the colocation loop --------------------------------------------------

def update_record(updates) -> list:
    """Every field of a reconcile's updates, package-neutral."""
    return [(u.node_name, {int(k): v for k, v in u.allocatable.items()},
             u.synced, u.degraded, dict(u.annotations), u.meta_synced)
            for u in updates]


def step_launches(args):
    """Device-side events (kernels and memsets) of one ``_overcommit_step``
    on ``args``, by the torch profiler; None where the profiler records
    none on this machine."""
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            noderesource._overcommit_step(*args)
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith("Memcpy"))
    except Exception as exc:  # the profiler is not part of the contract
        print(f"torch profiler: {exc!r}", flush=True)
        return None
    return n or None


class StepRecorder:
    """While installed (a ``with`` block), stands in for
    ``noderesource._overcommit_step``: each call's arguments and the CUDA
    events around it."""

    def __enter__(self):
        self.step, self.events, self.args = (noderesource._overcommit_step,
                                             [], [])
        noderesource._overcommit_step = self._traced
        return self

    def __exit__(self, *exc):
        noderesource._overcommit_step = self.step

    def _traced(self, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.step(*args)
        end.record()
        self.events.append((start, end))
        self.args.append(args)
        return out

    def ms(self) -> list:
        return [s.elapsed_time(e) for s, e in self.events]


def step_bytes(args) -> int:
    """Bytes the step must move: every input read once, the ``[N, R]``
    allocatable and ``[N]`` sync mask written once."""
    tensors = []
    for a in args:
        tensors += list(a) if isinstance(a, tuple) else [a]
    n, r = args[0].capacity.shape
    return (sum(t.numel() * t.element_size() for t in tensors)
            + n * r * 4 + n)


def controller_phase(spec, card) -> None:
    """Phase 14 (a): the controller on the card against the CPU, its split
    and wall, the step's launches and bound."""
    config = testing.colocation_config(spec, sloconfig)

    def reconcile(device):
        ctrl = NodeResourceController(config, device=device)
        snap = testing.colocation_snapshot(spec, ttypes)
        t0 = time.perf_counter()
        updates = ctrl.reconcile_all(snap)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return update_record(updates), ctrl.last_timings, wall, snap

    with StepRecorder() as steps:
        got, _, _, gpu_snap = reconcile(None)
        runs = [reconcile(None) for _ in range(COLOC_REPEATS)]
    want, cpu_tm, cpu_wall, cpu_snap = reconcile("cpu")
    assert got == want, "controller: cuda != cpu updates"
    assert ([dict(n.allocatable) for n in gpu_snap.nodes]
            == [dict(n.allocatable) for n in cpu_snap.nodes])
    synced = sum(u[2] for u in got)
    degraded = sum(u[3] for u in got)
    assert 0 < synced < len(got) and degraded > 0, (synced, degraded)
    step_ms = steps.ms()[1:]

    def med(key):
        return statistics.median(tm[key] for _, tm, _, _ in runs)

    args = steps.args[0]
    launches = step_launches(args)
    nbytes = step_bytes(args)
    bound_ms, bound_by = bound_of(nbytes, 0)
    n_pods = int(args[1].req.shape[0])
    print(f"colocation (a) NodeResourceController [{card}]: "
          f"{len(got)} nodes, {n_pods} pod rows (dangling included): "
          f"{synced} synced, {degraded} degraded; cuda == cpu (every "
          f"update field and node); median of {COLOC_REPEATS} after a "
          f"warm-up: lower_s {med('lower_s'):.4f} stage_s "
          f"{med('stage_s'):.4f} step (CUDA events) "
          f"{statistics.median(step_ms):.4f} ms readback_s "
          f"{med('readback_s'):.4f} wall "
          f"{statistics.median(w for _, _, w, _ in runs):.4f} s; cpu wall "
          f"{cpu_wall:.4f} s (step_s {cpu_tm['step_s']:.4f}); step launches "
          f"{'not measured' if launches is None else launches}, "
          f"{nbytes} B, bound {bound_ms:.5f} ms ({bound_by})", flush=True)


def colocation_loop(spec, changes, device=None, card=None):
    """Phase 14 (b) on ``device`` (the card unless given): the wired loop.
    Returns ``(record, kernel captures)``: the record holds every round's
    placements, published binds and every reconcile's synced count and
    PATCHed nodes."""
    on_card = device is None
    bus = APIServer()
    sched = Scheduler(model=PlacementModel(device=device))
    wire_scheduler(bus, sched)
    manager = wire_manager(bus, NodeResourceController(
        testing.colocation_config(spec, sloconfig), device=device))
    published, patched = [], []
    bus.watch(Kind.POD, lambda e, name, pod: published.append(
        (name, pod.node_name)) if e.value == "MODIFIED" else None)
    bus.watch(Kind.NODE, lambda e, name, node: patched.append(
        (name, {int(k): v for k, v in node.allocatable.items()}))
        if e.value == "MODIFIED" else None)
    testing.apply_colocation(bus, Kind, spec, ttypes)
    index = {name: i for i, name in enumerate(sched.cache.nodes)}
    now = spec["now"]
    record, captures, lines = [], [], []
    e2e_before = {lane: POD_E2E.count({"lane": lane})
                  for lane in ("system", "ls", "be")}

    def round_(k, t):
        del published[:]
        if on_card:
            result, launches, wall, captured = drive(
                lambda: sched.schedule_pending(now=t))
            inp, route = routed(f"colocation round {k}", launches, captured,
                                "cluster")
            captures.append((frozen(inp), route, launches[route.kind]))
        else:
            t0 = time.perf_counter()
            result = sched.schedule_pending(now=t)
            wall = time.perf_counter() - t0
        placed = {u: n for u, n in result.items() if n is not None}
        capacity_batch(sched, set(placed.values()))
        delta = sched.model.staged_cache.last_delta
        rows = None if delta.idx is None else sorted(int(i) for i in delta.idx)
        record.append(("round", k, dict(result), sorted(published)))
        tm = sched.model.last_timings
        lines.append(f"round {k}: {len(placed)}/{len(result)} placed; "
                     f"{sched.model.last_staging} staging "
                     f"({'all' if rows is None else len(rows)} rows); wall "
                     f"{wall:.4f} s (lower_s {tm['lower_s']:.4f} stage_s "
                     f"{tm['stage_s']:.4f} solve_s {tm['solve_s']:.4f})")
        return placed, rows

    def reconcile(k, t):
        del patched[:]
        t0 = time.perf_counter()
        synced = manager.reconcile(now=t)
        wall = time.perf_counter() - t0
        record.append(("reconcile", k, synced, list(patched)))
        lines.append(f"reconcile {k}: {synced} synced, wall {wall:.4f} s")
        return {name for name, _ in patched}

    TRACER.clear()
    placed1, _ = round_(1, now)
    assert not placed1, "round 1 placed a BE pod before any PATCH"
    synced1 = reconcile(1, now + 10)
    placed2, rows2 = round_(2, now + 20)
    assert placed2, "round 2 placed no BE pod"
    assert sched.model.last_staging == "delta"
    assert rows2 == sorted(index[n] for n in synced1), "round 2 restage"
    changed = set()
    for m in changes:
        bus.apply(Kind.NODE_METRIC, m["node_name"],
                  testing.colocation_metric(m, ttypes))
        changed.add(m["node_name"])
    synced2 = reconcile(2, now + 60)
    assert synced2 and synced2 <= changed and len(synced2) < len(changed)
    _, rows3 = round_(3, now + 70)
    assert sched.model.last_staging == "delta"
    touched = synced2 | changed | set(placed2.values())
    assert rows3 == sorted(index[n] for n in touched), "round 3 restage"
    spans = {}
    for e in TRACER.events():
        spans[e["name"]] = spans.get(e["name"], 0) + 1
    e2e = {lane: POD_E2E.count({"lane": lane}) - e2e_before[lane]
           for lane in e2e_before}
    where = "card" if on_card else "cpu"
    for line in lines:
        print(f"colocation (b) on the {where} [{card}]: {line}", flush=True)
    print(f"colocation (b) on the {where}: spans {spans}; POD_E2E count by "
          f"lane {e2e}; {len(changed)} metrics changed, {len(synced2)} "
          f"synced", flush=True)
    return record, captures


def capacity_batch(sched, nodes) -> None:
    """Batch capacity holds on each of ``nodes``: the batch requests of the
    pods the Scheduler holds there fit the node's batch allocatable."""
    cols = (ResourceName.BATCH_CPU, ResourceName.BATCH_MEMORY)
    load = {n: [0, 0] for n in nodes}
    for pod in sched.cache.pods.values():
        if pod.node_name in load:
            for k, col in enumerate(cols):
                load[pod.node_name][k] += pod.requests.get(col, 0)
    for name, used in load.items():
        alloc = sched.cache.nodes[name].allocatable
        for k, col in enumerate(cols):
            assert used[k] <= alloc.get(col, 0), f"{name} batch overcommitted"


def colocation(card) -> dict:
    """Phase 14. Returns its ``kernels`` entry."""
    t0 = time.perf_counter()
    spec = testing.colocation_world_spec(
        seed=COLOC_SEED, n_nodes=COLOC_NODES, pods_per_node=COLOC_PPN,
        n_dangling=COLOC_DANGLING, n_pending=COLOC_PENDING)
    changes = testing.colocation_metric_changes(
        spec, frac=COLOC_CHANGED, now=spec["now"] + 50)
    controller_phase(spec, card)
    got, captures = colocation_loop(spec, changes, card=card)
    # the CPU loop's plain twin runs a few torch ops a pod on [5000, 8]
    # tensors: on one intra-op thread it takes about half the time it
    # takes on the machine's eight (phase 20 (c))
    threads = torch.get_num_threads()
    torch.set_num_threads(CPU_ROUND_THREADS)
    try:
        want, _ = colocation_loop(spec, changes, device="cpu", card=card)
    finally:
        torch.set_num_threads(threads)
    for g, w in zip(got, want):
        assert g == w, f"colocation {g[0]} {g[1]}: cuda != cpu"
    assert len(got) == len(want)
    wave, route, _ = captures[1]
    launches = sum(n for _, _, n in captures)
    wave_ms = cuda_ms(lambda: bk.binpack(wave), 5)
    print(f"colocation (b): every round, bind and PATCH == the cpu run; "
          f"route {route_name(route)} ({route.n_loc} rows per CTA); "
          f"launches {launches}; round 2's kernel (the wave, "
          f"{wave.req.shape[0]} pods) {wave_ms:.3f} ms", flush=True)
    # the twin of round 2's 10,000 pods alone takes ~12 s on the card:
    # round 3's launch (the wave's remainder) is held and timed instead
    stats = compare(captures[2][0], "colocation round 3's inputs", card,
                    reps=5)
    print(f"colocation phase wall {time.perf_counter() - t0:.2f} s",
          flush=True)
    return entry("binpack_colocation", launches, stats, 317)


# -- 15. the pipelined and streaming loops -------------------------------------

def counter_total(metric) -> float:
    """A counter's total over every label set."""
    return sum(v for _, _, v in metric.samples())


def p50_p99(samples):
    """(p50, p99) of ``samples``: the p99 index rounded up, as the
    reference bench takes it, so a short run's worst round is kept."""
    xs = sorted(samples)
    return xs[len(xs) // 2], xs[min(len(xs) - 1,
                                    math.ceil(0.99 * (len(xs) - 1)))]


def loop_faults() -> float:
    """Deferred publish-side errors and skipped rounds so far."""
    return (counter_total(PIPELINE_DEFERRED_ERRORS)
            + counter_total(ROUNDS_SKIPPED))


def node_accounting(snap):
    """Every staged field of a full lowering of ``snap``."""
    arrays = lower_nodes(snap)
    return list(arrays.names), {f: getattr(arrays, f).tolist()
                                for f in STAGED_NODE_FIELDS}


def accounting(bus):
    """The bus's node accounting: every staged field of a full lowering."""
    return node_accounting(snapshot_from_bus(bus, now=500.0))


def pipe_world(device=None):
    """Bench config #13's world through ``wire_scheduler`` on ``device``
    (the card unless given)."""
    bus = APIServer()
    sched = Scheduler(model=PlacementModel(device=device))
    wire_scheduler(bus, sched)
    testing.loop_world(bus, Kind, PIPE_NODES)
    return bus, sched


def pipe_tick(bus, rng, t, now) -> None:
    testing.loop_tick(bus, Kind, rng, t, now, PIPE_NODES, dirty=PIPE_DIRTY,
                      pending=PIPE_PENDING)


def pipe_serial(device=None) -> dict:
    """Config #13 through the serial loop: each tick's metrics and pods,
    then one blocking round (the bench's serial arm)."""
    bus, sched = pipe_world(device)
    rng = np.random.default_rng(7)
    for t in range(PIPE_WARMUP):
        sched.schedule_pending(now=15.0 + 0.1 * t)
    log, walls, stages = [], [], []
    for t in range(PIPE_SETTLE + PIPE_TIMED):
        now = 20.0 + t
        pipe_tick(bus, rng, t, now)
        t0 = time.perf_counter()
        out = sched.schedule_pending(now=now)
        wall = time.perf_counter() - t0
        log.append(sorted(out.items()))
        if t >= PIPE_SETTLE:
            walls.append(wall)
            stages.append(dict(sched.model.last_timings))
    return dict(log=log, accounting=accounting(bus), walls=walls,
                stages=stages)


def stage_histogram():
    return {stage: (TICK_STAGE_DURATION.count({"stage": stage}),
                    TICK_STAGE_DURATION.sum({"stage": stage}))
            for stage in ("lower", "stage", "solve", "publish")}


def pipe_pipelined(profile_dir) -> dict:
    """Config #13 through ``TickPipeline`` on the card at the bench's
    cadence, tick t+1's metrics and pods applied while tick t is in
    flight; then a profile window over PROFILE_ROUNDS more ticks, closed
    by one more tick submitted right after the last one retired."""
    bus, sched = pipe_world()
    rng = np.random.default_rng(7)
    log, rows = [], []
    holder = {}

    def on_result(out):
        log.append(sorted(out.items()))
        rows.append(holder["pipeline"].status()["last_round"])

    pipeline = TickPipeline(sched, log=lambda *a: None, on_result=on_result)
    holder["pipeline"] = pipeline
    ticks = PIPE_SETTLE + PIPE_TIMED
    walls = []

    def cadence(next_fire):
        lag = next_fire - time.perf_counter()
        if lag > 0:
            time.sleep(lag)

    def timed_ticks():
        pipe_tick(bus, rng, 0, 20.0)
        next_fire = time.perf_counter()
        for t in range(ticks):
            now = 20.0 + t
            cadence(next_fire)
            t0 = time.perf_counter()
            pipeline.submit_round(now=now)
            wall = time.perf_counter() - t0
            next_fire = t0 + PIPE_INTERVAL_S
            if t >= PIPE_SETTLE:
                walls.append(wall)
            if t + 1 < ticks:
                pipe_tick(bus, rng, t + 1, now + 1.0)
            pipeline.prestage(now=now)
        pipeline.drain("smoke")

    try:
        for t in range(PIPE_WARMUP):
            pipeline.submit_round(now=15.0 + 0.1 * t)
            pipeline.drain("warmup")
        log.clear()
        rows.clear()
        before = stage_histogram()
        _, launches, wall, captured = drive(timed_ticks)
        after = stage_histogram()
        book = accounting(bus)
        DEVICE_OBS.configure(profile_dir=profile_dir,
                             profile_min_interval_s=0.0)
        armed = DEVICE_OBS.request_profile(rounds=PROFILE_ROUNDS)
        assert armed.get("armed"), armed
        pipe_tick(bus, rng, ticks, 20.0 + ticks)
        next_fire = time.perf_counter()
        for k in range(PROFILE_ROUNDS + 1):
            t = ticks + k
            if k < PROFILE_ROUNDS:
                cadence(next_fire)
            else:
                pipeline.drain("profile")
            next_fire = time.perf_counter() + PIPE_INTERVAL_S
            with torch.profiler.record_function(ROUND_RANGE):
                pipeline.submit_round(now=20.0 + t)
            if k < PROFILE_ROUNDS:
                pipe_tick(bus, rng, t + 1, 21.0 + t)
            pipeline.prestage(now=20.0 + t)
        pipeline.drain("smoke")
    finally:
        pipeline.stop()
    profile = DEVICE_OBS.status()["profile"]
    assert profile["last_error"] is None and profile["windows"], profile
    stages = {stage: ((after[stage][1] - before[stage][1])
                      / max(1, after[stage][0] - before[stage][0]))
              for stage in after}
    return dict(log=log[:ticks], accounting=book, walls=walls,
                rows=rows[PIPE_SETTLE:ticks], stages=stages,
                launches=launches, captured=captured, wall=wall,
                window=profile["windows"][-1], threads=profile["threads"],
                sched=sched)


#: the trace's device activity: kernels, copies and memsets
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


#: the harness's range around each round it starts inside a window
ROUND_RANGE = "smoke:round"


def merged(intervals) -> list:
    """Sorted, disjoint cover of ``[(start, end)]``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(intervals, within) -> float:
    """Length of the union of ``intervals`` inside the union of
    ``within``."""
    xs, ys = merged(intervals), merged(within)
    total, j = 0.0, 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            total += min(b, ys[k][1]) - max(a, ys[k][0])
            k += 1
    return total


def critical_paths(spans, start, rounds) -> list:
    """Each of the window's ``rounds`` rounds as ``(start, read-back
    end)``: the first from the window's start (its ``on_round`` opened
    the window, with no round in flight), each later one from the
    harness's ROUND_RANGE, paired in order with the ``ktpu:read_back``
    ranges (one a round, on the publisher; host ranges only, not their
    ``gpu_user_annotation`` copies on the device's track). Empty when the
    trace lacks them (the publisher's thread not profiled)."""
    host = [e for e in spans if e.get("cat") == "user_annotation"]
    starts = sorted(e["ts"] for e in host
                    if e["name"] == ROUND_RANGE and e["ts"] > start)
    ends = sorted(e["ts"] + e["dur"] for e in host
                  if e["name"] == "ktpu:read_back")
    if len(starts) < rounds - 1 or len(ends) < rounds:
        return []
    paths = list(zip([start] + starts[:rounds - 1], ends[:rounds]))
    assert all(a < b for a, b in paths), paths
    return paths


def idle_share(path, rounds) -> dict:
    """The device's idle share in one profile window: one minus the union
    of its kernel, copy and memset intervals over the window's wall (the
    span of every event the window recorded: the first round's start to
    the last round's retire), its kernel count, and the longest idle gap
    with the ``ktpu:`` annotation (or other CPU range) it falls under.
    Beside it the same share over the union of the ``rounds`` rounds'
    critical paths (:func:`critical_paths`), which leaves out the gaps
    between rounds, the harness's cadence sleep among them."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    start = min(e["ts"] for e in spans)
    end = max(e["ts"] + e["dur"] for e in spans)
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans
                    if e.get("cat") in DEVICE_CATS)
    paths = critical_paths(spans, start, rounds)
    crit = sum(b - a for a, b in merged(paths))
    crit_busy = covered(device, paths)
    busy, gaps, cursor = 0.0, [], start
    for a, b in device:
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if end > cursor:
        gaps.append((cursor, end))
    gap = max(gaps, key=lambda g: g[1] - g[0]) if gaps else (start, start)
    mid = (gap[0] + gap[1]) / 2
    covering = [e for e in spans if e.get("cat") in (
        "user_annotation", "cpu_op", "python_function")
        and e["ts"] <= mid <= e["ts"] + e["dur"]]
    named = [e for e in covering if e["name"].startswith("ktpu:")]
    under = min(named or covering, key=lambda e: e["dur"],
                default=None)
    kernels = [e for e in spans if e.get("cat") == "kernel"]
    wall = end - start
    return dict(idle=1.0 - busy / wall if wall else 0.0, wall_ms=wall / 1e3,
                busy_ms=busy / 1e3,
                crit_idle=1.0 - crit_busy / crit if crit else None,
                crit_ms=crit / 1e3, crit_busy_ms=crit_busy / 1e3,
                kernels=len(kernels),
                placement=sum("binpack" in e["name"] for e in kernels),
                gap_ms=(gap[1] - gap[0]) / 1e3,
                under=under["name"] if under is not None else "none",
                cats=sorted({e.get("cat") for e in spans}))


def window_line(label, stats, threads, card) -> str:
    crit = ("not measured (no read-back ranges in the trace)"
            if stats["crit_idle"] is None else
            f"{stats['crit_idle']:.6f} of {stats['crit_ms']:.3f} ms (busy "
            f"{stats['crit_busy_ms']:.3f} ms)")
    return (f"{label} [{card}]: device idle share {stats['idle']:.6f} of a "
            f"{stats['wall_ms']:.3f} ms window (busy {stats['busy_ms']:.3f} "
            f"ms: kernels, copies, memsets); over the rounds' critical paths "
            f"(round start to read-back, the gaps between rounds left out) "
            f"{crit}; {stats['kernels']} kernels "
            f"({stats['placement']} placement); longest idle gap "
            f"{stats['gap_ms']:.3f} ms under {stats['under']}; threads "
            f"profiled: {threads}; trace categories {stats['cats']}")


def pipelined_churn(card, profile_dir, dump_dir) -> dict:
    """Phase 15 (a): config #13 through the serial loop on the card, the
    pipelined loop on the card and the serial loop on the CPU; equal tick
    for tick and in the bus's node accounting. (c), the flight dump, is
    taken between the last two, while the pipelined Scheduler is alive.
    Returns the ``binpack_pipelined`` entry."""
    faults = loop_faults()
    serial = pipe_serial()
    piped = pipe_pipelined(profile_dir)
    flight_dump(card, dump_dir, piped.pop("sched"))
    cpu = pipe_serial("cpu")
    assert loop_faults() == faults, "a deferred error or a skipped round"
    ticks = PIPE_SETTLE + PIPE_TIMED
    assert len(piped["log"]) == len(serial["log"]) == len(cpu["log"]) == ticks
    for t in range(ticks):
        assert piped["log"][t] == serial["log"][t], f"pipelined != serial {t}"
        assert serial["log"][t] == cpu["log"][t], f"cuda != cpu at tick {t}"
    assert piped["accounting"] == serial["accounting"] == cpu["accounting"]
    inp, route = piped["captured"][-1]
    assert all(r == route for _, r in piped["captured"]), "route changed"
    launches = piped["launches"][route.kind]
    assert launches == ticks, piped["launches"]
    placed = sum(n is not None for tick in piped["log"] for _, n in tick)
    s50, s99 = p50_p99(serial["walls"])
    p50, p99 = p50_p99(piped["walls"])
    c50, c99 = p50_p99(cpu["walls"])
    med = {k: statistics.median(tm[k] for tm in serial["stages"])
           for k in ("lower_s", "stage_s", "solve_s")}
    rows = {k: statistics.median(r.get(f"{k}_s", 0.0) for r in piped["rows"])
            for k in ("lower", "stage", "solve", "publish")}
    print(f"pipelined churn (config #13) [{card}]: {PIPE_NODES} nodes, "
          f"{PIPE_DIRTY} metrics + {PIPE_PENDING} pods a tick, "
          f"{PIPE_INTERVAL_S * 1e3:.0f} ms cadence, {ticks} ticks "
          f"({PIPE_SETTLE} settle): {placed} placed; serial on the card == "
          f"pipelined on the card == serial on the cpu, tick for tick and in "
          f"the bus's node accounting; 0 deferred errors, 0 skipped rounds; "
          f"route {route_name(route)} ({route.shards} CTAs, {route.n_loc} "
          f"rows per CTA); launches {launches}", flush=True)
    print(f"pipelined churn [{card}]: round critical path over "
          f"{PIPE_TIMED} timed ticks: serial (the round's wall) p50 "
          f"{s50 * 1e3:.3f} ms p99 {s99 * 1e3:.3f} ms; pipelined "
          f"(submit_round's wall) p50 {p50 * 1e3:.3f} ms p99 "
          f"{p99 * 1e3:.3f} ms; serial on the cpu p50 {c50 * 1e3:.3f} ms "
          f"p99 {c99 * 1e3:.3f} ms", flush=True)
    print(f"pipelined churn [{card}]: TICK_STAGE_DURATION mean over the "
          f"timed ticks: " + ", ".join(
              f"{k} {v * 1e3:.3f} ms" for k, v in piped["stages"].items())
          + "; pipelined medians " + ", ".join(
              f"{k} {v * 1e3:.3f} ms" for k, v in rows.items())
          + "; serial medians " + ", ".join(
              f"{k} {v * 1e3:.3f} ms" for k, v in med.items()), flush=True)
    print(window_line(f"pipelined churn, profile window over "
                      f"{PROFILE_ROUNDS} ticks",
                      idle_share(piped["window"], PROFILE_ROUNDS),
                      piped["threads"], card), flush=True)
    stats = compare(inp, f"a config #13 tick, {PIPE_NODES} x "
                    f"{inp.req.shape[0]}", card, reps=5)
    queued_line("a config #13 tick", inp, stats, card)
    return entry("binpack_pipelined", launches, stats, 317)


def queued_line(label, inp, stats, card) -> None:
    """A small solve's launches queued behind a sleeping kernel (the
    card's time for one, apart from the host's time to issue it) beside
    :func:`compare`'s back-to-back calls."""
    ms = device_ms(lambda: bk.binpack(inp), 5, LANE_SLEEP_CYCLES)
    print(f"{label} [{card}]: kernel queued on the card {ms:.4f} ms a "
          f"launch; back to back {stats['ms']:.4f} ms", flush=True)


def flight_dump(card, dump_dir, sched) -> None:
    """Phase 15 (c): a manual flight-recorder dump after (a)'s pipelined
    run holds its ticks' round records and the card's allocator numbers,
    with that run's staged cache as the ``staged_cache`` owner."""
    model = sched.model
    assert model.device.type == "cuda", model.device
    path = FLIGHT.trigger("manual", detail="chip_smoke phase 15")
    assert path is not None, FLIGHT.dumps()
    assert os.path.dirname(path) == dump_dir, path
    with open(path) as f:
        payload = json.load(f)
    rounds = payload["rounds"]
    timed = [r for r in rounds if r.get("placed") == PIPE_PENDING]
    assert len(timed) >= PIPE_SETTLE + PIPE_TIMED, len(timed)
    assert all(r.get("solver") == "kernel" for r in timed)
    live = payload["device"]["live"]
    staged = model.staged_cache.device_bytes()
    assert live["bytes"] > 0 and staged > 0, live
    assert live["owners"]["staged_cache"] == staged, (live, staged)
    print(f"flight recorder [{card}]: manual dump {os.path.getsize(path)} B, "
          f"{len(rounds)} round records ({len(timed)} pipelined ticks of "
          f"{PIPE_PENDING} placed), device section: {live['device']}, "
          f"{live['bytes']} B allocated, {live['reserved_bytes']} B "
          f"reserved, {live['max_allocated_bytes']} B peak, "
          f"{live['alloc_retries']} allocator retries, the pipelined "
          f"run's staged cache on {model.device} "
          f"{live['owners']['staged_cache']} B", flush=True)


def stream_world(device=None):
    """Bench config #18's world through ``wire_scheduler`` on ``device``,
    after one warm-up round on a throwaway pod (deleted, timelines
    reset), as the reference bench warms it."""
    bus = APIServer()
    sched = Scheduler(model=PlacementModel(device=device))
    wire_scheduler(bus, sched)
    testing.loop_world(bus, Kind, STREAM_NODES, assigned=False)
    warm = ttypes.PodSpec(name="warm0", requests={
        ResourceName.CPU: 100, ResourceName.MEMORY: 64})
    bus.apply(Kind.POD, warm.uid, warm)
    sched.schedule_pending(now=15.0)
    bus.delete(Kind.POD, warm.uid)
    sched.timelines.reset()
    return bus, sched


def trace_pod(a):
    return ttypes.PodSpec(name=a.name, qos=a.qos, requests={
        ResourceName.CPU: a.cpu, ResourceName.MEMORY: a.memory})


def stream_adaptive(rate, seed=None, seconds=None, profile_dir=None) -> dict:
    """The adaptive arm on the card: an open-loop wall-clock drive of a
    pipelined ``StreamingLoop`` (the reference bench's). With
    ``profile_dir``, a profile window over PROFILE_ROUNDS rounds opens
    0.3 s in and is closed by one round fired right after the last one
    retired."""
    seed = STREAM_SEED if seed is None else seed
    seconds = STREAM_SECONDS if seconds is None else seconds
    bus, sched = stream_world()
    loop = StreamingLoop(
        sched, apply_fn=lambda pod: bus.apply(Kind.POD, pod.uid, pod),
        delete_fn=lambda uid: bus.delete(Kind.POD, uid),
        config=StreamingConfig(watermark=STREAM_WATERMARK,
                               lane_deadline_s=(0.002, 0.010, 0.050)),
        pipelined=True, log=lambda *a: None)
    trace = heavy_tail_trace(seed, duration_s=seconds, rate_pods_per_s=rate,
                             cpu_cap=8000)
    pods_by_uid = {}
    triggers = {r: STREAM_TRIGGERS.value({"reason": r})
                for r in ("watermark", "deadline", "idle")}
    window = {"armed": profile_dir is None, "closed": profile_dir is None}

    def run():
        arrivals = trace.arrivals
        t0 = time.perf_counter()
        i = 0
        while i < len(arrivals):
            now = time.perf_counter() - t0
            while i < len(arrivals) and arrivals[i].at <= now:
                pod = trace_pod(arrivals[i])
                pods_by_uid[pod.uid] = dataclasses.replace(pod)
                loop.submit(pod)
                i += 1
            if not window["armed"] and now >= 0.3:
                # the window's first round starts with none in flight
                loop.pipeline.drain("profile")
                DEVICE_OBS.configure(profile_dir=profile_dir,
                                     profile_min_interval_s=0.0)
                armed = DEVICE_OBS.request_profile(rounds=PROFILE_ROUNDS)
                assert armed.get("armed"), armed
                window["armed"] = True
            reason = loop.due()
            if reason is not None:
                with (torch.profiler.record_function(ROUND_RANGE)
                      if profile_dir is not None else nullcontext()):
                    loop.fire_round(reason)
                if window["armed"] and not window["closed"] and \
                        DEVICE_OBS.status()["profile"][
                            "active_rounds_left"] == 1:
                    loop.pipeline.drain("profile")
                    with torch.profiler.record_function(ROUND_RANGE):
                        loop.fire_round("idle")
                    window["closed"] = True
                continue
            nxt = (arrivals[i].at - (time.perf_counter() - t0)
                   if i < len(arrivals) else 0.0)
            dl = loop.gate.next_deadline()
            wait = nxt if dl is None else min(
                nxt, max(0.0, dl - time.monotonic()))
            if wait > 0:
                time.sleep(min(wait, 0.005))
        drained = loop.drain(timeout_s=30.0)
        return drained, time.perf_counter() - t0 - arrivals[-1].at

    try:
        (drained, drain_wall), launches, wall, captured = drive(run)
    finally:
        loop.stop()
    st = loop.status()
    gate = st["gate"]
    return dict(bus=bus, sched=sched, gate=gate, round_log=list(
        loop.round_log), pods_by_uid=pods_by_uid, drained=drained,
        drain_wall=max(0.0, drain_wall), rounds=st["rounds"],
        latency=sched.timelines.stats()["all"], launches=launches,
        captured=captured, submitted=gate["submitted"],
        bound=gate["bound"],
        shed=gate["shed"]["capacity"] + gate["shed"]["deadline-exceeded"],
        triggers={r: STREAM_TRIGGERS.value({"reason": r}) - v
                  for r, v in triggers.items()})


def stream_fixed(rate) -> dict:
    """The fixed arm on the card: the same trace with a pipelined round
    every STREAM_INTERVAL_S whatever the queue holds (``run_loop``'s
    shape), then rounds until nothing is pending."""
    bus, sched = stream_world()
    pipeline = TickPipeline(sched, log=lambda *a: None)
    arrivals = heavy_tail_trace(STREAM_SEED, duration_s=STREAM_SECONDS,
                                rate_pods_per_s=rate, cpu_cap=8000).arrivals
    t0 = time.perf_counter()
    next_round = t0 + STREAM_INTERVAL_S
    i = rounds = 0
    try:
        while i < len(arrivals):
            now = time.perf_counter()
            while i < len(arrivals) and arrivals[i].at <= now - t0:
                pod = trace_pod(arrivals[i])
                bus.apply(Kind.POD, pod.uid, pod)
                i += 1
            if now >= next_round:
                pipeline.submit_round(now=time.time())
                pipeline.prestage(now=time.time())
                rounds += 1
                next_round += STREAM_INTERVAL_S
                continue
            nxt = t0 + arrivals[i].at if i < len(arrivals) else next_round
            wait = min(next_round, nxt) - time.perf_counter()
            if wait > 0:
                time.sleep(min(wait, 0.005))
        deadline = time.perf_counter() + 30.0
        while time.perf_counter() < deadline:
            pipeline.drain("smoke")
            if not sched.cache.pending:
                break
            pipeline.submit_round(now=time.time())
            rounds += 1
    finally:
        pipeline.stop()
    assert not sched.cache.pending, "the fixed arm left pods pending"
    return dict(latency=sched.timelines.stats()["all"], rounds=rounds,
                n=len(arrivals))


def stream_replay(arm, device=None) -> None:
    """The adaptive arm's recorded batches through the fixed-round loop
    on ``device``: placements and node accounting equal, bit for bit."""
    bus, sched = stream_world(device)
    for _reason, at, uids in arm["round_log"]:
        for uid in uids:
            pod = arm["pods_by_uid"][uid]
            bus.apply(Kind.POD, pod.uid, pod)
        sched.schedule_pending(now=at)
    mine = {u: p.node_name for u, p in arm["bus"].list(Kind.POD).items()}
    theirs = {u: p.node_name for u, p in bus.list(Kind.POD).items()}
    assert mine == theirs, f"replay on {device or 'cuda'}: placements"
    assert accounting(arm["bus"]) == accounting(bus), "replay: accounting"


def resolved(arm) -> None:
    """Every submitted pod resolved: bound, shed or expired."""
    assert arm["drained"], "the intake did not drain"
    assert not arm["sched"].cache.pending, "pods left pending"
    assert arm["submitted"] == arm["bound"] + arm["shed"], arm["gate"]


def streaming_arrivals(card, profile_dir) -> dict:
    """Phase 15 (b): config #18, both arms pipelined on the card at each
    rate, the adaptive arm's replay, the shed-point ladder and a profiled
    run. Returns the ``binpack_streaming`` entry."""
    faults = loop_faults()
    for rate in STREAM_RATES:
        adaptive = stream_adaptive(rate)
        fixed = stream_fixed(rate)
        resolved(adaptive)
        assert fixed["n"] == adaptive["submitted"]
        stream_replay(adaptive)
        devices = ["cuda"]
        if rate == STREAM_RATES[0]:
            stream_replay(adaptive, "cpu")
            devices.append("cpu")
        routes = {route_name(r) for _, r in adaptive["captured"]}
        assert routes == {"block"}, routes
        launches = adaptive["launches"]["block"]
        a, f = adaptive["latency"], fixed["latency"]
        print(f"streaming arrivals (config #18) at {rate:.0f} pods/s "
              f"[{card}]: {STREAM_NODES} nodes, heavy-tail trace "
              f"{STREAM_SEED} over {STREAM_SECONDS:.1f} s, "
              f"{adaptive['submitted']} pods; adaptive (watermark "
              f"{STREAM_WATERMARK}, deadlines 2/10/50 ms): submit->bind p50 "
              f"{a['p50_s'] * 1e3:.3f} ms p99 {a['p99_s'] * 1e3:.3f} ms over "
              f"{a['count']} binds, {adaptive['rounds']} rounds by trigger "
              f"{adaptive['triggers']}, {adaptive['bound']} bound + "
              f"{adaptive['shed']} shed or expired = "
              f"{adaptive['submitted']} submitted, tail drained in "
              f"{adaptive['drain_wall']:.3f} s; fixed "
              f"{STREAM_INTERVAL_S * 1e3:.0f} ms cadence: p50 "
              f"{f['p50_s'] * 1e3:.3f} ms p99 {f['p99_s'] * 1e3:.3f} ms over "
              f"{f['count']} binds, {fixed['rounds']} rounds; route block, "
              f"launches {launches}; the adaptive arm's replay through the "
              f"fixed-round loop == on {' and '.join(devices)}", flush=True)
    sustained, shed_at = None, None
    for rate in LADDER_RATES:
        arm = stream_adaptive(rate, seed=LADDER_SEED, seconds=LADDER_SECONDS)
        ok = (arm["shed"] == 0 and arm["drained"]
              and arm["bound"] == arm["submitted"]
              and arm["drain_wall"] <= 1.0)
        print(f"shed-point ladder [{card}]: {rate:.0f} pods/s for "
              f"{LADDER_SECONDS} s: {arm['submitted']} submitted, "
              f"{arm['bound']} bound, {arm['shed']} shed, tail drained in "
              f"{arm['drain_wall']:.3f} s, p99 "
              f"{arm['latency']['p99_s'] * 1e3:.3f} ms -> "
              f"{'sustained' if ok else 'not sustained'}", flush=True)
        if not ok:
            shed_at = rate
            break
        sustained = rate
    print(f"shed point [{card}]: highest rung with nothing shed "
          f"{sustained if sustained is None else f'{sustained:.0f}'} pods/s; "
          f"first rung past it {shed_at}", flush=True)
    profiled = stream_adaptive(STREAM_RATES[-1],
                               seconds=STREAM_PROFILE_SECONDS,
                               profile_dir=profile_dir)
    resolved(profiled)
    profile = DEVICE_OBS.status()["profile"]
    assert profile["last_error"] is None and profile["windows"], profile
    print(window_line(f"streaming at {STREAM_RATES[-1]:.0f} pods/s, profile "
                      f"window over {PROFILE_ROUNDS} rounds",
                      idle_share(profile["windows"][-1], PROFILE_ROUNDS),
                      profile["threads"],
                      card), flush=True)
    inp, launches = watermark_round(card)
    assert loop_faults() == faults, "a deferred error or a skipped round"
    stats = compare(inp, f"a watermark round of config #18, "
                    f"{STREAM_NODES} x {inp.req.shape[0]}", card, reps=5)
    queued_line("a watermark round of config #18", inp, stats, card)
    return entry("binpack_streaming", launches, stats, 93)


def watermark_round(card):
    """The ``binpack_streaming`` entry's round, the same in every run:
    the first STREAM_WATERMARK arrivals of config #18's trace at the top
    rate, submitted on a fake clock to a pipelined ``StreamingLoop`` on
    the card, whose watermark fires one round of exactly that many pods.
    Returns ``(inputs, launches)`` of that driven run."""
    bus, sched = stream_world()
    loop = StreamingLoop(
        sched, apply_fn=lambda pod: bus.apply(Kind.POD, pod.uid, pod),
        delete_fn=lambda uid: bus.delete(Kind.POD, uid),
        config=StreamingConfig(watermark=STREAM_WATERMARK,
                               lane_deadline_s=(0.002, 0.010, 0.050)),
        pipelined=True, log=lambda *a: None, clock=lambda: 0.0)
    arrivals = heavy_tail_trace(
        STREAM_SEED, duration_s=STREAM_SECONDS,
        rate_pods_per_s=STREAM_RATES[-1],
        cpu_cap=8000).arrivals[:STREAM_WATERMARK]

    def run():
        for a in arrivals:
            assert loop.due(now=0.0) is None, "fired before the watermark"
            assert loop.submit(trace_pod(a), now=0.0) == "queued"
        return loop.pump(now=0.0)

    try:
        reason, launches, _, captured = drive(run)
    finally:
        loop.stop()
    gate = loop.status()["gate"]
    assert reason == "watermark", reason
    assert gate["bound"] == STREAM_WATERMARK, gate
    inp, route = routed("a watermark round of config #18", launches,
                        captured, kind="block")
    assert inp.req.shape[0] == STREAM_WATERMARK, inp.req.shape
    print(f"watermark round (config #18) [{card}]: the trace's first "
          f"{STREAM_WATERMARK} arrivals at {STREAM_RATES[-1]:.0f} pods/s on "
          f"a fake clock, one {reason} round, {gate['bound']} bound; route "
          f"{route_name(route)}, launches {launches['block']}", flush=True)
    return inp, launches["block"]


def loops(card) -> list:
    """Phase 15. Returns its two ``kernels`` entries."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="koord-phase15-")
    try:
        FLIGHT.reset()
        FLIGHT.configure(dump_dir=os.path.join(work, "flight"),
                         min_interval_s=0.0)
        pipelined = pipelined_churn(card, os.path.join(work, "profile"),
                                    os.path.join(work, "flight"))
        streaming = streaming_arrivals(card, os.path.join(work, "profile"))
    finally:
        DEVICE_OBS.reset()
        shutil.rmtree(work, ignore_errors=True)
    print(f"loops phase wall {time.perf_counter() - t0:.2f} s", flush=True)
    return [pipelined, streaming]


# -- 16. the serving failure domain ----------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mux_get(port, path):
    """A GET on a child's debug mux: the body as text for ``/metrics``,
    else as JSON."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        body = resp.read().decode()
    return body if path == "/metrics" else json.loads(body)


def first_local_solve_child(prewarm: bool, device: str = "cuda") -> None:
    """Run in a fresh process by :func:`first_local_solves`: a
    ``FailoverSolver`` over a dead sidecar built with or without
    ``prewarm``, then its first local solve of a config #11 tick (512 x
    32), timed alone (the inputs are staged first, so the CUDA context
    exists in both arms). Prints one JSON line."""
    backend = failover.FailoverSolver(
        RemoteSolver(os.path.join(tempfile.gettempdir(), "nowhere.sock")),
        failure_threshold=1, probe_fn=lambda: False, prewarm=prewarm,
        device=device)
    state, pods, params = testing.example_problem(
        OUTAGE.n_nodes, OUTAGE.pending, seed=1, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    assert backend.wait_prewarm(300)
    t0 = time.perf_counter()
    failover.local_solve(state, pods, params, SolverConfig())
    if device == "cuda":
        torch.cuda.synchronize()
    print(json.dumps({"prewarm": prewarm,
                      "first_local_solve_s": time.perf_counter() - t0,
                      "prewarm_report": backend.prewarm_report}), flush=True)


def first_local_solves() -> dict:
    """The first local solve's wall with and without ``prewarm``, each in
    its own fresh process (the two started together)."""
    root = os.path.dirname(os.path.abspath(__file__))
    procs = {p: subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke as cs; "
         f"cs.first_local_solve_child({p}, {CHILD_DEVICE!r})"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for p in (True, False)}
    out = {}
    for p, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-2000:]
        out[p] = json.loads(stdout.strip().splitlines()[-1])
    return out


def outage_pipelined(sup, backend, card) -> None:
    """Phase 16 (a), the pipelined form: a ``TickPipeline`` over a wired
    Scheduler whose model is the sidecar stack, the supervised child
    SIGKILLed mid-pipeline and respawned; no deferred error, and every
    tick equal to the serial loop on the card."""
    def run(model, pipelined, hooks):
        bus = APIServer()
        sched = Scheduler(model=model, enable_preemption=False)
        wire_scheduler(bus, sched)
        testing.loop_world(bus, Kind, OUTAGE.n_nodes)
        rng = np.random.default_rng(7)
        log, modes = [], []
        pipeline = None
        if pipelined:
            pipeline = TickPipeline(
                sched, log=lambda *a: None,
                on_result=lambda o: log.append(sorted(o.items())))
        try:
            for t in range(OUTAGE_PIPE_TICKS):
                now = 20.0 + t
                testing.loop_tick(bus, Kind, rng, t, now, OUTAGE.n_nodes,
                                  dirty=OUTAGE.dirty, pending=OUTAGE.pending)
                if t in hooks:
                    hooks[t]()
                if pipeline is None:
                    log.append(sorted(sched.schedule_pending(
                        now=now).items()))
                else:
                    pipeline.submit_round(now=now)
                    modes.append(model.last_solver)
                    pipeline.prestage(now=now)
            if pipeline is None:
                return log, modes, None
            pipeline.drain("smoke")
            return log, modes, pipeline.status()
        finally:
            if pipeline is not None:
                pipeline.stop()

    faults = loop_faults()
    restarts = sup.restarts_total
    # a faster respawn than (a)'s, as the reference's case has
    sup.backoff_base_s = sup.backoff_cap_s = OUTAGE_PIPE_BACKOFF_S
    # a new model: the sidecar's base (and the client's belief) start over
    backend._remote.reset_base()
    model = PlacementModel(backend=backend)
    backend.on_flip_back = model.reset_staging
    pid = sup.status()["child_pid"]
    t0 = time.perf_counter()
    piped, modes, status = run(model, True, {
        OUTAGE_PIPE_KILL: lambda: os.kill(pid, signal.SIGKILL),
        OUTAGE_PIPE_WAIT: lambda: wait_running(sup, restarts + 1)})
    wall = time.perf_counter() - t0
    serial, _, _ = run(PlacementModel(), False, {})
    assert piped == serial, "pipelined outage != serial loop on the card"
    assert len(piped) == OUTAGE_PIPE_TICKS
    assert not status["inflight"] and not status["pending_error"], status
    assert loop_faults() == faults, "a deferred error or a skipped round"
    assert mode_runs(modes) == ["remote", "local-fallback",
                                "local-degraded", "remote"], modes
    assert sup.restarts_total == restarts + 1
    print(f"outage, pipelined (config #11's world through TickPipeline) "
          f"[{card}]: {OUTAGE_PIPE_TICKS} ticks, the child (pid {pid}) "
          f"SIGKILLed before tick {OUTAGE_PIPE_KILL} and respawned; every "
          f"tick == the serial loop on the card, 0 deferred errors, 0 "
          f"skipped rounds; modes {' -> '.join(mode_runs(modes))}; wall "
          f"{wall:.2f} s", flush=True)


def wait_running(sup, restarts, timeout_s=120.0) -> float:
    """Block until the supervisor has made ``restarts`` restarts and its
    child probes healthy; returns the wait."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        st = sup.status()
        if st["restarts_total"] >= restarts and st["state"] == "running":
            return time.perf_counter() - t0
        time.sleep(0.05)
    raise AssertionError(f"the supervised child did not come back: "
                         f"{sup.status()}")


def outage_churn_card(card, sockets) -> list:
    """Phase 16 (a) and (d): config #11 through ``build_scheduler``'s
    sidecar stack over a supervised ``cmd.solver`` child on the card.
    Returns the ``binpack_failover_local`` and ``binpack_sidecar_restaged``
    entries."""
    from koordinator_tpu_torch.cmd.scheduler import (
        SchedulerConfig,
        build_scheduler,
    )

    addr = sockets.path("outage")
    port = free_port()
    world = world_bytes(OUTAGE.n_nodes)
    sup = SolverSupervisor(
        addr, extra_argv=("--debug-port", str(port), "--hbm-budget-bytes",
                          str(OUTAGE_BUDGET_WORLDS * world),
                          *CHILD_ARGV),
        probe_interval_s=0.2, backoff_base_s=OUTAGE.backoff_s,
        backoff_cap_s=OUTAGE.backoff_s, ready_timeout_s=300.0)
    t0 = time.perf_counter()
    sup.start()
    boot = time.perf_counter() - t0
    try:
        sched = build_scheduler(SchedulerConfig(
            placement_backend="sidecar", solver_address=addr,
            solver_failover=True,
            solver_failover_threshold=OUTAGE.failure_threshold,
            solver_failover_recovery_probes=OUTAGE.recovery_probes))
        model = sched.model
        backend = model.backend
        remote = backend._remote
        remote.timeout = 60.0
        remote.backoff_base_s, remote.backoff_cap_s = 0.01, 0.05
        assert isinstance(backend, failover.FailoverSolver)
        assert backend.on_flip_back == model.reset_staging
        # the background prewarm's warm-up solves are not the main path
        assert backend.wait_prewarm(300), "prewarm did not finish"
        assert backend.device.type != "cuda" or \
            backend.prewarm_report["loaded"], backend.prewarm_report
        kill_tick = OUTAGE.ticks // 3
        wait_tick = kill_tick + max(4, (OUTAGE.ticks - kill_tick) // 2)
        restaged = {}
        real_solve = remote.solve_result

        def remote_solve(*args, **kwargs):
            out = real_solve(*args, **kwargs)
            if backend.flips_to_remote and "args" not in restaged:
                # copied: later ticks scatter the staged state in place
                restaged.update(args=clone_args(args), result=out,
                                request=remote.last_request)
            return out

        remote.solve_result = remote_solve
        marks = {}

        def on_tick(t):
            if t == kill_tick:
                marks["pid"] = sup.status()["child_pid"]
                marks["kill"] = time.time()
                os.kill(marks["pid"], signal.SIGKILL)
            elif t == wait_tick:
                marks["wait_s"] = wait_running(sup, 1)
            elif t > kill_tick and backend.status()["degraded"]:
                time.sleep(0.15)  # a loop cadence between degraded ticks

        (log, walls, modes, done_at), launches, wall, captured = drive(
            lambda: outage_churn(
                model, ttypes, ClusterDeltaTracker, ResourceName,
                on_tick=on_tick,
                warm=lambda: setattr(remote, "deadline_s", OUTAGE.deadline_s)))
        ref, _, _, _ = outage_churn(PlacementModel(), ttypes,
                                    ClusterDeltaTracker, ResourceName)
        cpu, _, _, _ = outage_churn(PlacementModel(device="cpu"), ttypes,
                                    ClusterDeltaTracker, ResourceName)
        assert log == ref, "outage ticks != the fault-free run on the card"
        assert log == cpu, "outage ticks != the CPU run"
        assert len(log) == OUTAGE.ticks  # no round skipped
        assert mode_runs(modes) == ["remote", "local-fallback",
                                    "local-degraded", "remote"], modes
        local = [i for i, m in enumerate(modes)
                 if m in ("local-fallback", "local-degraded")]
        recovered = [i for i, m in enumerate(modes)
                     if i > kill_tick and m == "remote"]
        st = sup.status()
        assert sup.restarts_total == 1 and st["state"] == "running", st
        assert st["child_pid"] != marks["pid"]
        assert len(captured) == len(local) == launches["block"], (
            len(captured), len(local), launches)
        first = captured[0]
        assert first[1].kind == "block", first[1]
        print(f"outage failover churn (config #11) [{card}]: "
              f"{OUTAGE.n_nodes} nodes, {OUTAGE.dirty} dirty and "
              f"{OUTAGE.pending} pending a tick, {OUTAGE.ticks} ticks, the "
              f"child (pid {marks['pid']}) SIGKILLed at tick {kill_tick}; "
              f"every tick == the fault-free run on the card == the CPU "
              f"run, 0 skipped; modes {' -> '.join(mode_runs(modes))}; "
              f"first local solve {local[0] - kill_tick} ticks after the "
              f"kill; {len(local)} degraded ticks; kill -> first remote "
              f"solve after recovery "
              f"{done_at[recovered[0]] - marks['kill']:.3f} s (the respawn "
              f"waited {marks['wait_s']:.3f} s at tick {wait_tick}); "
              f"supervisor restarts {sup.restarts_total}, state "
              f"{st['state']}; child boot to ready {boot:.3f} s; local "
              f"launches {launches['block']}; tick wall mean "
              f"{statistics.mean(walls) * 1e3:.3f} ms", flush=True)
        solves = first_local_solves()
        print(f"first local solve (config #11 tick, {OUTAGE.n_nodes} x "
              f"{OUTAGE.pending}, a fresh process) [{card}]: with prewarm "
              f"{solves[True]['first_local_solve_s'] * 1e3:.3f} ms (the "
              f"prewarm itself {solves[True]['prewarm_report']}), without "
              f"{solves[False]['first_local_solve_s'] * 1e3:.3f} ms",
              flush=True)
        local_stats = compare(first[0], f"the first local solve of config "
                              f"#11, {OUTAGE.n_nodes} x "
                              f"{first[0].req.shape[0]}", card, reps=5)
        queued_line("the first local solve of config #11", first[0],
                    local_stats, card)
        # (d) the child's debug mux after the churn
        assert debug_port_probe(port)(), "debug-port probe unhealthy"
        status = mux_get(port, "/apis/v1/plugins/solver")
        metrics = mux_get(port, "/metrics")
        for series in ("solver_admission_requests_total",
                       "solver_admission_wait_seconds",
                       "solver_batch_solve_seconds",
                       "solver_device_live_bytes",
                       "scheduler_hbm_budget_bytes",
                       "scheduler_tenant_residency"):
            assert series in metrics, series
        ws = mux_get(port, "/apis/v1/plugins/workingset")
        assert ws["budget_bytes"] == OUTAGE_BUDGET_WORLDS * world, ws
        assert ws["residents"]["device"] == 1, ws
        # the respawned child's block launches: its boot warm-up's one,
        # then one for each remote tick after the recovery
        child_launches = status["kernel_launches"]["block"] - 1
        assert child_launches == len(recovered), (status, recovered)
        print(f"solver debug mux (--debug-port {port}, --hbm-budget-bytes "
              f"{OUTAGE_BUDGET_WORLDS * world}) [{card}]: /healthz healthy; "
              f"/metrics {len(metrics.splitlines())} lines with the "
              f"admission, device and working-set series; solver: "
              f"{status['admission']['requests_total']} requests, kernel "
              f"launches {status['kernel_launches']} (one block and one "
              f"cluster launch of them the boot warm-up), device "
              f"{status['device']['live'].get('device')} "
              f"{status['device']['live'].get('bytes')} B allocated; "
              f"workingset: budget {ws['budget_bytes']} B, used "
              f"{ws['used_bytes']} B, residents {ws['residents']}",
              flush=True)
        # the first remote solve after the flip back: a full restage,
        # solved by the child's kernel; the same solve here on the card
        assert restaged["request"] in ("establish", "full"), \
            restaged["request"]
        got, _, _, again = drive(
            lambda: failover.local_solve(*restaged["args"]))
        assert torch.equal(got.assign.cpu(),
                           restaged["result"].assign.cpu()), \
            "the child's restaged solve != the same kernel here"
        restaged_stats = compare(again[0][0], f"the first remote solve after "
                                 f"the flip back (a full restage), "
                                 f"{OUTAGE.n_nodes} x "
                                 f"{again[0][0].req.shape[0]}", card, reps=5)
        queued_line("the first remote solve after the flip back",
                    again[0][0], restaged_stats, card)
        outage_pipelined(sup, backend, card)
    finally:
        sup.stop()
        WORKING_SET.migration_hook = None
    return [entry("binpack_failover_local", launches["block"], local_stats,
                  93),
            entry("binpack_sidecar_restaged", child_launches,
                  restaged_stats, 93)]


def map_args(x, fn):
    """``fn`` applied to every tensor of a solve's arguments (NamedTuples
    of tensors)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(map_args(v, fn) for v in x))
    if isinstance(x, tuple):
        return tuple(map_args(v, fn) for v in x)
    return x


def clone_args(x):
    """A deep copy of a solve's arguments: the staged state is scattered
    in place by later ticks."""
    return map_args(x, torch.Tensor.clone)


def world_bytes(n_nodes) -> int:
    """Bytes of one staged ``[N]`` world: the six ``[N, 8]`` int32 columns
    and the two ``[N]`` bool ones of ``STAGED_NODE_FIELDS``."""
    return n_nodes * (6 * 8 * 4 + 2)


def fill_small_pool() -> list:
    """Fill the caching allocator's free small-pool blocks (1 MiB and
    below) with tensors that take no new segment: after this, a small
    allocation the caller makes needs a new 2 MiB segment. Returns the
    fillers (the caller frees them)."""
    fillers = []
    size = 1 << 20
    while size >= 512:
        while True:
            before = torch.cuda.memory_reserved()
            t = torch.empty(size, dtype=torch.uint8, device="cuda")
            if torch.cuda.memory_reserved() > before:
                del t
                torch.cuda.empty_cache()
                break
            fillers.append(t)
        size //= 2
    return fillers


def oom_absorbed(card) -> None:
    """Phase 16 (b), a real ``torch.cuda.OutOfMemoryError``: tenant A's
    world resident, tenant B's demoted to the host rung; the free small
    blocks filled and the process capped at what it has reserved, so B's
    restage needs a new segment past the cap. The ladder must catch the
    error, demote A and stage B in A's freed blocks on the retry; the cap
    is lifted once B has staged, and B's solve equals its plain twin."""
    (a_est, a_deltas), (b_est, b_deltas) = (
        density_stream(i, 2, DENSITY.n_nodes, DENSITY.n_pods)
        for i in (90, 91))
    WORKING_SET.reset()
    a = srv.NodeStateCache(tenant="oom-a", lane="ls")
    b = srv.NodeStateCache(tenant="oom-b", lane="ls")
    fillers = []
    total = torch.cuda.get_device_properties(0).total_memory
    real_run = WORKING_SET.run_staged
    capped = {"on": False}

    def run_staged(key, where, fn, estimate=None):
        out = real_run(key, where, fn, estimate)
        if capped["on"] and where == "stage":
            # B staged: lift the cap before the scatter and the solve
            torch.cuda.set_per_process_memory_fraction(1.0)
            capped["on"] = False
        return out

    try:
        for cache, est in ((a, a_est), (b, b_est)):
            resp = srv.solve_from_request(SolveRequest(**est),
                                          node_cache=cache)
            assert not resp.error, resp.error
        assert WORKING_SET.demote(b._ws_key, "host")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        fillers = fill_small_pool()
        reserved = torch.cuda.memory_reserved()
        frac = (reserved + (1 << 20)) / total
        before = WORKING_SET.status()
        WORKING_SET.run_staged = run_staged
        torch.cuda.set_per_process_memory_fraction(frac)
        capped["on"] = True
        resp, launches, _, captured = drive(
            lambda: srv.solve_from_request(SolveRequest(**b_deltas[0]),
                                           node_cache=b))
    finally:
        WORKING_SET.run_staged = real_run
        torch.cuda.set_per_process_memory_fraction(1.0)
        del fillers
        torch.cuda.empty_cache()
    assert not resp.error, resp.error
    after = WORKING_SET.status()
    assert after["alloc_failures"] == {"stage": 1}, after
    assert after["demotions"].get("alloc-failure", 0) == \
        before["demotions"].get("alloc-failure", 0) + 1, after
    assert a.state is None and b.state is not None
    inp, route = routed("B's solve after the ladder", launches, captured,
                        kind="block")
    got = bk.binpack(inp)
    err = max_abs_err(got, twin(inp, route))
    a.close()
    b.close()
    WORKING_SET.reset()
    print(f"a real CUDA out-of-memory absorbed [{card}]: the small pool "
          f"filled, the process capped at {frac:.6f} of "
          f"{total} B ({reserved} B reserved); B's restage raised "
          f"torch.cuda.OutOfMemoryError, the ladder demoted A "
          f"({after['demotions']}), the retry staged B in A's blocks; "
          f"alloc failures {after['alloc_failures']}, restages "
          f"{after['restages']}; B's solve == its plain twin "
          f"(max_abs_err {err})", flush=True)


def density_card(card):
    """Phase 16 (b): config #21 on the card, every budget line against
    the unbudgeted arm. Returns the ``binpack_workingset_restage``
    entry."""
    streams = [density_stream(i, DENSITY.warmup + DENSITY_TIMED + 1,
                              DENSITY.n_nodes, DENSITY.n_pods)
               for i in range(DENSITY.n_tenants)]
    solve = lambda req, cache: srv.solve_from_request(req, node_cache=cache)
    make = lambda i: srv.NodeStateCache(tenant=f"d{i}", lane="be")
    WORKING_SET.reset()
    probe = make("probe")
    assert not solve(SolveRequest(**streams[0][0]), probe).error
    world = probe.device_bytes()
    assert world == world_bytes(DENSITY.n_nodes), world
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    assert WORKING_SET.demote(probe._ws_key, "host")
    torch.cuda.synchronize()
    freed = held - torch.cuda.memory_allocated()
    assert freed >= world, (freed, world)
    probe.close()
    ref_rate, ref_digests, _ = density_arm(
        streams, SolveRequest, solve, make, WORKING_SET, None, world)
    lines = {}
    first = {}

    def capturing(req, cache):
        # the first solve whose base came back from the host rung
        if "inp" in first:
            return solve(req, cache)
        before = WORKING_SET.status()["restages"].get("host", 0)
        captured = []
        launch = bk.binpack

        def capture(inp, *args):
            captured.append((inp, bk.route_of(inp, *args)))
            return launch(inp, *args)

        bk.binpack = capture
        try:
            resp = solve(req, cache)
        finally:
            bk.binpack = launch
        if WORKING_SET.status()["restages"].get("host", 0) > before:
            first["inp"] = captured[0]
        return resp

    for name, worlds in DENSITY.lines.items():
        deepest = name == "f25"
        for kind in bk.LAUNCHES:
            bk.LAUNCHES[kind] = 0
        rate, digests, ladder = density_arm(
            streams, SolveRequest, capturing if deepest else solve, make,
            WORKING_SET, worlds, world)
        assert digests == ref_digests, f"{name} != the unbudgeted arm"
        lines[name] = (rate, ladder, dict(bk.LAUNCHES))
    print(f"tenant density (config #21) [{card}]: {DENSITY.n_tenants} "
          f"tenants, {DENSITY.n_nodes}-node worlds of {world} B, "
          f"{DENSITY.n_pods}-pod bursts, {DENSITY_TIMED} timed rounds; "
          f"every (tenant, round) placement and used_req at f100, f50 and "
          f"f25 == the unbudgeted arm; a host-rung demotion freed {freed} B "
          f"of torch.cuda.memory_allocated(); pods/s unbudgeted "
          f"{ref_rate:.1f}, " + ", ".join(
              f"{n} {r:.1f} ({lad['demotions']} demotions, "
              f"{lad['restages']} restages, {lad['resident_device']} "
              f"resident)" for n, (r, lad, _) in lines.items()), flush=True)
    inp, route = first["inp"]
    assert route.kind == "block", route
    stats = compare(inp, f"a host-rung tenant's first solve after its "
                    f"restage (config #21), {DENSITY.n_nodes} x "
                    f"{inp.req.shape[0]}", card, reps=5)
    queued_line("a host-rung tenant's first solve", inp, stats, card)
    return entry("binpack_workingset_restage", lines["f25"][2]["block"],
                 stats, 93)


def slo_card(card) -> None:
    """Phase 16 (c): config #20's controller arm at each regime on the
    card and on the CPU, fake clock."""
    def ns(device):
        return types.SimpleNamespace(
            APIServer=APIServer, Kind=Kind, wire_scheduler=wire_scheduler,
            Scheduler=Scheduler, model=lambda: PlacementModel(device=device),
            PodTimelines=PodTimelines, StreamingLoop=StreamingLoop,
            StreamingConfig=StreamingConfig,
            ServingSLOController=slo.ServingSLOController,
            SLOSpec=slo.SLOSpec, NodeSpec=ttypes.NodeSpec,
            NodeMetric=ttypes.NodeMetric, ResourceName=ResourceName,
            trace_pods=trace_pods)

    base = diurnal_trace(seed=SLO.seed, duration_s=SLO.duration_s,
                         rate_pods_per_s=SLO.rate)
    for regime in sorted(REGIMES):
        trace = regime_scale(base, regime)
        t0 = time.perf_counter()
        on_card = slo_arm(ns(None), trace, SLO.start_deadlines, True)
        wall = time.perf_counter() - t0
        on_cpu = slo_arm(ns("cpu"), trace, SLO.start_deadlines, True)
        replayed = slo.replay_decisions(
            slo.SLOSpec(ls=SLO.target_s), on_card["observations"],
            base_deadlines=SLO.start_deadlines, **SLO.ctl_params)
        assert on_card["attained"], (regime, on_card["final_ls_p99_s"])
        assert 1 <= on_card["decisions"] <= 12, on_card["decisions"]
        assert replayed == on_card["decisions_log"], "replay differs"
        assert on_card["decisions_log"] == on_cpu["decisions_log"], \
            "decision log != the CPU run's"
        assert on_card["capacity_shed"] == 0
        print(f"SLO convergence (config #20), {regime} [{card}]: "
              f"{SLO.n_nodes} nodes, {len(trace)} pods over "
              f"{trace.duration_s:.2f} s, target ls p99 "
              f"{SLO.target_s * 1e3:.1f} ms: final ls p99 "
              f"{on_card['final_ls_p99_s'] * 1e3:.3f} ms (attained), "
              f"{on_card['decisions']} decisions, final deadlines "
              f"{on_card['final_lane_deadline_s']}, {on_card['rounds']} "
              f"rounds; replay == the log bit for bit; log == the CPU "
              f"run's; wall {wall:.2f} s", flush=True)


def failure_domain(card) -> list:
    """Phase 16. Returns its three ``kernels`` entries."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="koord-phase16-")
    sockets = Sockets()
    try:
        FLIGHT.reset()
        FLIGHT.configure(dump_dir=os.path.join(work, "flight"),
                         min_interval_s=0.0)
        entries = outage_churn_card(card, sockets)
        entries.append(density_card(card))
        oom_absorbed(card)
        slo_card(card)
    finally:
        sockets.close()
        shutil.rmtree(work, ignore_errors=True)
    print(f"failure domain phase wall {time.perf_counter() - t0:.2f} s",
          flush=True)
    return entries


def aggregated_world():
    """Phase 3's world with seeded percentiles on every metric."""
    snap, _ = testing.churn_world(NODES, assigned_per_node=ASSIGNED_PER_NODE,
                                  seed=42)
    testing.add_pending_wave(snap, PENDING, n_quota=QUOTAS, n_gangs=GANGS,
                             gang_size=GANG_SIZE, seed=7)
    return plugin_chain.add_aggregated_usage(snap, seed=AGG_SEED)


def aggregated_config(score_pct) -> SchedulerConfig:
    """Phase 17's aggregated scheduler; its rounds hold the kernel, so the
    host cutoff is pinned at 0."""
    return SchedulerConfig(
        feature_gates=NO_PREEMPTION, aggregated_usage_thresholds=AGG_THRESHOLDS,
        aggregated_usage_pct=AGG_USAGE_PCT, aggregated_score_pct=score_pct,
        host_fallback_cells=0)


def aggregated_rounds(card) -> list:
    """Phase 17 (a): the aggregated round at the main path's width, for
    each score percentile, against the unaggregated round on the same
    world. Returns its ``kernels`` entries."""
    world = aggregated_world()
    plain = build_scheduler(SchedulerConfig(feature_gates=NO_PREEMPTION,
                                            host_fallback_cells=0))
    testing.feed_scheduler(plain, world)
    unaggregated = plain.schedule_pending(now=20.0)
    entries = []
    for pct in AGG_SCORE_PCTS:
        label = (f"aggregated round, filter p{AGG_USAGE_PCT}, score p{pct}, "
                 f"{NODES} x {PENDING}")
        sched = build_scheduler(aggregated_config(pct))
        testing.feed_scheduler(sched, world)
        result, launches, wall, captured = drive(
            lambda: sched.schedule_pending(now=20.0))
        inp, route = routed(label, launches, captured, "cluster")
        capacity_ok(world, result)
        arrays = sched.model.staged_cache.arrays
        negative = int((arrays.est_extra < 0).any(axis=1).sum())
        assert negative > 0 if pct < AGG_USAGE_PCT else True, negative
        committed = sum(n is not None for n in result.values())
        differ = sum(result.get(u) != n for u, n in unaggregated.items())
        assert committed > 0 and differ > 0, (committed, differ)
        print(f"{label} [{card}]: {committed} committed, "
              f"{len(result.waiting)} waiting; wall {wall:.4f} s; "
              f"{negative} node rows with a negative est_extra; route "
              f"{route_name(route)}; launches {launches[route.kind]}",
              flush=True)
        print(f"{label}: the placements of {differ} of {len(unaggregated)} "
              f"pods differ from the unaggregated round on the same world "
              f"(phase 3's): the mode took effect", flush=True)
        stats = compare_cut(inp, label, card, reps=3)
        entries.append(entry(f"binpack_aggregated_score_p{pct}",
                             launches[route.kind], stats, 317))
    return entries


def aggregated_churn(card) -> dict:
    """Phase 17 (a): bench config #9 in the aggregated mode (filter p99,
    score p50), AGG_CHURN_TICKS ticks through two Schedulers fed the same
    events, one with the staging cache, one restaging in full every tick:
    equal placements and equal staged worlds every tick. Returns its
    ``kernels`` entry."""
    snap, _ = testing.churn_world(CHURN_NODES, assigned_per_node=2, seed=42)
    plugin_chain.add_aggregated_usage(snap, seed=AGG_SEED)
    config = aggregated_config(AGG_SCORE_PCTS[-1])
    delta, full = build_scheduler(config), build_scheduler(config)
    for sched in (delta, full):
        testing.feed_scheduler(sched, snap)
    rng, agg_rng = np.random.default_rng(7), np.random.default_rng(AGG_SEED)
    launches_delta, last_inp, walls = 0, None, []
    for t in range(AGG_CHURN_TICKS):
        now = 20.0 + t
        testing.feed_churn_tick((delta, full), snap, rng, dirty=CHURN_DIRTY,
                                pending=CHURN_PENDING, t=t, now=now,
                                aggregated_rng=agg_rng)
        full.model.reset_staging()
        results = {}
        for name, sched in (("delta", delta), ("full", full)):
            result, launches, wall, captured = drive(
                lambda: sched.schedule_pending(now=now))
            inp, route = routed(f"aggregated churn tick {t}, {name}",
                                launches, captured, "cluster")
            results[name] = result
            if name == "delta":
                launches_delta += launches[route.kind]
                last_inp = inp
                walls.append(wall)
        assert delta.model.last_staging == ("full" if t == 0 else "delta")
        assert full.model.last_staging == "full"
        same_round(results["delta"], results["full"],
                   f"aggregated churn tick {t}")
        for f in STAGED_NODE_FIELDS:
            assert torch.equal(getattr(delta.model.staged_cache.state, f),
                               getattr(full.model.staged_cache.state, f)), \
                f"aggregated churn tick {t}: delta != full on {f}"
    print(f"aggregated churn ticks [{card}]: {CHURN_NODES} nodes, "
          f"{CHURN_DIRTY} metrics with percentiles + {CHURN_PENDING} pending "
          f"per tick, {AGG_CHURN_TICKS} ticks: delta == full restage every "
          f"tick (placements and every staged field); delta tick walls "
          f"{spread(walls, '{:.4f}')} s", flush=True)
    stats = compare(last_inp, f"aggregated churn tick, {CHURN_NODES} x "
                    f"{CHURN_PENDING}", card, reps=5)
    return entry("binpack_aggregated_churn_tick", launches_delta, stats, 317)


def chain_world(now):
    return testing.build_snapshot(
        plugin_chain.chain_world_spec(
            n_nodes=CHAIN_NODES, n_pending=CHAIN_PENDING,
            n_quota=CHAIN_QUOTAS, n_resv=CHAIN_RESV, now=now),
        ttypes, ResourceName)


def chain_parity(card) -> dict:
    """Phase 17 (b): the batched round on the card against the plugin
    chain (``BatchedPlacement=false`` through ``run_loop(once=True)``) on
    the chain world. Returns its ``kernels`` entry."""
    now = time.time()
    batched = Scheduler(model=PlacementModel())
    testing.feed_scheduler(batched, chain_world(now))
    result, launches, wall, captured = drive(
        lambda: batched.schedule_pending(now=time.time()))
    inp, route = routed("chain parity, batched round", launches, captured,
                        "block")
    chain = build_scheduler(SchedulerConfig(
        feature_gates="BatchedPlacement=false"))
    assert not chain.batched_placement
    testing.feed_scheduler(chain, chain_world(now))
    lines = []
    t0 = time.perf_counter()
    assert run_loop(chain, SchedulerConfig(), once=True,
                    log=lines.append) == 0
    chain_wall = time.perf_counter() - t0
    # the part of a chain cycle that is its one lower_nodes (node_view),
    # timed alone on the world the round left
    after = chain.cache.snapshot(now=time.time())
    t0 = time.perf_counter()
    lower_nodes(after, **chain.model.lowering_kwargs())
    lower_wall = time.perf_counter() - t0
    # the batched round's decisions == the chain's placements; then its
    # PostFilter may evict pods it placed in this very round (a
    # lower-priority pod of the preemptor's quota group), which the chain,
    # placing in priority order, never meets: the JAX package's two
    # paths differ the same way (tests/test_torch_framework.py)
    got = {u: p.node_name for u, p in chain.cache.pods.items()}
    decided = {u: n for u, n in result.items() if n is not None}
    want = {u: p.node_name for u, p in batched.cache.pods.items()
            if u not in result}
    want.update(decided)
    assert got == want, "plugin chain != batched round"
    evicted = set(got) - set(batched.cache.pods)
    assert evicted <= set(decided)
    assert {got[u] for u in evicted} <= set(result.nominations.values())
    assert set(chain.cache.pending) == set(batched.cache.pending) - evicted
    resv = {r.name: (dict(r.allocated), list(r.allocated_pod_uids))
            for r in chain.cache.reservations.values()}
    consumed = sum(len(v[1]) for v in resv.values())
    committed = len(decided)
    assert committed > 0 and consumed > 0, (committed, consumed)
    print(f"chain parity [{card}]: {CHAIN_NODES} nodes, {CHAIN_PENDING} "
          f"pending ({CHAIN_QUOTAS} quota groups, {CHAIN_RESV} reservations): "
          f"batched round == plugin chain ({committed} placed, {consumed} "
          f"consumed a reservation); the batched round's PostFilter then "
          f"nominated {len(result.nominations)} and evicted {len(evicted)} "
          f"of its own placements, as the JAX package's does; batched wall "
          f"{wall:.4f} s on route {route_name(route)}; chain wall "
          f"{chain_wall:.4f} s = {chain_wall / CHAIN_PENDING * 1e3:.3f} ms "
          f"per pod, of which one lower_nodes of the world after the round "
          f"{lower_wall * 1e3:.3f} ms; {lines[-1]}", flush=True)
    stats = compare(inp, f"chain parity, {CHAIN_NODES} x {CHAIN_PENDING}",
                    card, reps=5)
    return entry("binpack_chain_parity", launches[route.kind], stats, 205)


def explainer(card) -> None:
    """Phase 17 (c): PlacementExplainer on the card for EXPLAIN_PODS pods
    of the chain world without a reservation owner, each against the
    chain's cycle and the CPU columns; then one ``explain_scores`` at the
    main path's width."""
    now = time.time()
    sched = build_scheduler(SchedulerConfig(
        feature_gates="BatchedPlacement=false"))
    sched.debug.dump_scores = True
    testing.feed_scheduler(sched, chain_world(now))
    cpu_model = PlacementModel(device="cpu")
    explain = PlacementExplainer(sched)
    uids = [p.uid for p in sched.cache.pending.values()
            if not p.labels][:EXPLAIN_PODS]
    bound = refused = 0
    t0 = time.perf_counter()
    for uid in uids:
        at = time.time()
        payload = explain.explain(uid, now=at)
        snapshot = sched.cache.snapshot(now=at)
        pod = sched.cache.pending[uid]
        _, on_card = explain_scores(sched.model, snapshot, pod)
        _, on_cpu = explain_scores(cpu_model, snapshot, pod)
        for name, col in on_cpu.items():
            assert np.array_equal(on_card[name], col), (uid, name)
        outcome = sched.schedule_one(uid, now=at)
        if payload["verdicts"].get("quota_admitted") is False:
            assert outcome.status == "unschedulable", outcome
            refused += 1
            continue
        assert payload["winner"] == outcome.node, (uid, payload["winner"],
                                                   outcome.node)
        scores = sched.debug.scores[-1]["scores"]
        for detail in payload["top_nodes"]:
            if detail["feasible"]:
                assert detail["scores"]["weighted_total"] == \
                    scores[detail["node"]], (uid, detail["node"])
        bound += outcome.status == "bound"
    wall = time.perf_counter() - t0
    assert bound > 0
    print(f"explainer [{card}]: {len(uids)} pods of the chain world: winner "
          f"== schedule_one's node ({bound} bound, {refused} refused by "
          f"quota, as the verdict says), weighted totals == the chain's "
          f"scores, columns == the CPU run; {wall:.3f} s for the "
          f"{len(uids)} explains and cycles", flush=True)
    snapshot = aggregated_world()
    wide = build_scheduler(aggregated_config(AGG_SCORE_PCTS[0])).model
    pod = snapshot.pending_pods[0]
    t0 = time.perf_counter()
    arrays, cols = explain_scores(wide, snapshot, pod)
    wall = time.perf_counter() - t0
    assert len(cols["weighted_total"]) == arrays.n == NODES
    t0 = time.perf_counter()
    lower_nodes(snapshot, **wide.lowering_kwargs())
    lower_wall = time.perf_counter() - t0
    print(f"explain_scores at {NODES} nodes, aggregated [{card}]: wall "
          f"{wall:.4f} s (lowering, staging, the breakdown, one read-back); "
          f"its lower_nodes alone {lower_wall:.4f} s; "
          f"{int(cols['fit_feasible'].sum())} nodes fit, "
          f"{int(cols['loadaware_feasible'].sum())} pass LoadAware",
          flush=True)


def plugin_chain_phase(card) -> list:
    """Phase 17. Returns its ``kernels`` entries."""
    t0 = time.perf_counter()
    entries = aggregated_rounds(card)
    entries.append(aggregated_churn(card))
    entries.append(chain_parity(card))
    explainer(card)
    print(f"plugin chain phase wall {time.perf_counter() - t0:.2f} s",
          flush=True)
    return entries


def binaries_world(path, pending=True) -> dict:
    """Phase 18's cluster-spec JSON at ``path`` (the main path's width):
    NODES nodes of 32-64 cores and 64-256 GiB, BIN_ASSIGNED running pods a
    node and, with ``pending``, PENDING pending pods, seeded. Returns the
    spec."""
    rng = np.random.default_rng(BIN_SEED)
    cpu = rng.integers(32, 65, NODES) * 1000
    mem = rng.integers(64, 257, NODES) * 1024
    spec = {"nodes": [{"name": f"n{i}", "cpu": int(cpu[i]),
                       "memory": int(mem[i])} for i in range(NODES)],
            "pods": []}
    a_cpu = rng.integers(500, 4000, (NODES, BIN_ASSIGNED))
    a_mem = rng.integers(512, 8192, (NODES, BIN_ASSIGNED))
    for i in range(NODES):
        for k in range(BIN_ASSIGNED):
            spec["pods"].append({"name": f"a{i}-{k}", "cpu": int(a_cpu[i, k]),
                                 "memory": int(a_mem[i, k]),
                                 "node": f"n{i}"})
    p_cpu = rng.integers(100, 4000, PENDING)
    p_mem = rng.integers(128, 8192, PENDING)
    if pending:
        spec["pods"] += [{"name": f"p{j}", "cpu": int(p_cpu[j]),
                          "memory": int(p_mem[j])} for j in range(PENDING)]
    with open(path, "w") as f:
        json.dump(spec, f)
    return spec


def wired_binary(path, device=None, config=None):
    """What ``cmd.scheduler.main`` wires, in this process: ``(bus,
    scheduler)`` with the bus seeded from ``path``."""
    bus = APIServer()
    sched = build_scheduler(config or SchedulerConfig(), device=device)
    wire_scheduler(bus, sched)
    seed_bus_from_json(bus, path)
    return bus, sched


def seconds_after(line, key) -> float:
    return float(line.split(key, 1)[1].split(" s", 1)[0])


def scheduler_binary(card, path):
    """Phase 18 (a): ``python -m koordinator_tpu_torch.cmd.scheduler
    --once --cluster-json`` as a child on the card, then the same round in
    this process, its kernel held against the twin. Returns ``(kernels
    entry, bus, scheduler)``."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "koordinator_tpu_torch.cmd.scheduler",
         "--once", "--cluster-json", path, "--device", CHILD_DEVICE],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # each line stamped as it arrives (main flushes its own two)
    stamped = [(time.perf_counter(), line.rstrip("\n"))
               for line in proc.stdout]
    rc = proc.wait(timeout=BINARY_TIMEOUT_S)
    child_wall = time.perf_counter() - t0
    lines = [line for _, line in stamped]
    assert rc == 0, lines[-40:]
    child_round = next(x for x in lines if x.startswith("round:"))
    wired_at, wired = next((t, x) for t, x in stamped
                           if x.startswith("koord-scheduler: wired"))
    ended_at, ended = next((t, x) for t, x in stamped
                           if x.startswith("koord-scheduler: loop returned"))
    wired_s, library_s = (seconds_after(wired, " in "),
                          seconds_after(wired, "kernel library "))
    probe_s = seconds_after(wired, "host cutoff probe ")
    seeding_s = seconds_after(wired, "bus seeding ")
    round_s = seconds_after(ended, " after ")
    start_s = wired_at - t0 - wired_s
    exit_s = t0 + child_wall - ended_at
    bus, sched = wired_binary(path)
    logs = []
    rc, launches, wall, captured = drive(lambda: run_loop(
        sched, SchedulerConfig(), once=True, log=logs.append))
    assert rc == 0, rc
    inp, route = routed("the scheduler binary's round", launches, captured,
                        "cluster")
    assert route.shards == 5, route
    assert logs[-1] == child_round, (logs[-1], child_round)
    placed = int(child_round.split()[1].split("/")[0])
    assert placed > 0
    print(f"scheduler binary --once [{card}]: {NODES} nodes, {PENDING} "
          f"pending, {NODES * BIN_ASSIGNED} running: '{child_round}' == the "
          f"in-process round (build_scheduler + wire_scheduler + "
          f"seed_bus_from_json + run_loop(once=True)); child wall "
          f"{child_wall:.3f} s = interpreter start and imports "
          f"{start_s:.3f} s + wiring {wired_s:.3f} s (kernel library load "
          f"{library_s:.3f} s, the host cutoff probe {probe_s:.3f} s, bus "
          f"seeding {seeding_s:.3f} s; the rest is the scheduler's build, "
          f"the bus, the elector and the auditor) + "
          f"the round {round_s:.3f} s + the rest, process exit included "
          f"{child_wall - start_s - wired_s - round_s:.3f} s (exit alone "
          f"{exit_s:.3f} s); in-process round "
          f"wall {wall:.4f} s, route {route_name(route)}, launches "
          f"{launches[route.kind]}", flush=True)
    stats = compare(inp, "the scheduler binary's round", card, reps=3)
    return (entry("binpack_scheduler_main", launches[route.kind], stats,
                  317), bus, sched)


def pods_on_bus(bus, prefix):
    return {p.uid: p.node_name for p in bus.list(Kind.POD).values()
            if p.name.startswith(prefix)}


def audit_arrivals(bus, tag) -> None:
    """AUDIT_ARRIVALS pending pods named ``<tag>-<j>``, seeded by the
    tag."""
    rng = np.random.default_rng([BIN_SEED, *tag.encode()])
    for j in range(AUDIT_ARRIVALS):
        pod = ttypes.PodSpec(name=f"{tag}-{j}", requests={
            ResourceName.CPU: int(rng.integers(100, 4000)),
            ResourceName.MEMORY: int(rng.integers(128, 8192))})
        bus.apply(Kind.POD, pod.uid, pod)


def audit_rounds(sched, bus, rounds, auditor=None):
    """``rounds`` of ``run_loop`` (no sleeps) after AUDIT_ARRIVALS new
    pods; returns the loop's log."""
    logs = []
    assert run_loop(sched, SchedulerConfig(schedule_interval_seconds=0.0),
                    max_rounds=rounds, auditor=auditor, log=logs.append,
                    sleep_fn=lambda s: None) == 0
    return logs


def auditor_phase(card, path, sched, bus) -> None:
    """Phase 18 (b): the auditor in ``run_loop`` on (a)'s scheduler: a
    clean sweep after the kernel round (its probe read back from the
    card), then one staged CUDA row drifted, detected, restaged, and the
    next round equal to a clean run's; a sweep timed at NODES nodes."""
    aud = StateAuditor(sched, bus, interval_rounds=1, probe_rows=AUDIT_PROBE)
    reports = []
    on_round = aud.on_round

    def recorded(now=None):
        reports.append(on_round(now=now))
        return reports[-1]

    aud.on_round = recorded
    audit_arrivals(bus, "b1")
    audit_rounds(sched, bus, 3, aud)
    state = sched.model.staged_cache.audit_view()[1]
    assert state.usage.is_cuda or CHILD_DEVICE == "cpu"
    first = reports[0]
    # the round's binds left their rows dirty (skipped until restaged)
    assert first["probe_rows"], first
    assert len(first["probe_rows"]) + first["probe_skipped"] == AUDIT_PROBE
    assert all(r["detections"] == {} for r in reports), reports
    # one staged CUDA row drifts, its host row untouched
    cache = sched.model.staged_cache
    arrays, state, _, _, _ = cache.audit_view()
    j = aud._probe_cursor
    name = arrays.names[j]
    host_before = arrays.usage[j].copy()
    state.usage[j, 0] += 777
    torch.cuda.synchronize()
    assert (arrays.usage[j] == host_before).all()
    audit_arrivals(bus, "b2")
    audit_rounds(sched, bus, 1, aud)
    drift = reports[-1]
    assert drift["detections"] == {"device-parity/staged-device-drift": 1}, \
        drift["detections"]
    assert drift["probe_mismatches"] == [f"{name}:device:usage"], drift
    assert drift["repairs"] == {"full-restage": 1}, drift["repairs"]
    assert sched.model.last_staging == "full", sched.model.last_staging
    clean_bus, clean = wired_binary(path)
    assert run_loop(clean, SchedulerConfig(), once=True,
                    log=lambda *a: None) == 0
    for tag, rounds in (("b1", 3), ("b2", 1)):
        audit_arrivals(clean_bus, tag)
        audit_rounds(clean, clean_bus, rounds)
        assert pods_on_bus(clean_bus, tag) == pods_on_bus(bus, tag), tag
    placed = sum(n is not None for n in pods_on_bus(bus, "b2").values())
    assert placed > 0
    timed = aud.sweep("manual")
    full = StateAuditor(sched, bus, interval_rounds=0,
                        probe_rows=NODES).sweep("manual")
    assert timed["detections"] == {} and full["detections"] == {}
    print(f"auditor [{card}]: run_loop(auditor=StateAuditor(interval_rounds"
          f"=1, probe_rows={AUDIT_PROBE})): the sweep after the kernel round "
          f"clean, {len(first['probe_rows'])} staged rows read back from the "
          f"card in {first['readback_s'] * 1e3:.3f} ms "
          f"({first['probe_skipped']} bind-dirty rows skipped); {name}'s "
          f"staged CUDA "
          f"usage row drifted (host row untouched): detected as "
          f"{drift['probe_mismatches'][0]}, full restage, the next round "
          f"({placed}/{AUDIT_ARRIVALS} placed) == a clean run's; a sweep at "
          f"{NODES} nodes: {AUDIT_PROBE} probe rows {timed['duration_s'] * 1e3:.3f}"
          f" ms, the read-back {timed['readback_s'] * 1e3:.3f} ms "
          f"({timed['readback_s'] / timed['duration_s'] * 100:.1f}%); all "
          f"{NODES} rows {full['duration_s'] * 1e3:.3f} ms, the read-back "
          f"{full['readback_s'] * 1e3:.3f} ms "
          f"({full['readback_s'] / full['duration_s'] * 100:.1f}%)",
          flush=True)


def hot_metrics(bus, spec, hot, now, cpu_share=0.8):
    """A NodeMetric on every node of ``spec``: the first ``hot`` nodes at
    ``cpu_share`` of their CPU (their pods' usage their requests), the
    rest at 20%."""
    pods_of = {}
    for p in spec["pods"]:
        if "node" in p:
            pods_of.setdefault(p["node"], []).append(p)
    cpu, mem = ResourceName.CPU, ResourceName.MEMORY
    for i, n in enumerate(spec["nodes"]):
        share = cpu_share if i < hot else 0.2
        usages = {}
        if i < hot:
            usages = {f"default/{p['name']}": {cpu: p["cpu"],
                                               mem: p["memory"]}
                      for p in pods_of.get(n["name"], ())}
        bus.apply(Kind.NODE_METRIC, n["name"], ttypes.NodeMetric(
            node_name=n["name"], node_usage={
                cpu: int(n["cpu"] * share), mem: int(n["memory"] * 0.2)},
            update_time=now, pod_usages=usages))


def desched_arm(spec, path, device):
    """Phase 18 (c)'s migrations on ``device``: a scheduler and a
    ``DeschedulerLoop`` (``build_descheduler``'s default config) on one
    bus, DESCHED_HOT nodes over the high threshold, as many cycles as the
    anomaly debounce needs (a node is anomalous after strictly more than
    ``anomaly_condition_count`` abnormal observations), then the
    scheduler's round. Returns ``(record, probe
    kernel inputs, launches, cycles' wall)``."""
    t0 = 1000.0
    bus, sched = wired_binary(path, device,
                              SchedulerConfig(feature_gates=NO_PREEMPTION))
    hot_metrics(bus, spec, DESCHED_HOT, t0)
    config = desched_cmd.DeschedulerConfig()
    loop = wire_descheduler(bus, desched_cmd.build_descheduler(config),
                            device=device)
    migrated = []

    def cycles():
        for c in range(config.anomaly_condition_count + 1):
            migrated.append(loop.run_once(now=t0 + 1.0 + c))

    _, launches, wall, captured = drive(cycles)
    resv = {r.name: (r.node_name, r.state.name, list(r.owner_pod_uids))
            for r in bus.list(Kind.RESERVATION).values()}
    jobs = {j.name: (j.pod_uid, j.phase.name)
            for j in bus.list(Kind.MIGRATION_JOB).values()}
    out = sched.schedule_pending(now=t0 + 10.0)
    record = dict(migrated=migrated, reservations=resv, jobs=jobs,
                  round=dict(out),
                  pods={p.uid: p.node_name
                        for p in bus.list(Kind.POD).values()})
    return record, captured, launches, wall


def descheduler_phase(card, path, desched_path, spec) -> dict:
    """Phase 18 (c): ``cmd/descheduler.main --once`` on (a)'s file, then
    the migrations on the card against the CPU, each probe's kernel ==
    its twin. Returns the probes' ``kernels`` entry."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(out):
        assert desched_cmd.main(["--once", "--cluster-json", path]) == 0
    main_wall = time.perf_counter() - t0
    cycle_line = out.getvalue().splitlines()[-1]
    assert cycle_line == "descheduling cycle: migrated 0 pods", cycle_line
    card_rec, captured, launches, wall = desched_arm(spec, desched_path, None)
    cpu_rec, _, _, cpu_wall = desched_arm(spec, desched_path, "cpu")
    assert card_rec == cpu_rec, "descheduler: cuda != cpu"
    migrated = [u for cycle in card_rec["migrated"] for u in cycle]
    assert 0 < len(migrated) <= 2 * DESCHED_HOT, migrated
    by_owner = {owners[0]: node for node, _, owners
                in card_rec["reservations"].values() if owners}
    for uid in migrated:
        assert card_rec["round"][uid] == by_owner[uid], uid
    err = 0
    for inp, route in captured:
        err = max(err, max_abs_err(bk.binpack(inp), twin(inp, route)))
    routes = Counter(route_name(route) for _, route in captured)
    assert sum(launches.values()) == len(captured) == len(migrated)
    print(f"descheduler binary --once [{card}]: '{cycle_line}' (empty usage "
          f"metrics), wall {main_wall:.3f} s; descheduler loop, {NODES} nodes, "
          f"{DESCHED_HOT} over LowNodeLoad's high threshold, "
          f"{len(card_rec['migrated'])} cycles: {len(migrated)} migrated "
          f"(cycle by cycle {[len(c) for c in card_rec['migrated']]}), cuda == "
          f"cpu (migrated uids, reservations' nodes, jobs' phases, the bus's "
          f"pods after the scheduler's round); every evicted pod placed on its "
          f"reserved node; {len(captured)} probe solves, each kernel == twin "
          f"(max_abs_err {err}), routes {dict(routes)}; cycles wall "
          f"{wall:.3f} s on the card, {cpu_wall:.3f} s on the CPU", flush=True)
    inp, _ = captured[-1]
    stats = compare(inp, "a descheduler probe", card, reps=5)
    queued_line("a descheduler probe", inp, stats, card)
    stats["max_abs_err"] = max(stats["max_abs_err"], err)
    line = 205 if "resv" in stats["variant"] else 317
    return entry("binpack_descheduler_probe", len(captured), stats, line)


def rebalance_in_loop(card, spec, sched, bus) -> dict:
    """Phase 18 (d): ``run_loop`` with ``build_rebalance_plugin`` at
    ``rebalance_backend="verify"`` over REBAL_LOOP_ROUNDS rounds of (a)'s
    world (REBAL_LOOP_HOT nodes hot): every sweep's kernel decision stream
    == the host walk (the backend asserts it). Returns its ``kernels``
    entry."""
    hot_metrics(bus, spec, REBAL_LOOP_HOT, time.time(), cpu_share=0.85)
    config = SchedulerConfig(schedule_interval_seconds=0.0,
                             rebalance_interval_s=1e-6,
                             rebalance_backend="verify")
    plugin = build_rebalance_plugin(config)
    made = []
    base = loadaware.DeviceSweep

    class Recorded(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    loadaware.DeviceSweep = Recorded
    logs = []
    try:
        zero_launches()
        t0 = time.perf_counter()
        assert run_loop(sched, config, max_rounds=REBAL_LOOP_ROUNDS,
                        rebalance=plugin, log=logs.append,
                        sleep_fn=lambda s: None) == 0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(rb.LAUNCHES)
    finally:
        loadaware.DeviceSweep = base
    evicted = [int(x.split()[2]) for x in logs if x.startswith("rebalance:")]
    assert evicted and evicted[0] > 0, logs
    assert launches["rebalance_scan"] >= len(made) >= 1, (launches, len(made))
    print(f"in-loop rebalance, verify backend [{card}]: {REBAL_LOOP_ROUNDS} "
          f"rounds of {NODES} nodes ({REBAL_LOOP_HOT} hot): the sweep kernel "
          f"== the host walk every pass; evicted {evicted} pods; "
          f"{len(made)} sweeps staged, launches {launches}; loop wall "
          f"{wall:.3f} s", flush=True)
    return sweep_entry("rebalance_scan_in_loop", made[0],
                       launches["rebalance_scan"],
                       "the in-loop rebalance's first sweep", card)


def binaries(card) -> list:
    """Phase 18. Returns its ``kernels`` entries."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cluster.json")
        spec = binaries_world(path)
        desched_path = os.path.join(d, "running.json")
        binaries_world(desched_path, pending=False)
        main_entry, bus, sched = scheduler_binary(card, path)
        auditor_phase(card, path, sched, bus)
        probe_entry = descheduler_phase(card, path, desched_path, spec)
        sweep = rebalance_in_loop(card, spec, sched, bus)
    print(f"binaries phase wall {time.perf_counter() - t0:.2f} s", flush=True)
    return [main_entry, probe_entry, sweep]

# -- 19. the host route for tiny solves ------------------------------------------

def example_snapshot(n_nodes, n_pods, seed):
    """``testing.example_problem``'s seeded world (allocatable, usage and
    requests) as a ClusterSnapshot without a tracker."""
    nodes, pods, _ = testing.example_problem_arrays(n_nodes, n_pods, seed)
    cpu, mem = ResourceName.CPU, ResourceName.MEMORY

    def res(row):
        return {cpu: int(row[cpu]), mem: int(row[mem])}

    return ClusterSnapshot(
        nodes=[ttypes.NodeSpec(name=f"n{i}", allocatable=res(a))
               for i, a in enumerate(nodes["alloc"])],
        node_metrics={f"n{i}": ttypes.NodeMetric(
            node_name=f"n{i}", node_usage=res(u), update_time=19.0)
            for i, u in enumerate(nodes["usage"])},
        pending_pods=[ttypes.PodSpec(name=f"p{j}", requests=res(r))
                      for j, r in enumerate(pods["req"])],
        now=20.0)


def probe_phase(card):
    """Phase 19 (a): ``measure_host_fallback_cells()`` on the card, measured
    afresh (phase 18's build memoised it) with the launch counts zeroed:
    the host's ns per cell, the device round's best, the cutoff and the
    probe's wall. Returns ``(cutoff, kernels entry)``."""
    placement.HOST_PROBES.clear()
    cells, launches, wall, captured = drive(
        placement.measure_host_fallback_cells)
    rec = placement.host_probe()
    inp, route = captured[0]
    assert len(captured) == sum(launches.values()) == launches[route.kind]
    print(f"host cutoff probe [{card}]: the host route "
          f"{rec['host_ns_per_cell']:.1f} ns per cell (schedule_vectorized "
          f"on example_problem(64, 128), "
          f"best of 5), the device round {rec['device_best_ms']:.4f} ms "
          f"(route {route_name(route)}, launch + read-back of assign, best of "
          f"5): cutoff {cells} cells; probe wall {rec['wall_s']:.3f} s; "
          f"launches {launches[route.kind]}", flush=True)
    stats = compare(inp, "the probe's device round, 64 x 128", card, reps=5)
    return cells, entry("binpack_host_probe_round", launches[route.kind],
                        stats, 317)


def best_ms(fn):
    times = []
    for _ in range(HOST_REPS):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times) * 1e3


def crossover(card, cutoff):
    """Phase 19 (b): example worlds of HOST_WIDTHS nodes x HOST_PODS pods
    through a host-routed and a kernel-routed ``PlacementModel`` on the
    card: host == kernel == the kernel's plain twin on every shape, and
    each route's solve (the host route's oracle; the kernel's dispatch
    and read-back) timed, best of HOST_REPS back to back. The lowering is
    the same for both; the kernel's staging, which a host-routed round
    skips, is not counted. Prints, for each width, the largest cell count
    at which the host was faster. Returns its ``kernels`` entry (the
    widest shape timed)."""
    err, launches, widest = 0, 0, None
    for n in HOST_WIDTHS:
        faster = []
        for p in HOST_PODS:
            calls = {}
            out = {}
            # the host model's cutoff covers the shape (5,000 x 64 is
            # past 1<<18 cells)
            for name, cells, attr in (
                    ("host", max(1 << 18, n * p), "_host_solve"),
                    ("kernel", 0, "_dispatch_solve")):
                model = PlacementModel(host_fallback_cells=cells)
                solve = getattr(model, attr)

                def record(*args, _s=solve, _n=name, **kwargs):
                    calls[_n] = (args, kwargs, _s(*args, **kwargs))
                    return calls[_n][2]

                setattr(model, attr, record)
                result, launched, _, captured = drive(
                    lambda: model.schedule(example_snapshot(n, p, seed=n + p)))
                assert model.last_solver == name, model.last_solver
                launches += sum(launched.values())
                out[name] = (dict(result), solve, captured)
            assert out["host"][0] == out["kernel"][0], f"{n} x {p}"
            (inp, route), = out["kernel"][2]
            err = max(err, max_abs_err(bk.binpack(inp), twin(inp, route)))
            # the host route's SolveResult == the kernel's, bit for bit
            host, kernel = calls["host"][2], calls["kernel"][2]
            for f in ("assign", "commit", "raw_assign"):
                assert torch.equal(getattr(host, f),
                                   getattr(kernel, f).cpu()), f
            for f in ("used_req", "est_extra", "prod_base"):
                assert torch.equal(getattr(host.node_state, f), getattr(
                    kernel.node_state, f).cpu()), f
            times = {}
            for name in ("host", "kernel", "host", "kernel"):
                solve = out[name][1]
                args, kwargs, _ = calls[name]
                ms = best_ms(lambda: solve(*args, **kwargs).assign.cpu())
                times[name] = min(times.get(name, ms), ms)
            if times["host"] < times["kernel"]:
                faster.append(n * p)
            print(f"crossover {n} x {p} ({n * p} cells) [{card}]: host == "
                  f"kernel == twin (route {route_name(route)}); host "
                  f"{times['host']:.4f} ms, kernel + read-back "
                  f"{times['kernel']:.4f} ms", flush=True)
            widest = inp
        print(f"crossover at {n} nodes [{card}]: the host route was faster "
              f"up to {max(faster) if faster else 0} cells "
              f"(at {faster or 'no'} cells); the probe's cutoff {cutoff} "
              f"cells", flush=True)
    stats = compare(widest, f"crossover, {HOST_WIDTHS[-1]} x {HOST_PODS[-1]}",
                    card, reps=5)
    stats["max_abs_err"] = max(stats["max_abs_err"], err)
    return entry("binpack_host_crossover", launches, stats, 317)


def cutoff_ticks(card, cutoff):
    """Phase 19 (c): churn ticks of HOST_TICK_PODS pending pods at the main
    path's width through a default ``build_scheduler`` (the measured
    cutoff) and a scheduler pinned to the kernel, fed the same events:
    equal placements every tick, each tick's cells and route printed.
    When the cutoff is under the width, no tick can take the host route;
    the ticks are then repeated on config #11's 512-node world. Returns
    its ``kernels`` entry."""
    def arm(label, n_nodes, feed):
        default = build_scheduler(SchedulerConfig())
        pinned = build_scheduler(SchedulerConfig(host_fallback_cells=0))
        assert default.model.host_fallback_cells == cutoff
        feed((default, pinned))
        rng = np.random.default_rng(7)
        routes, launches, last = [], 0, None
        for t, k in enumerate(HOST_TICK_PODS):
            now = 20.0 + t
            testing.feed_churn_tick((default, pinned), snap_of[n_nodes], rng,
                                    dirty=CHURN_DIRTY, pending=k, t=t,
                                    now=now)
            cells = n_nodes * len(default.cache.pending)
            result, launched, wall, captured = drive(
                lambda: default.schedule_pending(now=now))
            same_round(result, pinned.schedule_pending(now=now),
                       f"{label} tick {t}")
            solver = default.model.last_solver
            assert (solver == "host") == (cells <= cutoff), (cells, solver)
            routes.append(f"{cells}:{solver}")
            launches += sum(launched.values())
            if captured:
                last = captured[-1]
        print(f"{label} [{card}]: ticks of {HOST_TICK_PODS} pending pods, "
              f"cells:route {routes}; every tick == the kernel-pinned "
              f"scheduler's; measured cutoff {cutoff} cells", flush=True)
        return launches, last

    snap_of = {}
    snap_of[NODES], _ = testing.churn_world(NODES, assigned_per_node=2,
                                            seed=42)
    launches, last = arm(f"cutoff ticks, {NODES} nodes", NODES,
                         lambda s: [testing.feed_scheduler(x, snap_of[NODES])
                                    for x in s])
    if cutoff < NODES:
        print(f"cutoff ticks: the cutoff ({cutoff} cells) is under one pod "
              f"at {NODES} nodes, so no tick routed to the host there; "
              f"repeating on config #11's {OUTAGE.n_nodes}-node world",
              flush=True)
        snap_of[OUTAGE.n_nodes], _ = testing.churn_world(
            OUTAGE.n_nodes, assigned_per_node=0, seed=42)
        more, _ = arm(f"cutoff ticks, config #11's {OUTAGE.n_nodes} nodes",
                      OUTAGE.n_nodes,
                      lambda s: [testing.feed_scheduler(
                          x, snap_of[OUTAGE.n_nodes]) for x in s])
        launches += more
    inp, route = last
    stats = compare(inp, f"cutoff tick, {NODES} x {HOST_TICK_PODS[-1]}",
                    card, reps=5)
    return entry("binpack_host_cutoff_tick", launches, stats, 317)


def chaos_drive(card):
    """Phase 19 (d): the kill-the-leader chaos drive (8 nodes, 24 ticks of
    4 pods, the leader killed at tick 10, a sweep every 4 rounds) with a
    seeded schedule over the three state faults planted in the standby,
    the host cutoff at CHAOS_HOST_CELLS on even ticks and 0 on odd ones,
    on the card and on the CPU: equal saboteur logs, auditor detections
    and repairs, per-tick placements and buses, and equal to the
    crash-free run; the staged-row desync wrote a CUDA row and its sweep
    reported it. Returns its ``kernels`` entry."""
    sabotage = chaos.state_fault_schedule(CHAOS_SEED).events
    desynced = []

    class Recorded(chaos.StateSaboteur):
        def _desync_staged_row(self):
            state = self.scheduler.model.staged_cache.audit_view()[1]
            name = super()._desync_staged_row()
            if name is not None:
                desynced.append((name, state.usage.device.type))
            return name

    def run(device, kill_leader=True, plan=sabotage):
        env = chaos.port_env()
        env.StateSaboteur = Recorded
        return chaos.drive_audited_cluster(
            env, CHAOS_SEED, kill_leader=kill_leader, sabotage=plan,
            make_model=lambda: PlacementModel(device=device),
            cutoff_of_tick=lambda t: 0 if t % 2 else CHAOS_HOST_CELLS)

    def record(out):
        log, bus, info = out
        status = info["aud_b"].status()
        arrays = lower_nodes(snapshot_from_bus(bus, now=200.0))
        return dict(
            log=log, saboteur=info["saboteur"].log,
            detections=status["detections"], repairs=status["repairs"],
            unrepaired=status["last"]["unrepaired"],
            solvers=info["solvers"],
            bus={f: getattr(arrays, f).tolist() for f in STAGED_NODE_FIELDS})

    t0 = time.perf_counter()
    out, launches, wall, captured = drive(lambda: run(None))
    assert [d for _, d in desynced] == [CHILD_DEVICE], desynced
    card_rec = record(out)
    cpu_rec = record(run("cpu"))
    free_log = run(None, kill_leader=False, plan={})[0]
    assert card_rec == cpu_rec, "chaos drive: cuda != cpu"
    assert card_rec["log"] == free_log, "chaos drive != crash-free run"
    assert card_rec["detections"].get(
        "device-parity/staged-device-drift", 0) >= 1, card_rec["detections"]
    assert card_rec["unrepaired"] == []
    solvers = Counter(card_rec["solvers"])
    assert solvers["host"] > 0 and solvers["kernel"] > 0, solvers
    assert sum(launches.values()) == len(captured) == solvers["kernel"]
    print(f"chaos drive [{card}]: seed {CHAOS_SEED}, faults "
          f"{sorted(sabotage.items())} into the standby, leader killed at "
          f"tick {chaos.KILL_TICK}; routes {dict(solvers)}; the desync wrote "
          f"{desynced[0][0]}'s staged {desynced[0][1]} row; detections "
          f"{card_rec['detections']}, repairs {card_rec['repairs']}; cuda == "
          f"cpu (saboteur log, detections, repairs, placements, bus) == "
          f"the crash-free run; card run wall {wall:.3f} s, phase "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    inp, _ = captured[-1]
    stats = compare(inp, "a chaos drive tick, 8 x 4", card, reps=5)
    return entry("binpack_chaos_drive_tick", len(captured), stats, 317)


def host_route(card) -> list:
    """Phase 19. Returns its ``kernels`` entries."""
    t0 = time.perf_counter()
    cutoff, probe_entry = probe_phase(card)
    entries = [probe_entry, crossover(card, cutoff),
               cutoff_ticks(card, cutoff), chaos_drive(card)]
    print(f"host route phase wall {time.perf_counter() - t0:.2f} s",
          flush=True)
    return entries


# -- 20. the wire under faults, the eviction storm, the manager binary -------

def wire_outage(card) -> dict:
    """Phase 20 (a): config #11 (512 nodes, 16 dirty and 32 pending a tick,
    40 ticks) through ``RemoteSolver`` -> ``FailoverSolver`` on the card ->
    a ``ChaosProxy`` with the six wire faults -> an ``InProcessSidecar``
    on the card under a ``SolverSupervisor`` driven by ``check_once()`` on
    a fake clock (no backoff, no monitor thread): every tick completes,
    the placements and staged node accounting equal the fault-free run on
    the card and on the CPU, every fault fired, the failover flipped
    degraded and back. Returns the ``kernels`` entry of the one-block
    kernel (the sidecar's solves and the local ones, in this process)."""
    sockets = Sockets()
    solver_addr, proxy_addr = sockets.path("wire"), sockets.path("proxy")
    handles = []

    def spawn():
        handles.append(chaos.InProcessSidecar(solver_addr))
        return handles[-1]

    clock = [0.0]
    sup = SolverSupervisor(solver_addr, spawn_fn=spawn, ready_timeout_s=120.0,
                           backoff_base_s=0.0, backoff_cap_s=0.0,
                           clock=lambda: clock[0])
    sup.start(wait_ready=True, monitor=False)
    proxy = chaos.ChaosProxy(
        proxy_addr, solver_addr, chaos.FaultSchedule(WIRE_FAULTS),
        kill_fn=lambda: handles[-1].kill(), stall_s=WIRE_STALL_S).start()
    remote = RemoteSolver(proxy_addr, timeout=60.0, retries=1,
                          retry_total_s=0.2, backoff_base_s=0.01,
                          backoff_cap_s=0.05)
    backend = failover.FailoverSolver(remote, failure_threshold=2,
                                      recovery_probes=2, prewarm=False)
    model = PlacementModel(backend=backend)
    backend.on_flip_back = model.reset_staging
    checks, stalled, keep = [], [], []

    def on_tick(t):
        # the deadline only on the request the proxy stalls
        armed = proxy.requests_seen == WIRE_STALL_ORDINAL
        remote.deadline_s = WIRE_STALL_DEADLINE_S if armed else None
        if armed:
            stalled.append(t)
        if t == WIRE_RESPAWN_TICK:
            clock[0] += 1.0
            checks.append(sup.check_once())

    try:
        (log, walls, modes, _), launches, wall, captured = drive(
            lambda: outage_churn(model, ttypes, ClusterDeltaTracker,
                                 ResourceName, on_tick=on_tick, keep=keep),
            clone=True)
        faults = dict(proxy.faults_injected)
        status = backend.status()
    finally:
        proxy.stop()
        sup.stop()
        backend.close()
        sockets.close()
    free, cpu = [], []
    ref, _, _, _ = outage_churn(PlacementModel(), ttypes, ClusterDeltaTracker,
                                ResourceName, keep=free)
    t0 = time.perf_counter()
    cpu_log, _, _, _ = outage_churn(PlacementModel(device="cpu"), ttypes,
                                    ClusterDeltaTracker, ResourceName,
                                    keep=cpu)
    cpu_wall = time.perf_counter() - t0
    assert len(log) == OUTAGE.ticks
    assert log == ref, "wire faults: ticks != the fault-free run on the card"
    assert log == cpu_log, "wire faults: ticks != the CPU run"
    assert (node_accounting(keep[0]) == node_accounting(free[0])
            == node_accounting(cpu[0])), "wire faults: node accounting"
    assert faults == {k: 1 for k in WIRE_FAULTS.values()}, faults
    assert checks == ["restarted"] and len(handles) == 2, (checks, handles)
    assert status["flips_to_degraded"] >= 1, status
    assert status["flips_to_remote"] >= 1 and not status["degraded"], status
    assert len(stalled) == 1 and modes[stalled[0]] == "local-fallback", (
        stalled, modes)
    assert modes[-1] == "remote", modes
    assert all(route.kind == "block" for _, route in captured)
    assert launches["block"] == len(captured) == sum(launches.values()), (
        launches, len(captured))
    local = sum(m in ("local-fallback", "local-degraded") for m in modes)
    print(f"wire under faults (config #11 through a ChaosProxy) [{card}]: "
          f"{OUTAGE.n_nodes} nodes, {OUTAGE.pending} pending a tick, "
          f"{OUTAGE.ticks} ticks, faults {sorted(faults)} each once (the "
          f"stall {WIRE_STALL_S} s against a {WIRE_STALL_DEADLINE_S} s "
          f"deadline at tick {stalled[0]}); every tick == the fault-free run "
          f"on the card == the CPU run (placements and staged node "
          f"accounting); modes {' -> '.join(mode_runs(modes))}, {local} "
          f"local ticks; the respawn by check_once at tick "
          f"{WIRE_RESPAWN_TICK}: {checks[0]}; flips to degraded "
          f"{status['flips_to_degraded']}, back {status['flips_to_remote']}; "
          f"one-block launches {launches['block']} (the sidecar's and the "
          f"local solves); run wall {wall:.3f} s, tick wall median "
          f"{statistics.median(walls) * 1e3:.3f} ms; the CPU run "
          f"{cpu_wall:.3f} s", flush=True)
    stats = compare(captured[0][0], f"the first wire tick, {OUTAGE.n_nodes} "
                    f"x {captured[0][0].req.shape[0]}", card, reps=5)
    return entry("binpack_wire_outage", launches["block"], stats, 93)


def storm_arm(n, ticks, device, budgets=None):
    """One arm of the eviction storm on ``device``: ``eviction_storm_world``
    at ``n`` nodes through ``Scheduler(preemption_backend="device")``,
    with (``budgets``: loose, tight) an arbiter squeezed mid-wave and the
    schedule's rebalance wave, or (None) no arbiter and no fault. Returns
    ``(scheduler, per-tick log, arbiter, the squeeze's seq, fired)``."""
    nodes, residents, arrivals = chaos.eviction_storm_world(
        seed=EVSTORM_SEED, n_nodes=n)
    sched = Scheduler(model=PlacementModel(device=device),
                      preemption_backend="device")
    arb = None if budgets is None else MigrationArbiter(budgets[0])
    sched.migration_arbiter = arb
    for node in nodes:
        sched.add_node(node)
    for pod in residents + arrivals:
        sched.add_pod(pod)
    schedule = chaos.FaultSchedule(EVSTORM_SCHEDULE if budgets else {})
    plugin = LowNodeLoad(LowNodeLoadArgs())
    squeeze, fired, log = [None], [], []
    for t in range(ticks):
        now = 100.0 + 2.0 * t
        kind = schedule.fault_for(t)
        if kind is not None:
            fired.append(kind)
        if kind == "rebalance-wave":
            sched.rebalance_sweep(plugin, now=now)
        if kind == "budget-squeeze-mid-wave":
            arb.set_budget(budgets[1])
            squeeze[0] = (arb.decisions() or [{}])[-1].get("seq", 0)
        out = sched.schedule_pending(now=now)
        log.append((t, sorted(out.items()), sorted(out.nominations.items())))
    return sched, log, arb, squeeze[0], fired


def placed_pods(sched):
    return sorted((p.name, p.node_name)
                  for p in sched.cache.pods.values() if p.node_name)


def eviction_storm(card) -> dict:
    """Phase 20 (b): the eviction storm at the reference's 10 nodes and at
    256, under the reference's schedule (``preemption-storm`` at tick 2,
    ``rebalance-wave`` at 5, ``budget-squeeze-mid-wave`` at 7) through a
    budgeted ``MigrationArbiter``, preemption on the card: no budget
    exceeded in any window, each victim evicted once, typed deferrals, the
    final placements and staged node accounting equal the fault-free arm
    and the CPU run. Returns the ``kernels`` entry of the storm rounds'
    placement kernel."""
    total = 0
    for n, ticks in EVSTORM_SIZES:
        k = max(1, n // 32)
        loose = MigrationBudget(max_per_round=4 * k, max_per_node=2,
                                max_per_tenant=6 * k, window_s=3.0)
        tight = MigrationBudget(max_per_round=2 * k, max_per_node=1,
                                max_per_tenant=3 * k, window_s=3.0)
        control, control_log, _, _, _ = storm_arm(n, ticks, None)
        (sched, log, arb, at, fired), launches, wall, captured = drive(
            lambda: storm_arm(n, ticks, None, (loose, tight)), clone=True)
        t0 = time.perf_counter()
        cpu, cpu_log, cpu_arb, _, _ = storm_arm(n, ticks, "cpu",
                                                (loose, tight))
        cpu_wall = time.perf_counter() - t0
        assert fired == list(EVSTORM_SCHEDULE.values()), fired
        assert log == cpu_log, f"storm {n}: cuda != cpu rounds"
        assert arb.decisions() == cpu_arb.decisions()
        want = [(f"evstorm-ls-{i}", f"evstorm-n{i}") for i in range(n)]
        assert placed_pods(control) == sorted(want), "control arm"
        assert placed_pods(sched) == placed_pods(control) == placed_pods(cpu)
        now = 100.0 + 2.0 * ticks
        assert (node_accounting(sched.cache.snapshot(now=now))
                == node_accounting(control.cache.snapshot(now=now))
                == node_accounting(cpu.cache.snapshot(now=now)))
        records = arb.decisions()
        chaos.check_budget_compliance(
            records, lambda seq: loose if at is None or seq <= at else tight)
        evicted = [u for rec in records if not rec.get("dry_run")
                   for u in rec["admitted"]]
        assert len(evicted) == len(set(evicted)) == n, len(evicted)
        deferred = [d for rec in records for d in rec["deferred"]]
        status = arb.status()
        assert deferred and status["deferred_total"] == len(deferred)
        assert all(route.kind == "block" for _, route in captured)
        assert launches["block"] == len(captured) == sum(launches.values())
        total += launches["block"]
        print(f"eviction storm, {n} nodes, {ticks} ticks [{card}]: faults "
              f"{fired}; {len(evicted)} evictions, each once, {len(deferred)} "
              f"deferred {dict(status['deferred_by_reason'])}, within every "
              f"budget (loose {loose.max_per_round}/round, squeezed to "
              f"{tight.max_per_round}); placements and node accounting == "
              f"the fault-free arm == the CPU run; one-block launches "
              f"{launches['block']}; card wall {wall:.3f} s, CPU "
              f"{cpu_wall:.3f} s", flush=True)
    # the storm round that placed the most pods (the preemptors binding on
    # the nodes their victims left)
    inp = max((c for c, _ in captured),
              key=lambda c: int((bk.binpack(c).assign >= 0).sum()))
    assert int((bk.binpack(inp).assign >= 0).sum()) > 0
    stats = compare(inp, f"the storm's fullest round, {n} x "
                    f"{inp.req.shape[0]}", card, reps=5)
    return entry("binpack_eviction_storm", total, stats, 317)


def manager_child(path):
    """``python -m koordinator_tpu_torch.cmd.manager --once --cluster-json
    path`` on CHILD_DEVICE: ``(synced nodes, wall split)``."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "koordinator_tpu_torch.cmd.manager", "--once",
         "--cluster-json", path, "--device", CHILD_DEVICE],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # each line stamped as it arrives (main flushes its own two)
    stamped = [(time.perf_counter(), line.rstrip("\n"))
               for line in proc.stdout]
    rc = proc.wait(timeout=BINARY_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = [line for _, line in stamped]
    assert rc == 0, lines[-40:]
    assert lines[0].startswith("koord-manager components: noderesource"), lines
    synced = next(x for x in lines if x.startswith("noderesource reconcile:"))
    wired_at, wired = next((t, x) for t, x in stamped
                           if x.startswith("koord-manager: wired"))
    ended_at, ended = next((t, x) for t, x in stamped
                           if x.startswith("koord-manager: reconcile returned"))
    assert f"wired on {CHILD_DEVICE}" in wired, wired
    wired_s, seeding_s = (seconds_after(wired, " in "),
                          seconds_after(wired, "bus seeding "))
    reconcile_s = seconds_after(ended, " after ")
    imports_s = wired_at - t0 - wired_s
    return int(synced.split()[2]), dict(
        wall=wall, imports=imports_s, wiring=wired_s, seeding=seeding_s,
        reconcile=reconcile_s, exit=wall - imports_s - wired_s - reconcile_s,
        exit_alone=t0 + wall - ended_at)


def admitted_round(running, spec, device):
    """Phase 20 (c) in process on ``device``: ``build_manager`` reconciles
    the running cluster of ``running`` and PATCHes the batch allocatable
    onto a bus that a wired ``build_scheduler`` watches; the pending pods
    of ``spec`` pass ``Manager.admit_pod`` (a ``ClusterColocationProfile``
    turns a seeded half into BE pods on batch resources) onto the bus; one
    ``run_loop(once=True)`` round. Returns the record and the timings."""
    bus = APIServer()
    sched = build_scheduler(SchedulerConfig(host_fallback_cells=0),
                            device=device)
    wire_scheduler(bus, sched)
    manager = build_manager(ManagerConfig(), device=device)
    wire_pod_webhook(bus, manager.mutating_webhook)
    manager.mutating_webhook.update_profile(ClusterColocationProfile(
        name="be-half", selector={"colocation": "be"}, qos_class=QoSClass.BE,
        priority=5500))
    loop = wire_manager(bus, manager.noderesource)
    seed_bus_from_json(bus, running)
    t0 = time.perf_counter()
    synced = loop.reconcile(now=time.time())
    reconcile_s = time.perf_counter() - t0
    batch = [n.allocatable.get(ResourceName.BATCH_CPU, 0)
             for n in bus.list(Kind.NODE).values()]
    assert min(batch) > 0, "a node without batch allocatable"
    be = np.random.default_rng(ADMIT_SEED).random(len(spec["pods"])) < 0.5
    pending = [(p, b) for p, b in zip(spec["pods"], be) if "node" not in p]
    t0 = time.perf_counter()
    for p, is_be in pending:
        pod, violations = manager.admit_pod(ttypes.PodSpec(
            name=p["name"], labels={"colocation": "be"} if is_be else {},
            requests={ResourceName.CPU: p["cpu"],
                      ResourceName.MEMORY: p["memory"]}))
        assert not violations, violations
        bus.apply(Kind.POD, pod.uid, pod)
    admit_s = time.perf_counter() - t0
    logs = []
    rc = run_loop(sched, SchedulerConfig(), once=True, log=logs.append)
    assert rc == 0, rc
    pods = {p.uid: (p.node_name, p.qos.name, sorted(int(r) for r in p.requests))
            for p in bus.list(Kind.POD).values() if p.name.startswith("p")}
    return dict(synced=synced, batch=batch, pods=pods, round=logs[-1],
                n_be=int(sum(b for _, b in pending)), n=len(pending)), dict(
                    reconcile=reconcile_s, admit=admit_s)


def manager_binary(card) -> dict:
    """Phase 20 (c): the manager binary as a child on a 5,000-node cluster
    spec (phase 18's world, 10,000 running pods), its wall split; the same
    reconcile, the admission wave and a wired scheduler's round in process
    on the card (the step timed by CUDA events, with its launches) and on
    the CPU: equal records. The round's kernel is held against the CPU
    round's plain twin on the same inputs. Returns its ``kernels`` entry."""
    solve = bk.binpack
    cpu_solves = []

    def plain_solve(inp, *args):
        t0 = time.perf_counter()
        out = solve(inp, *args)
        cpu_solves.append((inp, out, time.perf_counter() - t0))
        return out

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cluster.json")
        spec = binaries_world(path)
        running = os.path.join(d, "running.json")
        binaries_world(running, pending=False)
        child_synced, split = manager_child(path)
        with StepRecorder() as steps:
            (got, tm), launches, wall, captured = drive(
                lambda: admitted_round(running, spec, None), clone=True)
        # the CPU round's plain twin runs a few torch ops a pod on [5000,
        # 8] tensors: on one intra-op thread it takes about half the time
        # it takes on the machine's eight
        threads = torch.get_num_threads()
        bk.binpack = plain_solve
        torch.set_num_threads(CPU_ROUND_THREADS)
        try:
            t0 = time.perf_counter()
            want, cpu_tm = admitted_round(running, spec, "cpu")
            cpu_wall = time.perf_counter() - t0
        finally:
            bk.binpack = solve
            torch.set_num_threads(threads)
    assert got == want, "admitted round: cuda != cpu"
    assert got["synced"] == child_synced == NODES, (got["synced"],
                                                    child_synced)
    inp, route = routed("the admitted round", launches, captured, "cluster")
    assert route.shards == 5, route
    placed = [v for v in got["pods"].values() if v[0] is not None]
    be_placed = sum(q == "BE" for _, q, _ in placed)
    assert be_placed > 0 and len(placed) > be_placed, (be_placed, len(placed))
    step_ms = steps.ms()
    step_launches_n = step_launches(steps.args[0])
    # the kernel against the CPU round's plain twin on the same inputs
    (cpu_inp, cpu_out, plain_s), = cpu_solves
    for f in inp._fields:
        a, b = getattr(inp, f), getattr(cpu_inp, f)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a.cpu(), b), f"round inputs differ on {f}"
    out = bk.binpack(inp)
    err = max_abs_err(type(out)(*(None if x is None else x.cpu()
                                  for x in out)), cpu_out)
    ms = cuda_ms(lambda: bk.binpack(inp), 3)
    bound_ms, bound_by = bound(inp)
    p = inp.req.shape[0]
    print(f"manager binary --once [{card}]: {NODES} nodes, "
          f"{NODES * BIN_ASSIGNED} running pods: {child_synced} nodes synced "
          f"== in process; child wall {split['wall']:.3f} s = interpreter "
          f"start and imports {split['imports']:.3f} s + wiring "
          f"{split['wiring']:.3f} s (bus seeding {split['seeding']:.3f} s) + "
          f"the reconcile {split['reconcile']:.3f} s + the rest, process "
          f"exit included {split['exit']:.3f} s (exit alone "
          f"{split['exit_alone']:.3f} s)", flush=True)
    print(f"manager in process [{card}]: reconcile {tm['reconcile']:.4f} s "
          f"(step by CUDA events {step_ms[0]:.4f} ms, launches "
          f"{'not measured' if step_launches_n is None else step_launches_n}"
          f"), CPU {cpu_tm['reconcile']:.4f} s; admission wave "
          f"{got['n']} pods ({got['n_be']} made BE on batch resources) "
          f"{tm['admit']:.4f} s = {got['n'] / tm['admit']:.1f} pods/s "
          f"through the webhooks; '{got['round']}' ({be_placed} BE pods "
          f"placed) == the CPU round; route {route_name(route)}, launches "
          f"{launches[route.kind]}; card run wall {wall:.3f} s, CPU run "
          f"{cpu_wall:.3f} s ({CPU_ROUND_THREADS} torch thread)", flush=True)
    print(f"the admitted round's inputs: {route_name(route)} kernel == the "
          f"CPU round's plain twin on the same inputs ({p} pods, max_abs_err "
          f"{err}) [{card}]: kernel {ms:.3f} ms ({ms / p * 1e3:.3f} us/pod), "
          f"plain twin on the CPU ({CPU_ROUND_THREADS} torch thread) "
          f"{plain_s * 1e3:.3f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by})", flush=True)
    return dict(name=f"binpack_admitted_round_{route_name(route)}_"
                     f"{variant(inp)}",
                replaces=f"{REPLACES}:317", source=CLUSTER_SOURCE,
                launches=launches[route.kind], max_abs_err=err, ms=ms,
                plain_ms=plain_s * 1e3, bound_ms=bound_ms, bound_by=bound_by)


def faults_and_manager(card) -> list:
    """Phase 20. Returns its ``kernels`` entries."""
    t0 = time.perf_counter()
    entries = [wire_outage(card), eviction_storm(card), manager_binary(card)]
    print(f"faults and manager phase wall {time.perf_counter() - t0:.2f} s",
          flush=True)
    return entries


def koord_draw(spec):
    """Phase 21's seeded usage of every node of ``spec`` over the
    collectors' KOORD_TICKS ticks, as the counters a node exposes: the
    cumulative busy jiffies of /proc/stat ``[N, T]``, MemTotal and the kB
    in use ``[N]``, ``[N, T]``, and per running pod (BIN_ASSIGNED a node,
    in the spec's order) the cumulative cpu ns and the memory bytes of its
    cgroup ``[N, A, T]``. A pod uses 20-90% of its CPU request and 40-90%
    of its memory request; the node adds a system share of 5-60% of its
    cores (20% jitter a tick) and 1-4 GiB."""
    rng = np.random.default_rng(KOORD_SEED)
    n, a, t = len(spec["nodes"]), BIN_ASSIGNED, KOORD_TICKS
    cores = np.array([x["cpu"] for x in spec["nodes"]]) / 1000.0
    running = [p for p in spec["pods"] if "node" in p]
    req_cpu = np.array([p["cpu"] for p in running]).reshape(n, a) / 1000.0
    req_mem = np.array([p["memory"] for p in running]).reshape(n, a)
    pod_cores = rng.uniform(0.2, 0.9, (n, a, t)) * req_cpu[..., None]
    sys_cores = (rng.uniform(0.05, 0.6, (n, 1)) * cores[:, None]
                 * rng.uniform(0.8, 1.2, (n, t)))
    busy = pod_cores.sum(axis=1) + sys_cores
    step = KOORD_STEP_S
    jiffies = (rng.integers(10**6, 10**8, (n, 1))
               + np.cumsum(np.rint(busy * 100 * step).astype(np.int64),
                           axis=1))
    pod_ns = (rng.integers(10**9, 10**12, (n, a, 1))
              + np.cumsum(np.rint(pod_cores * step * 1e9).astype(np.int64),
                          axis=2))
    pod_bytes = np.rint(rng.uniform(0.4, 0.9, (n, a, t))
                        * req_mem[..., None] * 2**20).astype(np.int64)
    sys_kb = rng.integers(2**20, 2**22, (n, 1))
    used_kb = pod_bytes.sum(axis=1) // 1024 + sys_kb
    total_kb = np.array([x["memory"] for x in spec["nodes"]]) * 1024
    return dict(jiffies=jiffies, pod_ns=pod_ns, pod_bytes=pod_bytes,
                used_kb=used_kb, total_kb=total_kb)


def koord_now(k=KOORD_TICKS - 1) -> float:
    """The fake clock at the collectors' tick ``k`` (the reports' time at
    the last)."""
    return KOORD_T0 + KOORD_STEP_S * k


def koord_samples(draw):
    """The samples the collectors derive from :func:`koord_draw`'s
    counters, with their arithmetic, op for op: the node's and each pod's
    CPU rate from the second tick on, the memory from the first, the
    system residual (node less its pods, clamped at 0). Returns nested
    lists of floats: node cpu ``[N][T-1]``, node memory ``[N][T]``, pod
    cpu ``[N][A][T-1]``, pod memory ``[N][A][T]``, system cpu and
    memory."""
    jif = draw["jiffies"].astype(np.float64)
    node_cpu = (np.maximum(jif[:, 1:] - jif[:, :-1], 0.0) / KOORD_STEP_S
                / 100 * 1000.0)
    node_mem = (draw["used_kb"]) / 1024.0
    ns = draw["pod_ns"].astype(np.float64)
    pod_cpu = (np.maximum(ns[..., 1:] - ns[..., :-1], 0.0) / KOORD_STEP_S
               / 1e9 * 1000.0)
    pod_mem = draw["pod_bytes"] / (1024.0 * 1024.0)
    pods_cpu, pods_mem = 0, 0
    for k in range(BIN_ASSIGNED):
        pods_cpu = pods_cpu + pod_cpu[:, k]
        pods_mem = pods_mem + pod_mem[:, k]
    return {k: v.tolist() for k, v in dict(
        node_cpu=node_cpu, node_mem=node_mem, pod_cpu=pod_cpu,
        pod_mem=pod_mem, sys_cpu=np.maximum(node_cpu - pods_cpu, 0.0),
        sys_mem=np.maximum(node_mem - pods_mem, 0.0)).items()}


def koord_fill(cache, samples, i, uids) -> int:
    """Append node ``i``'s samples of :func:`koord_samples` to ``cache``
    at the ticks' times, as the collectors would (pod ``k`` of the node is
    ``uids[k]``). Returns the samples appended."""
    append, kinds = cache.append, MetricKind
    node = [(kinds.NODE_MEMORY_USAGE, None, samples["node_mem"][i], 0),
            (kinds.SYS_MEMORY_USAGE, None, samples["sys_mem"][i], 0),
            (kinds.NODE_CPU_USAGE, None, samples["node_cpu"][i], 1),
            (kinds.SYS_CPU_USAGE, None, samples["sys_cpu"][i], 1)]
    for j, u in enumerate(uids):
        node += [(kinds.POD_MEMORY_USAGE, {"pod": u},
                  samples["pod_mem"][i][j], 0),
                 (kinds.POD_CPU_USAGE, {"pod": u}, samples["pod_cpu"][i][j],
                  1)]
    appended = 0
    for kind, labels, values, first in node:
        for k in range(first, KOORD_TICKS):
            append(kind, labels, koord_now(k), values[k - first])
        appended += KOORD_TICKS - first
    return appended


def koord_v2(i) -> bool:
    """Whether agent ``i``'s tree is cgroup v2 (every second agent)."""
    return i % 2 == 1


def koord_config(root, i) -> SystemConfig:
    """Agent ``i``'s roots under ``root``: cgroupfs, procfs and sysfs."""
    return SystemConfig(cgroup_root=os.path.join(root, "cg"),
                        proc_root=os.path.join(root, "proc"),
                        sysfs_root=os.path.join(root, "sys"),
                        use_cgroup_v2=koord_v2(i))


def cpu_counter(cfg, ns, throttle=None) -> str:
    """A cgroup's cpu counter file: v1 ``cpuacct.usage`` in ns; v2
    ``cpu.stat``'s ``usage_usec`` (whole microseconds), with the
    throttling counters ``(nr_periods, nr_throttled)`` when given."""
    if not cfg.use_cgroup_v2:
        return str(ns)
    text = f"usage_usec {ns // 1000}\n"
    if throttle is not None:
        text += f"nr_periods {throttle[0]}\nnr_throttled {throttle[1]}\n"
    return text


def koord_tree(root, i, draw, metas, k) -> SystemConfig:
    """Agent node ``i``'s fake procfs and cgroupfs under ``root`` at tick
    ``k``: /proc/stat and /proc/meminfo, and each running pod's
    ``cpuacct.usage`` (v2: ``cpu.stat``) and ``memory.usage_in_bytes``
    (v2: ``memory.current``) at its cgroup (``metas``: the agent's pods,
    in the node's order)."""
    cfg = koord_config(root, i)
    if k == 0:
        os.makedirs(cfg.proc_root, exist_ok=True)
        for meta in metas:
            ensure_cgroup_dir(meta.cgroup_dir, cfg,
                              subfs=("cpuacct", "memory"))
    with open(os.path.join(cfg.proc_root, "stat"), "w") as f:
        f.write(f"cpu  {draw['jiffies'][i, k]} 0 0 {10**9 + 3000 * k} 0 0 "
                "0 0 0 0\n")
    total = draw["total_kb"][i]
    with open(os.path.join(cfg.proc_root, "meminfo"), "w") as f:
        f.write(f"MemTotal: {total} kB\nMemFree: 0 kB\nMemAvailable: "
                f"{total - draw['used_kb'][i, k]} kB\n")
    for j, meta in enumerate(metas):
        CPU_ACCT_USAGE.write(meta.cgroup_dir,
                             cpu_counter(cfg, int(draw["pod_ns"][i, j, k])),
                             cfg)
        MEMORY_USAGE.write(meta.cgroup_dir,
                           str(draw["pod_bytes"][i, j, k]), cfg)
    return cfg


def koord_policy() -> NodeMetricCollectPolicy:
    return NodeMetricCollectPolicy(*KOORD_POLICY)


def koord_objects(spec, n_nodes=None):
    """The nodes of ``spec`` (the first ``n_nodes``) and their running
    pods, as objects: ``(nodes, pods by node name)``."""
    nodes = spec["nodes"][:n_nodes]
    names = {x["name"] for x in nodes}
    cpu, mem = ResourceName.CPU, ResourceName.MEMORY
    pods = {}
    for p in spec["pods"]:
        if p.get("node") in names:
            pods.setdefault(p["node"], []).append(ttypes.PodSpec(
                name=p["name"], requests={cpu: p["cpu"], mem: p["memory"]},
                node_name=p["node"], creation_time=KOORD_T0))
    return [ttypes.NodeSpec(name=x["name"], allocatable={
        cpu: x["cpu"], mem: x["memory"]}) for x in nodes], pods


def koord_fleet(bus, spec, draw, root, agents=KOORD_AGENTS, n_nodes=None,
                topology=None):
    """Phase 21's node agents on ``bus`` (whose nodes and running pods are
    applied): the first ``agents`` nodes each wired through
    ``wire_koordlet`` with a ``MetricsAdvisor`` of ``default_collectors()``
    over its fake tree under ``root``, ticked KOORD_TICKS times on the fake
    clock; every other node a ``StatesInformer`` and a ``MetricCache`` fed
    :func:`koord_samples` directly. Every node's ``NodeMetricReporter``
    reports at the last tick and its NodeMetric goes onto the bus (the
    agents' through ``KoordletLoop.report``). With ``topology``, a
    function of the node's index giving ``(topology_reporter,
    device_reporter)``, every node is wired and its NRT and Device CRs are
    reported too. Returns ``(metrics by node, loops, timings, shadows)``:
    ``shadows`` the agents' reports from caches fed directly, which their
    collectors' reports must equal (a v2 agent's fed whole microseconds,
    as its ``cpu.stat`` counts them). ``timings`` also carries the fleet
    (``informers``, ``reporters``, ``advisors``: name -> (config,
    advisor), ``uids``: the running pods' by name)."""
    samples = koord_samples(draw)
    samples_us = koord_samples(dict(draw, pod_ns=draw["pod_ns"] // 1000
                                    * 1000))
    nodes = spec["nodes"][:n_nodes]
    uids = {}
    for p in spec["pods"]:
        if "node" in p:
            uids.setdefault(p["node"], []).append(f"default/{p['name']}")
    metas_of = {}
    loops, agents_of, reporters, informers = {}, {}, {}, {}
    for i, x in enumerate(nodes):
        name = x["name"]
        informer = informers[name] = StatesInformer()
        informer.set_collect_policy(koord_policy())
        reporter = NodeMetricReporter(
            MetricCache(capacity_per_series=KOORD_CAPACITY), informer)
        reporters[name] = reporter
        if i < agents or topology is not None:
            topo, dev = topology(i) if topology is not None else (None, None)
            loops[name] = wire_koordlet(bus, informer, name,
                                        reporter=reporter,
                                        topology_reporter=topo,
                                        device_reporter=dev)
        else:
            informer.set_node(bus.get(Kind.NODE, name))
            informer.set_pods([pod_meta_from_spec(bus.get(Kind.POD, u))
                               for u in uids[name]])
        if i < agents:
            metas = informer.running_pods()
            assert [m.uid for m in metas] == uids[name], name
            metas_of[name] = metas
            ctx = CollectorContext(metric_cache=reporter.metric_cache,
                                   system_config=koord_config(
                                       os.path.join(root, name), i),
                                   pod_provider=informer)
            agents_of[name] = MetricsAdvisor(ctx, default_collectors(),
                                             interval_seconds=KOORD_STEP_S)
    t0 = time.perf_counter()
    for k in range(KOORD_TICKS):
        for i, x in enumerate(nodes[:agents]):
            koord_tree(os.path.join(root, x["name"]), i, draw,
                       metas_of[x["name"]], k)
            agents_of[x["name"]].tick(koord_now(k))
    ticks_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    appended = 0
    for i, x in enumerate(nodes[agents:], start=agents):
        appended += koord_fill(reporters[x["name"]].metric_cache, samples, i,
                               uids[x["name"]])
    fill_s = time.perf_counter() - t0
    now = koord_now()
    metrics = {}
    t0 = time.perf_counter()
    for x in nodes:
        name = x["name"]
        if name in loops:
            metrics[name] = loops[name].report(now)
        else:
            metrics[name] = reporters[name].report(now)
            bus.apply(Kind.NODE_METRIC, name, metrics[name])
    report_s = time.perf_counter() - t0
    shadows = {}
    for i, x in enumerate(nodes[:agents]):
        informer = StatesInformer()
        informer.set_collect_policy(koord_policy())
        informer.set_node(bus.get(Kind.NODE, x["name"]))
        informer.set_pods(metas_of[x["name"]])
        shadow = NodeMetricReporter(
            MetricCache(capacity_per_series=KOORD_CAPACITY), informer)
        koord_fill(shadow.metric_cache, samples_us if koord_v2(i)
                   else samples, i, uids[x["name"]])
        shadows[x["name"]] = shadow.report(now)
    return metrics, loops, dict(
        ticks=ticks_s, fill=fill_s, appended=appended, reports=report_s,
        informers=informers, reporters=reporters, uids=uids,
        advisors={n: (a.ctx.system_config, a) for n, a in agents_of.items()}
    ), shadows


def batch_of(bus) -> dict:
    """The batch allocatable the manager PATCHed, by node."""
    return {name: (n.allocatable.get(ResourceName.BATCH_CPU, 0),
                   n.allocatable.get(ResourceName.BATCH_MEMORY, 0))
            for name, n in bus.list(Kind.NODE).items()}


def koord_pending(spec):
    """Phase 21's pending wave: the PENDING pods of ``spec``, a seeded
    half of them BE pods on batch resources (priority 5,500, the batch
    band)."""
    be = np.random.default_rng(KOORD_BE_SEED).random(PENDING) < 0.5
    pods = []
    for p, is_be in zip((p for p in spec["pods"] if "node" not in p), be):
        if is_be:
            pods.append(ttypes.PodSpec(
                name=p["name"], qos=QoSClass.BE, priority=5500,
                requests={ResourceName.BATCH_CPU: p["cpu"],
                          ResourceName.BATCH_MEMORY: p["memory"]},
                creation_time=KOORD_T0))
        else:
            pods.append(ttypes.PodSpec(
                name=p["name"], requests={ResourceName.CPU: p["cpu"],
                                          ResourceName.MEMORY: p["memory"]},
                creation_time=KOORD_T0))
    return pods


def koord_colocation(spec, draw, root, device):
    """Phase 21 (a)-(b) on ``device``: a bus with the world's nodes and
    running pods, a wired ``build_scheduler`` in the aggregated mode,
    ``wire_manager(bus, device=device)``, the fleet (:func:`koord_fleet`)
    and the manager's reconcile. Returns ``(bus, scheduler, metrics,
    batch, record)``; the record carries the manager and the fleet."""
    bus = APIServer()
    sched = build_scheduler(aggregated_config(AGG_SCORE_PCTS[0]),
                            device=device)
    wire_scheduler(bus, sched)
    manager = wire_manager(bus, device=device)
    nodes, pods = koord_objects(spec)
    t0 = time.perf_counter()
    for node in nodes:
        bus.apply(Kind.NODE, node.name, node)
    for node in nodes:
        for pod in pods[node.name]:
            bus.apply(Kind.POD, pod.uid, pod)
    seed_s = time.perf_counter() - t0
    metrics, loops, tm, shadows = koord_fleet(bus, spec, draw, root)
    t0 = time.perf_counter()
    synced = manager.reconcile(now=koord_now())
    tm["reconcile"] = time.perf_counter() - t0
    tm["seed"] = seed_s
    return bus, sched, metrics, batch_of(bus), dict(
        tm, synced=synced, loops=loops, shadows=shadows, manager=manager)


def koord_topology_tree(root, cores, vendor=None) -> SystemConfig:
    """A fake /proc/cpuinfo and NUMA sysfs of ``cores`` logical CPUs
    (rounded down to even) under ``root``: 2 threads a core, 2 NUMA
    nodes of half the cores each (node 0 the first), a socket each; each
    processor's ``vendor_id`` when ``vendor`` is given."""
    cfg = SystemConfig(cgroup_root=os.path.join(root, "cg"),
                       proc_root=os.path.join(root, "proc"),
                       sysfs_root=os.path.join(root, "sys"))
    n_cores = cores // 2
    numa = [0 if c < n_cores // 2 else 1 for c in range(n_cores)]
    os.makedirs(cfg.proc_root, exist_ok=True)
    vendor_line = f"vendor_id\t: {vendor}\n" if vendor else ""
    blocks = [f"processor\t: {cpu}\n{vendor_line}physical id\t: "
              f"{numa[cpu // 2]}\ncore id\t: {cpu // 2}\n"
              for cpu in range(2 * n_cores)]
    with open(os.path.join(cfg.proc_root, "cpuinfo"), "w") as f:
        f.write("\n".join(blocks) + "\n")
    for node in (0, 1):
        cpus = [cpu for cpu in range(2 * n_cores) if numa[cpu // 2] == node]
        d = os.path.join(cfg.sysfs_root, "devices", "system", "node",
                         f"node{node}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "cpulist"), "w") as f:
            f.write(f"{cpus[0]}-{cpus[-1]}\n")
    return cfg


class SeededGPUs:
    """A node's seeded GPU inventory (the ``DeviceSource`` a
    ``DeviceReporter`` reads): KOORD_GPUS GPUs, memory drawn from
    KOORD_GPU_MIB, 4 on each NUMA node, 2 a PCIe switch."""

    def __init__(self, rng):
        self.mib = [int(m) for m in rng.choice(KOORD_GPU_MIB, KOORD_GPUS)]

    def list_devices(self):
        return [DeviceEntry(
            minor=k, device_type=DeviceType.GPU, resources={
                DeviceResourceName.GPU_CORE: 100,
                DeviceResourceName.GPU_MEMORY: self.mib[k],
                DeviceResourceName.GPU_MEMORY_RATIO: 100},
            numa_node=k // 4, socket_id=k // 4, pcie_id=str(k // 2))
            for k in range(KOORD_GPUS)]


def koord_fine_pending():
    """Round 2's SNN_PENDING pods: a seeded half LSR pods asking 2-8
    whole CPUs (a cpuset), the rest asking 1-2 ``nvidia.com/gpu``."""
    rng = np.random.default_rng(KOORD_GPU_SEED + 1)
    pods = []
    for j in range(SNN_PENDING):
        if j % 2 == 0:
            pods.append(ttypes.PodSpec(
                name=f"cpuset-{j}", qos=QoSClass.LSR, requests={
                    ResourceName.CPU: 1000 * int(rng.integers(2, 9)),
                    ResourceName.MEMORY: int(rng.integers(1024, 8192))},
                creation_time=KOORD_T0))
        else:
            pods.append(ttypes.PodSpec(
                name=f"gpu-{j}", requests={
                    ResourceName.CPU: int(rng.integers(1000, 4000)),
                    ResourceName.MEMORY: int(rng.integers(1024, 8192))},
                device_requests={"nvidia.com/gpu": int(rng.integers(1, 3))},
                creation_time=KOORD_T0))
    return pods


def fine_state(sched):
    """Placements, annotations, NUMA and device holds of ``sched``, plain
    data."""
    pods = {**sched.cache.pending, **sched.cache.pods}
    return (
        {u: (p.node_name, dict(p.annotations)) for u, p in pods.items()},
        {n: {u: ([int(c) for c in a.cpuset],
                 {k: {int(r): v for r, v in res.items()}
                  for k, res in a.numa_resources.items()})
             for u, a in na.pods.items()}
         for n, na in sched.numa_manager.node_allocations.items()},
        {n: {u: {t.value: [(a.minor, {k.value: v for k, v in
                                     a.resources.items()})
                           for a in allocs]
                 for t, allocs in by_type.items()}
             for u, by_type in nd.allocations.items()}
         for n, nd in sched.device_cache.nodes.items()},
        sorted(sched._fine_waiting))


def koord_numa_world(spec, draw, root, device):
    """Round 2's world on ``device``: SNN_NODES nodes of ``spec`` on a bus
    with a wired ``build_scheduler``, each node's agent wired with its
    ``NodeMetricReporter``, a ``NodeTopologyReporter`` over
    ``read_cpu_infos`` of its fake tree under ``root`` and a
    ``DeviceReporter`` over :class:`SeededGPUs`, both publishing through
    ``koordlet_report_sinks``; the NRT and Device CRs checked on the bus
    and in the scheduler; then the SNN_PENDING cpuset and GPU pods.
    Returns ``(bus, scheduler, wall of the agents' reports)``."""
    rng = np.random.default_rng(KOORD_GPU_SEED)
    trees = [koord_topology_tree(os.path.join(root, x["name"]),
                                 x["cpu"] // 1000)
             for x in spec["nodes"][:SNN_NODES]]
    bus = APIServer()
    sched = build_scheduler(SchedulerConfig(feature_gates=NO_PREEMPTION,
                                            host_fallback_cells=0),
                            device=device)
    wire_scheduler(bus, sched)
    nodes, pods = koord_objects(spec, SNN_NODES)
    for node in nodes:
        bus.apply(Kind.NODE, node.name, node)
    for node in nodes:
        for pod in pods[node.name]:
            bus.apply(Kind.POD, pod.uid, pod)
    topo_sink, dev_sink = koordlet_report_sinks(bus)

    def reporters(i):
        name, mem = nodes[i].name, nodes[i].allocatable[ResourceName.MEMORY]
        return (NodeTopologyReporter(name, trees[i], topo_sink,
                                     numa_memory_mib={0: mem // 2,
                                                      1: mem - mem // 2}),
                DeviceReporter(name, SeededGPUs(rng), dev_sink))

    t0 = time.perf_counter()
    koord_fleet(bus, spec, draw, root, agents=0, n_nodes=SNN_NODES,
                topology=reporters)
    report_s = time.perf_counter() - t0
    for x in spec["nodes"][:SNN_NODES]:
        name = x["name"]
        nrt = bus.get(Kind.NODE_RESOURCE_TOPOLOGY, name)
        devices = bus.get(Kind.DEVICE, name)
        assert nrt is not None and len(devices) == KOORD_GPUS, name
        assert sched.numa_manager.get_topology(name) is nrt, name
        assert nrt.cpu_topology.num_cpus == 2 * (x["cpu"] // 2000), name
        got = sched.device_cache.get(name)
        assert got is not None and sorted(
            d.minor for ds in got.device_infos.values() for d in ds) == [
            d.minor for d in devices], name
    for pod in koord_fine_pending():
        bus.apply(Kind.POD, pod.uid, pod)
    return bus, sched, report_s


def koord_cpu(spec_path, root, out_path, handoff) -> None:
    """Phases 21 and 22's CPU run of the fleet's world, in a process of
    its own beside the card's, at CPU_ROUND_THREADS torch threads: the
    fleet and the manager (:func:`koord_colocation` on ``cpu``), the
    pending wave bound as the card's round 1 bound it (``handoff``), and
    phase 22 (:func:`qos_actuation` and its round) on ``cpu``. Pickles
    what the card's run is held against to ``out_path``."""
    import pickle

    with open(spec_path) as f:
        spec = json.load(f)
    draw = koord_draw(spec)
    torch.set_num_threads(CPU_ROUND_THREADS)
    bus, sched, metrics, batch, tm = koord_colocation(
        spec, draw, os.path.join(root, "fleet"), "cpu")
    for pod in koord_pending(spec):
        bus.apply(Kind.POD, pod.uid, pod)
    t0 = time.perf_counter()
    bound = koord_bind_handoff(bus, handoff)
    handoff_wait = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = qos_actuation(bus, sched, tm, spec, draw,
                        os.path.join(root, "fleet"))
    qos = qos_result(out, sched.schedule_pending(now=out["t_round"]))
    qos_wall = time.perf_counter() - t0
    with open(out_path, "wb") as f:
        pickle.dump(dict(metrics=metrics, batch=batch, synced=tm["synced"],
                         reconcile=tm["reconcile"], bound=bound,
                         handoff_wait=handoff_wait, qos=qos,
                         qos_wall=qos_wall), f)


def koord_cpu_round2(spec_path, root, out_path) -> None:
    """Phase 21 (d)'s CPU run, in a second process: round 2's world and
    round on ``cpu`` at CPU_ROUND_THREADS torch threads, then phase 23
    (a)-(c) and (e)'s collector on that world (:func:`hooks_actuation`).
    Pickles its results to ``out_path``."""
    import pickle

    with open(spec_path) as f:
        spec = json.load(f)
    draw = koord_draw(spec)
    torch.set_num_threads(CPU_ROUND_THREADS)
    root = os.path.join(root, "nrt")
    bus, sched, _ = koord_numa_world(spec, draw, root, "cpu")
    t0 = time.perf_counter()
    result = sched.schedule_pending(now=koord_now() + 1.0)
    wall = time.perf_counter() - t0
    round2 = (dict(result), result.waiting, fine_state(sched))
    t0 = time.perf_counter()
    hooks = hooks_actuation(bus, sched, [x["name"] for x in
                                         spec["nodes"][:SNN_NODES]], root)
    with open(out_path, "wb") as f:
        pickle.dump(dict(round2=round2, round2_wall=wall,
                         hooks=hooks["out"], hooks_timings=hooks["timings"],
                         hooks_wall=time.perf_counter() - t0), f)


def koord_cpu_start(spec_path, root, handoff):
    """Start :func:`koord_cpu` (which waits for round 1's binds at
    ``handoff``) and :func:`koord_cpu_round2` in two child processes;
    returns their ``[(process, output path)]``."""
    children = []
    for fn, extra in (("koord_cpu", [handoff]), ("koord_cpu_round2", [])):
        out = os.path.join(root, f"{fn}.pickle")
        children.append((subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             f"chip_smoke.{fn}(*sys.argv[1:])", spec_path,
             os.path.join(root, "cpu"), out, *extra],
            cwd=os.path.dirname(os.path.abspath(__file__))), out))
    return children


def koord_cpu_result(children) -> dict:
    """The CPU children's pickled results, merged, once both exit 0."""
    import pickle

    merged = {}
    for proc, out in children:
        rc = proc.wait(timeout=BINARY_TIMEOUT_S)
        assert rc == 0, f"the node agents' CPU run exited {rc}"
        with open(out, "rb") as f:
            merged.update(pickle.load(f))
    return merged


def koord_round_one(card, spec, draw, root, handoff):
    """Phase 21 (a)-(c) on the card: the fleet's reports, the manager and
    round 1, whose bound pods are pickled to ``handoff`` for the CPU run's
    phase 22. Returns ``(the round's kernels entry, metrics, batch,
    synced, the world)`` for the CPU run to be held against."""
    with StepRecorder() as steps:
        bus, sched, metrics, batch, tm = koord_colocation(spec, draw, root,
                                                          None)
    # (a) the reports
    on_bus = bus.list(Kind.NODE_METRIC)
    assert len(on_bus) == NODES and all(
        on_bus[n] is m for n, m in metrics.items()), "reports not on the bus"
    windows = {float(d) for d in koord_policy().aggregate_durations
               if d != KOORD_POLICY[0]}
    for name, m in metrics.items():
        assert m.aggregated_usage and set(m.aggregated_windows) == windows, (
            name, m.aggregated_usage, m.aggregated_windows)
    assert tm["shadows"] == {n: metrics[n] for n in tm["shadows"]}, (
        "an agent's report != the same samples appended directly")
    assert all(metrics[n].node_usage for n in tm["shadows"])
    hot = sum(m.aggregated_windows[max(windows)][AGG_USAGE_PCT][
        ResourceName.CPU] * 100 > AGG_THRESHOLDS[ResourceName.CPU]
        * bus.get(Kind.NODE, n).allocatable[ResourceName.CPU]
        for n, m in metrics.items())
    # (b) the manager
    assert tm["synced"] == NODES, tm["synced"]
    with_batch = sum(b[0] > 0 for b in batch.values())
    assert with_batch > 0, "no node with batch CPU"
    step_ms = steps.ms()
    step_launches_n = step_launches(steps.args[0])
    # (c) round 1
    pending = koord_pending(spec)
    for pod in pending:
        bus.apply(Kind.POD, pod.uid, pod)
    snap = ClusterSnapshot(
        nodes=list(bus.list(Kind.NODE).values()),
        pods=[p for p in bus.list(Kind.POD).values() if p.node_name],
        pending_pods=pending)
    label = f"the koordlet-fed round, {NODES} x {PENDING}"
    result, launches, wall, captured = drive(
        lambda: sched.schedule_pending(now=koord_now() + 1.0), clone=True)
    inp, route = routed(label, launches, captured, "cluster")
    assert route.shards == 5, route
    capacity_ok(snap, result)
    placed = {u: n for u, n in result.items() if n is not None}
    assert not result.waiting, "round 1 left pods at the Permit barrier"
    koord_handoff(handoff, {u: bus.get(Kind.POD, u) for u in placed})
    be = {p.uid for p in pending if p.qos == QoSClass.BE}
    be_placed = len(be & set(placed))
    assert be_placed > 0 and len(placed) > be_placed, (be_placed, len(placed))
    assert all(bus.get(Kind.POD, u).node_name == n for u, n in placed.items())
    agent_pods = sum(len(loop.pods()) for loop in tm["loops"].values())
    print(f"koordlet fleet [{card}]: {NODES} nodes, {KOORD_AGENTS} agents "
          f"wired (wire_koordlet) with default_collectors() over their fake "
          f"trees, {KOORD_TICKS} ticks {KOORD_STEP_S:.0f} s apart: collectors "
          f"{tm['ticks']:.3f} s; {NODES - KOORD_AGENTS} caches fed "
          f"{tm['appended']} samples directly in {tm['fill']:.3f} s; "
          f"{NODES} reports in {tm['reports']:.3f} s "
          f"({tm['reports'] / NODES * 1e3:.3f} ms a report); seeding "
          f"{tm['seed']:.3f} s; every report carries its percentiles and "
          f"windows, the agents' == their samples appended directly; {hot} "
          f"nodes past the CPU threshold at p{AGG_USAGE_PCT} of the "
          f"{max(windows):.0f} s window", flush=True)
    print(f"koordlet manager [{card}]: reconcile {tm['reconcile']:.4f} s "
          f"({tm['synced']} synced, {with_batch} nodes with batch CPU; step "
          f"by CUDA events {step_ms[0]:.4f} ms, launches "
          f"{'not measured' if step_launches_n is None else step_launches_n}"
          f")", flush=True)
    print(f"{label} [{card}]: {len(placed)} committed ({be_placed} BE on "
          f"batch resources), {len(result.waiting)} waiting; wall "
          f"{wall:.4f} s; route {route_name(route)}, launches "
          f"{launches[route.kind]}; the {KOORD_AGENTS} agents hold "
          f"{agent_pods} pods after the binds", flush=True)
    stats = cpu_twin_cut(inp, route, label, card)
    return (entry("binpack_koordlet_round", launches[route.kind], stats, 317),
            metrics, batch, tm["synced"], dict(bus=bus, sched=sched, tm=tm))


def koord_handoff(path, pods) -> None:
    """Round 1's bound pods (uid -> PodSpec, in the round's order) for the
    CPU run, written whole before it appears under ``path``."""
    import pickle

    with open(path + ".part", "wb") as f:
        pickle.dump(pods, f)
    os.replace(path + ".part", path)


def koord_bind_handoff(bus, path, timeout_s=BINARY_TIMEOUT_S) -> int:
    """The CPU run's round 1: wait for the card's bound pods at ``path``
    and apply each, as another scheduler's bind arrives (the wired
    scheduler observes the binding, the agents take their pods). Returns
    the pods bound."""
    import pickle

    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        assert time.monotonic() < deadline, "round 1's binds never came"
        time.sleep(0.05)
    with open(path, "rb") as f:
        pods = pickle.load(f)
    for uid, pod in pods.items():
        bus.apply(Kind.POD, uid, pod)
    return len(pods)



def koord_numa_devices(card, spec, draw, root):
    """Phase 21 (d) on the card: :func:`koord_numa_world` and its round,
    every solve on the one-block kernel with extras rows, the final
    solve held against its twin. Returns ``(its kernels entry, the
    round's placements, waiting pods and fine-grained state, the world for
    phase 23)``."""
    bus, sched, report_s = koord_numa_world(spec, draw, root, None)
    label = (f"the koordlet-reported NUMA and devices round, {SNN_NODES} x "
             f"{SNN_PENDING}")
    result, launches, wall, captured = drive(
        lambda: sched.schedule_pending(now=koord_now() + 1.0), clone=True)
    assert captured and all(r.kind == "block" for _, r in captured), [
        r for _, r in captured]
    assert sum(launches.values()) == launches["block"] == len(captured), (
        launches, len(captured))
    inp, route = captured[-1]
    assert inp.extras is not None, "the round's solve had no extras rows"
    state = fine_state(sched)
    held = sum(len(v) for v in state[1].values())
    gpus = sum(len(v) for v in state[2].values())
    assert held > 0 and gpus > 0, (held, gpus)
    committed = sum(n is not None for n in result.values())
    print(f"{label} [{card}]: NRT and Device CRs of {SNN_NODES} nodes on the "
          f"bus (NodeTopologyReporter over read_cpu_infos of a fake sysfs, "
          f"DeviceReporter over {KOORD_GPUS} seeded GPUs a node), taken in by "
          f"the NUMA manager and the device cache; {SNN_NODES} agents wired "
          f"and reported in {report_s:.3f} s; {committed} committed, "
          f"{len(result.waiting)} waiting, {held} pods hold a cpuset, {gpus} "
          f"hold GPUs; wall {wall:.4f} s ({len(captured)} solves, every one "
          f"on the one-block kernel with extras rows)", flush=True)
    stats = compare(inp, f"{label}, final solve", card, reps=3)
    return (entry("binpack_koordlet_numa_devices", launches["block"], stats,
                  259), (dict(result), result.waiting, state), dict(
        bus=bus, sched=sched, root=root,
        names=[x["name"] for x in spec["nodes"][:SNN_NODES]]))


def node_agents(card) -> list:
    """Phases 21, 22 (on phase 21's world after its round 1) and 23 (on
    phase 21 (d)'s world after its round), their CPU run in two child
    processes beside the card's. Returns their ``kernels`` entries."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cluster.json")
        spec = binaries_world(path)
        handoff = os.path.join(d, "round1.pickle")
        children = koord_cpu_start(path, d, handoff)
        try:
            draw = koord_draw(spec)
            round_one, metrics, batch, synced, world = koord_round_one(
                card, spec, draw, os.path.join(d, "fleet"), handoff)
            numa_devices, round_two, world2 = koord_numa_devices(
                card, spec, draw, os.path.join(d, "nrt"))
            t23 = time.perf_counter()
            hooks_entry, hooks = koordlet_hooks(card, world2,
                                                os.path.join(d, "child"))
            t1 = time.perf_counter()
            cpu = koord_cpu_result(children[1:])
            waited23 = time.perf_counter() - t1
            assert round_two == cpu["round2"], "round 2: cuda != cpu"
            for key in hooks:
                assert hooks[key] == cpu["hooks"][key], (
                    f"phase 23's {key}: cuda != cpu")
            t22 = time.perf_counter()
            qos_entry, qos = qos_replacement(card, world, spec, draw,
                                             os.path.join(d, "fleet"))
            t1 = time.perf_counter()
            cpu.update(koord_cpu_result(children[:1]))
            waited = time.perf_counter() - t1
        finally:
            for proc, _ in children:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    assert metrics == cpu["metrics"], "the fleet's reports: cuda != cpu"
    assert synced == cpu["synced"] and batch == cpu["batch"], (
        "batch allocatable: cuda != cpu")
    for key in qos:
        assert qos[key] == cpu["qos"][key], f"phase 22's {key}: cuda != cpu"
    print(f"node agents [{card}]: the CPU run (two processes, waited for "
          f"{waited23:.3f} s after the card's phase 23 and {waited:.3f} s "
          f"after its phase 22) reported the same {NODES} "
          f"NodeMetrics, its manager (reconcile {cpu['reconcile']:.4f} s) "
          f"PATCHed the same batch allocatable on every node (then bound "
          f"round 1's {cpu['bound']} pods as the card's round bound them, "
          f"{cpu['handoff_wait']:.3f} s after its fleet), and its round 2 "
          f"({cpu['round2_wall']:.4f} s, {CPU_ROUND_THREADS} torch thread) "
          f"the same placements, annotations, NUMA and device holds",
          flush=True)
    print(f"koordlet QoS [{card}]: the CPU run's phase 22 ({cpu['qos_wall']:.3f}"
          f" s) evicted the same {len(qos['victims'])} victims in the same "
          f"order, wrote the same trees on the {KOORD_AGENTS} agents, "
          f"reported the same {NODES} NodeMetrics, PATCHed the same batch "
          f"allocatable and placed the same pods", flush=True)
    htm = ", ".join(f"{k} {v:.3f} s" for k, v in cpu["hooks_timings"].items())
    print(f"koordlet hooks [{card}]: the CPU run's phase 23 "
          f"({cpu['hooks_wall']:.3f} s, {CPU_ROUND_THREADS} torch thread: "
          f"{htm}) "
          f"wrote the same trees ({sum(len(t) for t in hooks['trees'].values())}"
          f" files), the same executors' writes in order "
          f"({sum(len(w) for w in hooks['writes'].values())}), the same "
          f"server responses, audit events, NRI counts, normalized quotas "
          f"and CPI series, and placed the wave the same", flush=True)
    now = time.perf_counter()
    print(f"node agents phase wall {now - t0:.2f} s; phase 23 "
          f"{t22 - t23:.2f} s of it (the wait for its CPU half, "
          f"{waited23:.3f} s, included), then phase 22 {now - t22:.2f} s "
          f"(its wait, {waited:.3f} s, included)", flush=True)
    return [round_one, numa_devices, qos_entry, hooks_entry]

# -- phase 22: the agents act, the card re-places ------------------------------


def qos_slo_controller(policies) -> NodeSLOController:
    """Phase 22's NodeSLO renderer: the BE thresholds on (memory evict at
    QOS_MEMORY_EVICT%, CPU suppress at QOS_CPU_SUPPRESS%, the CPU evict
    satisfaction band QOS_SATISFACTION), memcg QoS and a blkio throttle
    for BE pods, CPU burst on, the /proc/sys knobs; each node's suppress
    policy from ``policies`` (an extender; cpuset where absent)."""
    spec = sloconfig.NodeSLOSpec()
    t = spec.resource_used_threshold_with_be
    t.enable = True
    t.memory_evict_threshold_percent = QOS_MEMORY_EVICT
    t.cpu_suppress_threshold_percent = QOS_CPU_SUPPRESS
    (t.cpu_evict_be_satisfaction_lower_percent,
     t.cpu_evict_be_satisfaction_upper_percent) = QOS_SATISFACTION
    be = spec.resource_qos_strategy.be
    be.enable = True
    be.memory = sloconfig.MemoryQOS(min_limit_percent=20,
                                    low_limit_percent=40,
                                    throttling_percent=90)
    be.blkio = [sloconfig.BlockCfg(device="253:0", read_bps=52428800,
                                   write_iops=400)]
    spec.cpu_burst_strategy.policy = "auto"
    spec.system_strategy = sloconfig.SystemStrategy(
        min_free_kbytes_factor=100, watermark_scale_factor=150)

    def policy(name, labels, rendered):
        rendered.resource_used_threshold_with_be.cpu_suppress_policy = (
            policies.get(name, "cpuset"))

    return NodeSLOController(cluster_spec=spec, extenders=[policy])


def qos_pressure(names, be_hosts, fed_hosts):
    """Phase 22's seeded pressure: the agents' suppress policies (cfsQuota
    on every second pair), the agents over the memory threshold (of
    ``be_hosts``, those running a BE pod), the agents whose BE tier is
    starved (of the other cpuset agents: cfsQuota's suppress would raise
    the quota), the other nodes over the memory threshold (of
    ``fed_hosts``) and every node's memory share under pressure."""
    rng = np.random.default_rng(QOS_SEED)
    agents = range(KOORD_AGENTS)
    policies = {names[i]: "cfsQuota" if (i // 2) % 2 else "cpuset"
                for i in agents}
    memory = sorted(int(x) for x in rng.choice(
        be_hosts, min(QOS_MEMORY_AGENTS, len(be_hosts)), replace=False))
    cpuset = [i for i in agents
              if policies[names[i]] == "cpuset" and i not in memory]
    starved = sorted(int(x) for x in rng.choice(cpuset, QOS_STARVED_AGENTS,
                                                replace=False))
    pressed = sorted(int(x) for x in rng.choice(
        fed_hosts, min(QOS_FED_PRESSED, len(fed_hosts)), replace=False))
    return dict(policies=policies, memory=memory, starved=starved,
                pressed=pressed, share=rng.uniform(0.75, 0.92, len(names)))


def qos_residents(name, i, starved, rng):
    """Pods already running on agent ``i``: an LS pod with a CPU limit
    (CPU burst's subject) and, on a starved agent, three BE pods asking
    plain CPU (the CPU evictor's: a batch pod asks none)."""
    cpu, mem = ResourceName.CPU, ResourceName.MEMORY
    pods = [ttypes.PodSpec(name=f"burst-{i}", qos=QoSClass.LS,
                           node_name=name, priority=9000,
                           requests={cpu: 1000, mem: 1024},
                           limits={cpu: 2000}, creation_time=KOORD_T0)]
    if i in starved:
        for k in range(3):
            pods.append(ttypes.PodSpec(
                name=f"be-{i}-{k}", qos=QoSClass.BE, node_name=name,
                priority=int(rng.integers(5000, 6000)),
                requests={cpu: int(rng.integers(1000, 3001)),
                          mem: int(rng.integers(512, 2049))},
                creation_time=KOORD_T0))
    return pods


def put_file(res, d, cfg, text) -> None:
    path = res.path(d, cfg)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def quota_text(cfg, quota_us) -> str:
    """A cfs quota as the kernel shows it: v1 ``cpu.cfs_quota_us``, v2
    ``cpu.max`` with its period."""
    return f"{quota_us} 100000" if cfg.use_cgroup_v2 else str(quota_us)


def resctrl_fake(cfg, ways, cache_ids) -> None:
    """A fake resctrl tree beside the fake cgroup root (where
    ``resctrl_root`` looks): ``ways`` L3 ways, ``cache_ids`` caches."""
    root = os.path.join(os.path.dirname(cfg.cgroup_root), "resctrl")
    os.makedirs(os.path.join(root, "info", "L3"))
    cbm = format((1 << ways) - 1, "x")
    with open(os.path.join(root, "info", "L3", "cbm_mask"), "w") as f:
        f.write(cbm + "\n")
    with open(os.path.join(root, "schemata"), "w") as f:
        f.write("L3:" + ";".join(f"{c}={cbm}" for c in range(cache_ids))
                + "\nMB:" + ";".join(f"{c}=100" for c in range(cache_ids))
                + "\n")


def remove_pod_dirs(cfg, cgroup_dir) -> None:
    """What the kubelet removes of a deleted pod: its cgroup dirs."""
    tops = ([cfg.cgroup_root] if cfg.use_cgroup_v2 else
            [os.path.join(cfg.cgroup_root, fs) for fs in V1_SUBSYSTEMS])
    for top in tops:
        shutil.rmtree(os.path.join(top, cgroup_dir), ignore_errors=True)


class QosAgent:
    """One agent's actuation half: its ``QoSContext`` wired as the
    koordlet binary wires it, a ``QoSManager`` of the eight strategies, a
    ``PLEG`` over its tree, and the counters its tree exposes from phase
    21's last tick on."""

    def __init__(self, tm, bus, draw, i, name, pressure, evict, clock):
        cpu = ResourceName.CPU
        self.i, self.name = i, name
        self.informer = informer = tm["informers"][name]
        self.cfg, self.advisor = tm["advisors"][name]
        node = bus.get(Kind.NODE, name)
        ex = ResourceUpdateExecutor(self.cfg, clock=clock)
        # an empty Auditor is falsy: set after construction
        ex.auditor = self.auditor = Auditor(clock=clock)

        def be_allocatable():
            n = informer.get_node()
            value = n.allocatable.get(ResourceName.BATCH_CPU) if n else None
            return int(value) if value else None

        self.ctx = QoSContext(
            metric_cache=tm["reporters"][name].metric_cache, executor=ex,
            pod_provider=informer, system_config=self.cfg,
            auditor=self.auditor, node_capacity_mcpu=node.allocatable[cpu],
            node_capacity_mem_mib=node.allocatable[ResourceName.MEMORY],
            volume_name_fn=informer.get_volume_name,
            be_allocatable_fn=be_allocatable,
            evict=lambda victims, reason: evict(name, victims, reason))
        informer.register_callback(
            StateKind.NODE_SLO,
            lambda kind, slo: setattr(self.ctx, "node_slo", slo))
        self.manager = QoSManager(self.ctx, [
            CPUSuppress(), CPUEvictor(), MemoryEvictor(), CPUBurst(),
            ResctrlReconcile(), CgroupResourcesReconcile(), BlkIOReconcile(),
            SystemConfigReconcile()])
        self.pressed = i in pressure["memory"]
        self.starved = i in pressure["starved"]
        self.share = float(pressure["share"][i])
        self.rng = np.random.default_rng([QOS_SEED, i])
        self.cores = node.allocatable[cpu] // 1000
        self.total_kb = int(draw["total_kb"][i])
        self.jiffies = int(draw["jiffies"][i, KOORD_TICKS - 1])
        self.ns = {u: int(draw["pod_ns"][i, j, KOORD_TICKS - 1])
                   for j, u in enumerate(tm["uids"][name])}

    def setup(self, root) -> None:
        """The kubelet's dirs of every running pod (every v1 subsystem) and
        the tiers, the topology (``read_cpu_infos`` for the cpuset policy),
        the resctrl tree, /proc/sys/vm, the seeded usage of every pod, the
        burst pod's quota and the starved tier's; the PLEG's primer."""
        cfg = self.cfg
        for d in ("kubepods", "kubepods/besteffort", "kubepods/burstable"):
            ensure_cgroup_dir(d, cfg)
        koord_topology_tree(os.path.join(root, self.name), self.cores,
                            "AuthenticAMD" if self.i % 4 == 3
                            else "GenuineIntel")
        self.ctx.cpu_infos = [
            CPUInfo(cpu_id=x.cpu_id, core_id=x.core_id,
                    socket_id=x.socket_id, node_id=x.node_id)
            for x in read_cpu_infos(cfg)]
        resctrl_fake(cfg, 11 + self.i % 9, 2)
        os.makedirs(os.path.join(cfg.proc_root, "sys", "vm"), exist_ok=True)
        self.rate, self.bytes = {}, {}
        be_request = 0
        for meta in sorted(self.informer.running_pods(), key=lambda m: m.uid):
            ensure_cgroup_dir(meta.cgroup_dir, cfg)
            for c in meta.containers.values():
                ensure_cgroup_dir(c, cfg)
            batch = meta.batch_resources.values()
            cpu = meta.cpu_request_mcpu or sum(b.request_mcpu for b in batch)
            mem = meta.memory_request_mib or sum(
                b.memory_limit_bytes or 0 for b in batch) // 2**20
            share = self.rng.uniform(0.2, 0.9)
            if self.starved and meta.qos is QoSClass.BE and \
                    meta.cpu_request_mcpu:
                # the starved pods run at the tier's limit
                share = 0.5
                be_request += meta.cpu_request_mcpu
            self.rate[meta.uid] = share * cpu / 1000.0
            self.bytes[meta.uid] = int(self.rng.uniform(0.4, 0.9) * mem
                                       * 2**20)
            self.ns.setdefault(meta.uid, int(self.rng.integers(10**9,
                                                               10**10)))
            if meta.name.startswith("burst-"):
                for d in (meta.cgroup_dir, *meta.containers.values()):
                    put_file(CPU_CFS_QUOTA, d, cfg, quota_text(cfg, 200000))
        if self.starved:
            # the tier's quota at half the BE pods' CPU request: a
            # satisfaction of 50%, under the band's 60%
            put_file(CPU_CFS_QUOTA, "kubepods/besteffort", cfg,
                     quota_text(cfg, be_request * 100 // 2))
        self.sys_cores = self.rng.uniform(0.05, 0.3) * self.cores
        self.sys_kb = int(self.rng.integers(2**20, 2**22))
        pods_kb = sum(self.bytes.values()) // 1024
        self.extra_kb = (max(int(self.share * self.total_kb) - pods_kb
                             - self.sys_kb, 0) if self.pressed else 0)
        self.pleg = PLEG(cfg)
        self.pleg.poll()

    def tick(self, k) -> None:
        """The tree at tick ``k`` (the live pods' counters, /proc/stat and
        meminfo, the burst pod throttled 30% of its periods), then the
        collectors."""
        cfg = self.cfg
        live = sorted(self.informer.running_pods(), key=lambda m: m.uid)
        busy = self.sys_cores + sum(self.rate[m.uid] for m in live)
        self.jiffies += int(round(busy * 100 * KOORD_STEP_S))
        with open(os.path.join(cfg.proc_root, "stat"), "w") as f:
            f.write(f"cpu  {self.jiffies} 0 0 {10**9 + 3000 * k} 0 0 0 0 0 "
                    "0\n")
        used = (sum(self.bytes[m.uid] for m in live) // 1024 + self.sys_kb
                + self.extra_kb)
        with open(os.path.join(cfg.proc_root, "meminfo"), "w") as f:
            f.write(f"MemTotal: {self.total_kb} kB\nMemFree: 0 kB\n"
                    f"MemAvailable: {max(self.total_kb - used, 0)} kB\n")
        for m in live:
            self.ns[m.uid] += int(round(self.rate[m.uid] * KOORD_STEP_S
                                        * 1e6)) * 1000
            throttle = ((100 * k, 30 * k) if m.name.startswith("burst-")
                        else None)
            put_file(CPU_ACCT_USAGE, m.cgroup_dir, cfg,
                     cpu_counter(cfg, self.ns[m.uid], throttle))
            if throttle is not None and not cfg.use_cgroup_v2:
                put_file(CPU_STAT, m.cgroup_dir, cfg,
                         f"nr_periods {throttle[0]}\nnr_throttled "
                         f"{throttle[1]}\n")
            put_file(MEMORY_USAGE, m.cgroup_dir, cfg, str(self.bytes[m.uid]))
        self.advisor.tick(koord_now(k))


def pods_by_node(bus) -> dict:
    """The bus's bound pods by node, each node's sorted by uid."""
    out = {}
    for pod in bus.list(Kind.POD).values():
        if pod.node_name:
            out.setdefault(pod.node_name, []).append(pod)
    for pods in out.values():
        pods.sort(key=lambda p: p.uid)
    return out


def koord_fill_one(cache, samples, i, uids, now, memory=None) -> None:
    """Append node ``i``'s samples of phase 21's last tick at ``now``
    (``memory`` in place of the node's when given)."""
    kinds, last = MetricKind, -1
    mem = samples["node_mem"][i][last] if memory is None else memory
    cache.append(kinds.NODE_MEMORY_USAGE, None, now, mem)
    cache.append(kinds.SYS_MEMORY_USAGE, None, now,
                 samples["sys_mem"][i][last])
    cache.append(kinds.NODE_CPU_USAGE, None, now, samples["node_cpu"][i][last])
    cache.append(kinds.SYS_CPU_USAGE, None, now, samples["sys_cpu"][i][last])
    for j, u in enumerate(uids):
        cache.append(kinds.POD_MEMORY_USAGE, {"pod": u}, now,
                     samples["pod_mem"][i][j][last])
        cache.append(kinds.POD_CPU_USAGE, {"pod": u}, now,
                     samples["pod_cpu"][i][j][last])


def qos_actuation(bus, sched, tm, spec, draw, root) -> dict:
    """Phase 22 (a)-(d) up to the round, on phase 21's world after round 1
    (on the card's or the CPU's: the same code). Returns what the round
    and the comparison need: the victims (node, reason, uid, cgroup dir,
    re-created uid) in order, the PLEG's events, the agents' trees, the
    reports, the synced count and batch allocatable, the snapshot before
    the round, the round's time and the timings."""
    names = [x["name"] for x in spec["nodes"]]
    agent_names = names[:KOORD_AGENTS]
    clock_now = [koord_now() + 2.0]
    clock = lambda: clock_now[0]  # noqa: E731
    victims, recreated, agents = [], {}, {}

    def evict(node, metas, reason):
        """The eviction glue: delete from the bus (the agent's
        ``KoordletLoop`` drops the pod), remove its dirs from the agent's
        tree, re-create it unbound under a new name."""
        for meta in metas:
            pod = bus.get(Kind.POD, meta.uid)
            bus.delete(Kind.POD, meta.uid)
            if node in agents:
                remove_pod_dirs(agents[node].cfg, meta.cgroup_dir)
            new = ttypes.PodSpec(name=f"{pod.name}-r", qos=pod.qos,
                                 priority=pod.priority,
                                 requests=dict(pod.requests),
                                 limits=dict(pod.limits),
                                 creation_time=clock_now[0])
            bus.apply(Kind.POD, new.uid, new)
            victims.append((node, reason, meta.uid, meta.cgroup_dir, new.uid))
            recreated[new.uid] = node
        return [m.uid for m in metas]

    tm_ = {}
    by_node = pods_by_node(bus)
    be_host = [bool(any(p.qos == QoSClass.BE for p in by_node.get(n, ())))
               for n in names]
    pressure = qos_pressure(
        names, [i for i in range(KOORD_AGENTS) if be_host[i]],
        [i for i in range(KOORD_AGENTS, len(names)) if be_host[i]])
    # (a) the agents' QoS wiring; the NodeSLO through the manager's loop
    t0 = time.perf_counter()
    for i, name in enumerate(agent_names):
        agents[name] = QosAgent(tm, bus, draw, i, name, pressure, evict,
                                clock)
    manager = tm["manager"]
    manager.nodeslo = qos_slo_controller(pressure["policies"])
    manager.reconcile(now=clock_now[0])
    tm_["wiring"] = time.perf_counter() - t0
    for a in agents.values():
        t = a.ctx.node_slo.resource_used_threshold_with_be
        assert t.enable and t.memory_evict_threshold_percent == \
            QOS_MEMORY_EVICT, a.name
        assert t.cpu_suppress_policy == pressure["policies"][a.name], a.name
    # (b) the pressure
    t0 = time.perf_counter()
    rng = np.random.default_rng(QOS_SEED + 1)
    for i, name in enumerate(agent_names):
        for pod in qos_residents(name, i, pressure["starved"], rng):
            bus.apply(Kind.POD, pod.uid, pod)
    for a in agents.values():
        a.setup(root)
    tm_["setup"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k in range(KOORD_TICKS, KOORD_TICKS + QOS_PRESSURE_TICKS):
        for a in agents.values():
            a.tick(k)
    tm_["pressure_ticks"] = time.perf_counter() - t0
    t_qos = koord_now(KOORD_TICKS + QOS_PRESSURE_TICKS - 1)
    clock_now[0] = t_qos
    t0 = time.perf_counter()
    by_node = pods_by_node(bus)
    fed, fed_mem = {}, {}
    pressed = set(pressure["pressed"])
    for i in range(KOORD_AGENTS, len(names)):
        name = names[i]
        informer = tm["informers"][name]
        metas = [pod_meta_from_spec(p) for p in by_node.get(name, ())]
        informer.set_pods(metas)
        if i not in pressed:
            continue
        node = bus.get(Kind.NODE, name)
        cache = tm["reporters"][name].metric_cache
        cache.append(MetricKind.NODE_MEMORY_USAGE, None, t_qos,
                     float(pressure["share"][i]
                           * node.allocatable[ResourceName.MEMORY]))
        mem = fed_mem[name] = {}
        for m in metas:
            if m.qos is QoSClass.BE:
                batch = sum(b.memory_limit_bytes or 0
                            for b in m.batch_resources.values()) // 2**20
                mem[m.uid] = float(int(rng.uniform(0.4, 0.9)
                                       * (m.memory_request_mib or batch)))
                cache.append(MetricKind.POD_MEMORY_USAGE, {"pod": m.uid},
                             t_qos, mem[m.uid])
        cfg = SystemConfig(cgroup_root=os.path.join(root, name, "cg"),
                           proc_root=os.path.join(root, name, "proc"),
                           sysfs_root=os.path.join(root, name, "sys"))
        ctx = QoSContext(
            metric_cache=cache, executor=ResourceUpdateExecutor(cfg),
            pod_provider=informer, system_config=cfg,
            node_slo=bus.get(Kind.NODE_SLO, name),
            node_capacity_mcpu=node.allocatable[ResourceName.CPU],
            node_capacity_mem_mib=node.allocatable[ResourceName.MEMORY],
            evict=lambda metas, reason, n=name: evict(n, metas, reason))
        fed[name] = QoSManager(ctx, [MemoryEvictor()])
    tm_["fed_setup"] = time.perf_counter() - t0
    # (c) the QoS ticks
    t0 = time.perf_counter()
    for a in agents.values():
        a.manager.tick(t_qos)
    tm_["agents_qos"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name, mgr in fed.items():
        mgr.tick(t_qos)
    tm_["fed_qos"] = time.perf_counter() - t0
    assert len(recreated) >= len(pressed), (len(recreated), len(pressed))
    t0 = time.perf_counter()
    pleg = {name: [(e.event.name, e.cgroup_dir) for e in a.pleg.poll()]
            for name, a in agents.items()}
    for name, events in pleg.items():
        mine = sorted(v[3] for v in victims if v[0] == name)
        assert sorted(d for ev, d in events if ev == "POD_DELETED") == mine, (
            name, events, mine)
        assert all(ev == "POD_DELETED" or (ev == "CONTAINER_DELETED" and
                                           os.path.dirname(d) in mine)
                   for ev, d in events), (name, events)
    tm_["pleg"] = time.perf_counter() - t0
    # (d) collect, report, reconcile
    k = KOORD_TICKS + QOS_PRESSURE_TICKS
    t_report = koord_now(k)
    clock_now[0] = t_report
    t0 = time.perf_counter()
    for a in agents.values():
        a.tick(k)
    tm_["post_tick"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    samples = koord_samples(draw)
    by_node = pods_by_node(bus)
    for i in range(KOORD_AGENTS, len(names)):
        name = names[i]
        tm["informers"][name].set_pods(
            [pod_meta_from_spec(p) for p in by_node.get(name, ())])
        memory = None
        if i in pressed:
            gone = sum(v for u, v in fed_mem[name].items()
                       if bus.get(Kind.POD, u) is None)
            memory = float(pressure["share"][i] * bus.get(
                Kind.NODE, name).allocatable[ResourceName.MEMORY]) - gone
        koord_fill_one(tm["reporters"][name].metric_cache, samples, i,
                       tm["uids"][name], t_report, memory)
    reports = {}
    for name in names:
        if name in tm["loops"]:
            reports[name] = tm["loops"][name].report(t_report)
        else:
            reports[name] = tm["reporters"][name].report(t_report)
            bus.apply(Kind.NODE_METRIC, name, reports[name])
    tm_["reports"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    synced = manager.reconcile(now=t_report)
    tm_["reconcile"] = time.perf_counter() - t0
    pods = bus.list(Kind.POD).values()
    pending = sorted((p for p in pods if not p.node_name),
                     key=lambda p: p.uid)
    snap = ClusterSnapshot(nodes=list(bus.list(Kind.NODE).values()),
                           pods=[p for p in pods if p.node_name],
                           pending_pods=pending)
    t0 = time.perf_counter()
    trees = {n: tree_files(os.path.join(root, n)) for n in agent_names}
    tm_["trees"] = time.perf_counter() - t0
    return dict(victims=victims, recreated=recreated, pleg=pleg,
                trees=trees, reports=reports, synced=synced,
                batch=batch_of(bus), snap=snap, t_round=t_report + 1.0,
                pressure=pressure, timings=tm_,
                audits=sum(len(a.auditor.query()) for a in agents.values()))


def tree_files(root) -> dict:
    """Every file under ``root``: relative path -> content."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path) as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def qos_result(out, result) -> dict:
    """What phase 22's CPU run is held to: the victims in order, the
    PLEG's events, the agents' trees, the reports, the synced count, the
    batch allocatable and the round's placements."""
    return dict(victims=out["victims"], pleg=out["pleg"], trees=out["trees"],
                reports=out["reports"], synced=out["synced"],
                batch=out["batch"], placed=dict(result),
                waiting=dict(result.waiting))


def qos_replacement(card, world, spec, draw, root):
    """Phase 22 on the card, on phase 21's world after round 1. Returns
    ``(its kernels entry, what the CPU run is held to)``."""
    out = qos_actuation(world["bus"], world["sched"], world["tm"], spec,
                        draw, root)
    tm, pr, snap = out["timings"], out["pressure"], out["snap"]
    label = (f"the QoS re-placement round, {NODES} x "
             f"{len(snap.pending_pods)}")
    result, launches, wall, captured = drive(
        lambda: world["sched"].schedule_pending(now=out["t_round"]),
        clone=True)
    inp, route = routed(label, launches, captured, "cluster")
    assert route.shards == 5, route
    capacity_ok(snap, result)
    placed = {u: n for u, n in result.items() if n is not None}
    recreated = out["recreated"]
    replaced = [u for u in recreated if u in placed or u in result.waiting]
    back = sum(placed.get(u) == n for u, n in recreated.items())
    assert replaced, "no victim re-placed"
    by_reason = Counter(v[1] for v in out["victims"])
    agent_victims = Counter(v[1] for v in out["victims"]
                            if v[0] in world["tm"]["loops"])
    pleg_deleted = sum(ev == "POD_DELETED" for evs in out["pleg"].values()
                       for ev, _ in evs)
    memory_reason, cpu_reason = ("evict by node memory usage",
                                 "evict by BE cpu satisfaction")
    assert agent_victims[memory_reason] > 0 and agent_victims[cpu_reason] > 0
    print(f"koordlet QoS wiring [{card}]: {KOORD_AGENTS} agents' QoSContext "
          f"and QoSManager of 8 strategies; NodeSLO (BE thresholds: memory "
          f"evict {QOS_MEMORY_EVICT}%, CPU suppress {QOS_CPU_SUPPRESS}%, CPU "
          f"evict satisfaction {QOS_SATISFACTION[0]}-{QOS_SATISFACTION[1]}%; "
          f"cpuset on {sum(v == 'cpuset' for v in pr['policies'].values())} "
          f"agents, cfsQuota on "
          f"{sum(v == 'cfsQuota' for v in pr['policies'].values())}; cgroup "
          f"v2 on {sum(koord_v2(i) for i in range(KOORD_AGENTS))}) published "
          f"to {NODES} nodes by the manager's reconcile: {tm['wiring']:.3f} "
          f"s", flush=True)
    print(f"koordlet QoS pressure [{card}]: {len(pr['memory'])} agents over "
          f"the memory threshold, {len(pr['starved'])} with the BE tier "
          f"starved, {len(pr['pressed'])} nodes fed directly over it; setup "
          f"{tm['setup']:.3f} s, {QOS_PRESSURE_TICKS} collector ticks "
          f"{tm['pressure_ticks']:.3f} s, the fed nodes' setup "
          f"{tm['fed_setup']:.3f} s", flush=True)
    print(f"koordlet QoS ticks [{card}]: the agents' 8 strategies "
          f"{tm['agents_qos']:.3f} s ({out['audits']} audit events), "
          f"{len(out['pressure']['pressed'])} memory evictors "
          f"{tm['fed_qos']:.3f} s; victims {len(out['victims'])}: "
          f"memoryevict {by_reason[memory_reason]} "
          f"({agent_victims[memory_reason]} on agents), cpuevict "
          f"{by_reason[cpu_reason]} ({agent_victims[cpu_reason]} on "
          f"agents); the PLEGs reported exactly the victims "
          f"({pleg_deleted} POD_DELETED) in {tm['pleg']:.3f} s; the "
          f"agents' trees read back in {tm['trees']:.3f} s "
          f"({sum(len(x) for x in out['trees'].values())} files)",
          flush=True)
    print(f"{label} [{card}]: collectors {tm['post_tick']:.3f} s, {NODES} "
          f"reports {tm['reports']:.3f} s, reconcile {tm['reconcile']:.3f} s "
          f"({out['synced']} synced); {len(snap.pending_pods)} pending "
          f"({len(recreated)} re-created, "
          f"{len(snap.pending_pods) - len(recreated)} left from round 1): "
          f"{len(placed)} committed, {len(result.waiting)} waiting, "
          f"{len(replaced)} victims re-placed, {back} on a node that "
          f"evicted them; every placement within its node's allocatable "
          f"after the PATCH; wall {wall:.4f} s; route {route_name(route)}, "
          f"launches {launches[route.kind]}", flush=True)
    stats = compare(inp, label, card, reps=3)
    return (entry("binpack_qos_replacement_round", launches[route.kind],
                  stats, 317), qos_result(out, result))


# -- phase 23: the koordlet binary acts on the card's placements ---------------


def hooks_now(k=0) -> float:
    """Phase 23's fake clock: the agents' first tick after round 2 (at
    ``koord_now() + 1``), then one reconcile interval a step."""
    return koord_now() + 2.0 + HOOKS_RECONCILE_S * k


def cpu_list(cpus) -> str:
    """A CPU set as a cpu-list string ("0-3,8")."""
    out, start, prev = [], None, None
    for c in sorted(cpus) + [None]:
        if c is not None and prev is not None and c == prev + 1:
            prev = c
            continue
        if start is not None:
            out.append(f"{start}" if start == prev else f"{start}-{prev}")
        start = prev = c
    return ",".join(out)


def hooks_topo(nrt) -> NodeTopoInfo:
    """The share pools an agent takes from its NRT: each NUMA node's CPUs
    less the reserved ones, for LS and BE pods alike."""
    node_of = [int(n) for n in nrt.cpu_topology.node_id]
    reserved = set(nrt.reserved_cpus)
    pools = {numa: cpu_list(c for c, n in enumerate(node_of)
                            if n == numa and c not in reserved)
             for numa in sorted(set(node_of))}
    return NodeTopoInfo(share_pools=pools, be_share_pools=dict(pools))


def hooks_wave():
    """Phase 23's second wave: HOOKS_WAVE seeded pods, a half LSR pods
    asking 2-8 whole CPUs (a cpuset), the rest LS pods asking 1-2
    ``nvidia.com/gpu`` with a CPU limit (the cpu-share pods the
    normalization rescales)."""
    rng = np.random.default_rng(HOOKS_SEED)
    pods = []
    for j in range(HOOKS_WAVE):
        mem = int(rng.integers(1024, 8192))
        if j % 2 == 0:
            cpu = 1000 * int(rng.integers(2, 9))
            pods.append(ttypes.PodSpec(
                name=f"wave-cpuset-{j}", qos=QoSClass.LSR, requests={
                    ResourceName.CPU: cpu, ResourceName.MEMORY: mem},
                limits={ResourceName.CPU: cpu}, creation_time=KOORD_T0))
        else:
            cpu = int(rng.integers(1000, 4000))
            pods.append(ttypes.PodSpec(
                name=f"wave-gpu-{j}", qos=QoSClass.LS, requests={
                    ResourceName.CPU: cpu, ResourceName.MEMORY: mem},
                limits={ResourceName.CPU: cpu},
                device_requests={"nvidia.com/gpu": int(rng.integers(1, 3))},
                creation_time=KOORD_T0))
    return pods


def hooks_nri(i) -> bool:
    """NRI mode on half the agents, crossed with the cgroup version."""
    return (i // 2) % 2 == 0


def hooks_dirs(cfg, pod) -> None:
    """What the kubelet makes of a pod bound to the node: its dirs."""
    meta = pod_meta_from_spec(pod)
    ensure_cgroup_dir(meta.cgroup_dir, cfg)
    for cdir in meta.containers.values():
        ensure_cgroup_dir(cdir, cfg)


def hooks_events(auditor, root) -> list:
    """An audit log oldest first, paths relative to ``root``, without the
    wall-clock timestamps."""
    return [(e.group, os.path.relpath(e.subject, root)
             if e.subject.startswith(root) else e.subject, e.operation,
             e.detail.replace(root, "<root>"))
            for e in reversed(auditor.query())]


def hooks_read(res, d, cfg):
    return res.decode(res.read(d, cfg), cfg)


def hooks_pins(bus, agents) -> tuple:
    """Every container of a pod whose resource-status carries a cpuset
    holds it in its cpuset file, with cfs quota -1 on the pod and the
    container; every GPU pod's container env from
    ``RuntimeHookServer.create_container`` names exactly the minors of
    its device-allocated. Returns ``(responses, pinned pods, GPU pods)``."""
    responses, pinned, gpus = {}, 0, 0
    for name, daemon in agents.items():
        cfg = daemon.executor.config
        hooks = daemon.runtime_hooks
        for meta in daemon.states_informer.running_pods():
            spec = bus.get(Kind.POD, meta.uid)
            cpuset = cpuset_from_annotation(spec.annotations)
            if cpuset is not None:
                pinned += 1
                assert hooks_read(CPU_CFS_QUOTA, meta.cgroup_dir, cfg) == "-1"
                for cdir in meta.containers.values():
                    assert hooks_read(CPU_SET, cdir, cfg) == cpuset, meta.uid
                    assert hooks_read(CPU_CFS_QUOTA, cdir, cfg) == "-1"
            for c in meta.containers:
                res = hooks.server.create_container(meta, c, apply=False)
                responses[f"{meta.uid}/{c}"] = dataclasses.asdict(res)
            raw = spec.annotations.get(ANNOTATION_DEVICE_ALLOCATED)
            if raw:
                gpus += 1
                minors = ",".join(str(d["minor"])
                                  for d in json.loads(raw)["gpu"])
                env = responses[f"{meta.uid}/main"]["add_envs"]
                assert env["NVIDIA_VISIBLE_DEVICES"] == minors, meta.uid
    return responses, pinned, gpus


def hooks_error_list(daemon) -> list:
    """Every hook failure of ``daemon``'s registry from here on. The
    reconciler and the servers run the hooks under IGNORE with no error
    list, so a failing hook would pass silently: the registry's
    ``run_hooks`` gets the returned list wherever its caller gave none."""
    registry = daemon.runtime_hooks.registry
    run, collected = registry.run_hooks, []

    def collecting(stage, proto, fail_policy=FailurePolicy.IGNORE,
                   errors=None):
        run(stage, proto, fail_policy,
            collected if errors is None else errors)

    registry.run_hooks = collecting
    return collected


def hooks_fake_cpi(daemon) -> dict:
    """(e)'s CPI collector in ``daemon``'s advisor context over
    ``PerfGroup.fake`` sources (seeded steps a container, in the order
    the collector opens them), HOOKS_CPI_TICKS collects 30 s apart:
    every CONTAINER_CPI series."""
    rng = np.random.default_rng(HOOKS_SEED + 1)
    steps = {}

    def fake(cdir):
        steps.setdefault(cdir, (int(rng.integers(1000, 9000)),
                                int(rng.integers(500, 4000))))
        return PerfGroup.fake(*steps[cdir])

    collector = PerformanceCollector(source_factory=fake)
    collector.setup(daemon.collector_ctx)
    for k in range(HOOKS_CPI_TICKS):
        collector.collect(hooks_now(k))
    series = {}
    for meta in daemon.states_informer.running_pods():
        for c in meta.containers:
            t, v = daemon.metric_cache.query(
                MetricKind.CONTAINER_CPI, {"pod": meta.uid, "container": c})
            series[f"{meta.uid}/{c}"] = (t.tolist(), v.tolist())
    assert series and all(len(v[0]) == HOOKS_CPI_TICKS - 1
                          for v in series.values()), series
    return series


def hooks_actuation(bus, sched, names, root, drive_fn=None,
                    after_a=None) -> dict:
    """Phase 23 (a)-(c) and (e)'s collector on the world of phase 21 (d)
    after its round (``sched`` wired to ``bus``; ``names`` its nodes, whose
    trees are under ``root``), on ``sched``'s device; ``drive_fn(run)``
    runs the wave's round (the card's captures its solves), and
    ``after_a(configs by node)`` runs once (a) has checked. Returns what
    the card's run and the CPU run are held equal on (``out``), the
    timings and the wave's round."""
    tm, out = {}, {}
    pods_on = {}
    for pod in bus.list(Kind.POD).values():
        if pod.node_name and not pod.waiting_permit:
            pods_on.setdefault(pod.node_name, []).append(pod)

    # (a) an agent a node from build_koordlet, over its own tree
    t0 = time.perf_counter()
    cfgs = {}
    for i, name in enumerate(names):
        cfg = cfgs[name] = SystemConfig(
            cgroup_root=os.path.join(root, name, "cg"),
            proc_root=os.path.join(root, name, "proc"),
            sysfs_root=os.path.join(root, name, "sys"),
            use_cgroup_v2=koord_v2(i))
        for d in ("kubepods", "kubepods/burstable", "kubepods/besteffort"):
            ensure_cgroup_dir(d, cfg)
        for pod in pods_on.get(name, []):
            hooks_dirs(cfg, pod)
    tm["dirs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    agents, errors = {}, {}
    for i, name in enumerate(names):
        cfg = cfgs[name]
        agents[name] = build_koordlet(KoordletConfig(
            cgroup_root=cfg.cgroup_root, proc_root=cfg.proc_root,
            use_cgroup_v2=cfg.use_cgroup_v2, feature_gates=HOOKS_GATES,
            runtime_hooks_mode="nri" if hooks_nri(i) else "reconciler",
            reconcile_interval_seconds=HOOKS_RECONCILE_S))
        errors[name] = hooks_error_list(agents[name])
    tm["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name in names:
        wire_koordlet(bus, agents[name].states_informer, name)
    tm["wire"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    slo = sloconfig.NodeSLOSpec()
    for tier in ("lsr", "ls", "be"):
        getattr(slo.resource_qos_strategy, tier).enable = True
    for name in names:
        bus.apply(Kind.NODE_SLO, name, slo)
    tm["slo"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name in names:
        agents[name].runtime_hooks.set_node_topo(hooks_topo(
            bus.get(Kind.NODE_RESOURCE_TOPOLOGY, name)))
    tm["topo"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name in names:
        agents[name].tick(hooks_now())
    tm["tick"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    responses, pinned, gpus = hooks_pins(bus, agents)
    assert pinned > 0 and gpus > 0, (pinned, gpus)
    rule = {"kubepods": "0", "kubepods/burstable": "2",
            "kubepods/besteffort": "-1"}
    for name, daemon in agents.items():
        cfg = daemon.executor.config
        for d, want in rule.items():
            assert hooks_read(CPU_BVT_WARP_NS, d, cfg) == want, (name, d)
        for meta in daemon.states_informer.running_pods():
            assert hooks_read(CPU_BVT_WARP_NS, meta.cgroup_dir, cfg) == (
                "2" if meta.qos is not QoSClass.BE else "-1"), meta.uid
    tm["check"] = time.perf_counter() - t0
    out["a"] = dict(responses=responses, pinned=pinned, gpus=gpus)
    if after_a is not None:
        after_a(cfgs)

    # (b) a second wave on the card, then deletions
    wave = hooks_wave()
    for pod in wave:
        bus.apply(Kind.POD, pod.uid, pod)
    perf = None
    if drive_fn is not None:
        try:
            perf = PerfGroup.open_self()
            before = perf.read()
        except PerfUnavailable as e:
            perf = e
    t0 = time.perf_counter()
    run = lambda: sched.schedule_pending(now=hooks_now(1))  # noqa: E731
    result, record = (run(), None) if drive_fn is None else drive_fn(run)
    tm["wave_round"] = time.perf_counter() - t0
    if isinstance(perf, PerfGroup):
        after = perf.read()
        perf.close()
        perf = (after[0] - before[0], after[1] - before[1])
    bound = [p for p in wave if result[p.uid] is not None
             and p.uid not in result.waiting]
    assert len(bound) > HOOKS_WAVE // 2, len(bound)
    t0 = time.perf_counter()
    for pod in bound:
        hooks_dirs(cfgs[result[pod.uid]], bus.get(Kind.POD, pod.uid))
    for i, name in enumerate(names):
        if hooks_nri(i):
            agents[name].pleg.poll()
        else:
            agents[name].tick(hooks_now(1))
    tm["wave_hooks"] = time.perf_counter() - t0
    wave_responses, w_pinned, w_gpus = hooks_pins(bus, agents)
    assert w_pinned > pinned and w_gpus > gpus, (w_pinned, w_gpus)
    nri_added = {n: dict(agents[n].nri_server.handled)
                 for i, n in enumerate(names) if hooks_nri(i)}
    assert sum(h.get("RunPodSandbox", 0) for h in nri_added.values()) == sum(
        hooks_nri(names.index(result[p.uid])) for p in bound)
    # phase 24 (d): the CRI proxy on the wave's placements
    t0 = time.perf_counter()
    out["proxy"] = cri_proxy(bus, agents, bound, wave_responses)
    out["proxy"]["replies"] = proxy_in_process(out["proxy"]["frames"])
    tm["proxy"] = time.perf_counter() - t0
    rng = np.random.default_rng(HOOKS_SEED + 2)
    candidates = sorted(p.uid for p in bus.list(Kind.POD).values()
                        if p.node_name and not p.waiting_permit
                        and ANNOTATION_RESOURCE_STATUS in p.annotations)
    gone = [bus.get(Kind.POD, candidates[int(k)]) for k in sorted(rng.choice(
        len(candidates), HOOKS_DELETED, replace=False))]
    t0 = time.perf_counter()
    for pod in gone:
        bus.delete(Kind.POD, pod.uid)
        remove_pod_dirs(cfgs[pod.node_name],
                        pod_meta_from_spec(pod).cgroup_dir)
    for i, name in enumerate(names):
        if hooks_nri(i):
            agents[name].pleg.poll()
        else:
            agents[name].tick(hooks_now(2))
    tm["deletions"] = time.perf_counter() - t0
    for pod in gone:
        meta = pod_meta_from_spec(pod)
        cfg = cfgs[pod.node_name]
        for d in [meta.cgroup_dir, *meta.containers.values()]:
            assert not os.path.exists(CPU_SET.path(d, cfg)), d
    stops = {n: dict(agents[n].nri_server.handled)
             for i, n in enumerate(names) if hooks_nri(i)}
    assert sum(h.get("StopPodSandbox", 0) for h in stops.values()) > 0
    out["b"] = dict(placed=dict(result), waiting=dict(result.waiting),
                    responses=wave_responses,
                    gone=[p.uid for p in gone], nri=[nri_added, stops])

    # (c) the cpu-normalization ratio on half the nodes, then removed from
    # a quarter: rescaled, then restored once
    t0 = time.perf_counter()
    scaled, restored = names[: len(names) // 2], names[: len(names) // 4]
    quotas, subjects = [], 0
    for step, (ratio, which) in enumerate(((HOOKS_RATIO, scaled),
                                           (None, restored))):
        for name in which:
            node = bus.get(Kind.NODE, name)
            ann = dict(node.annotations)
            ann.pop(ANNOTATION_CPU_NORMALIZATION_RATIO, None)
            if ratio is not None:
                ann[ANNOTATION_CPU_NORMALIZATION_RATIO] = str(ratio)
            bus.apply(Kind.NODE, name, dataclasses.replace(
                node, annotations=ann))
        for name in which:
            agents[name].tick(hooks_now(3 + step))
        seen = {}
        for name in names:
            daemon = agents[name]
            cfg = daemon.executor.config
            for meta in daemon.states_informer.running_pods():
                if meta.qos is not QoSClass.LS or meta.cpu_limit_mcpu <= 0:
                    continue
                subjects += step == 0
                path = CPU_CFS_QUOTA.path(meta.cgroup_dir, cfg)
                got = seen[meta.uid] = (
                    hooks_read(CPU_CFS_QUOTA, meta.cgroup_dir, cfg)
                    if os.path.exists(path) else None)
                spec = milli_cpu_to_quota(meta.cpu_limit_mcpu)
                if name in restored and step == 1:
                    assert got == str(spec), (meta.uid, got, spec)
                elif name in scaled:
                    assert got == str(math.ceil(spec / HOOKS_RATIO)), (
                        meta.uid, got)
                else:
                    assert got is None, (meta.uid, got)
        quotas.append(seen)
    assert subjects > 0
    tm["normalization"] = time.perf_counter() - t0
    out["c"] = quotas
    out["cpi"] = hooks_fake_cpi(agents[names[0]])
    assert all(not e for e in errors.values()), {
        n: e for n, e in errors.items() if e}
    t0 = time.perf_counter()
    out["trees"] = {n: tree_files(os.path.join(root, n, "cg"))
                    for n in names}
    out["writes"] = {n: hooks_events(agents[n].executor.auditor, root)
                     for n in names}
    out["audit"] = {n: hooks_events(agents[n].auditor, root) for n in names}
    tm["read_back"] = time.perf_counter() - t0
    return dict(out=out, timings=tm, record=record, perf=perf,
                subjects=subjects, gone=len(gone), bound=len(bound))


def hooks_files(root) -> dict:
    """Every file under ``root``: bytes, or an ``.npz`` checkpoint's arrays
    (its zip headers carry the write's wall time)."""
    out = {}
    for d, _, names in os.walk(root):
        for f in names:
            path = os.path.join(d, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".npz"):
                with np.load(path) as z:
                    out[rel] = {k: z[k].tolist() for k in sorted(z.files)}
            else:
                with open(path, "rb") as fh:
                    out[rel] = fh.read()
    return out


def hooks_child_start(cfg, scratch) -> dict:
    """(d): ``python -m koordinator_tpu_torch.cmd.koordlet --once`` in NRI
    mode over a copy of one agent's tree (``cfg``), started; a second copy
    kept for :func:`hooks_child_finish`'s in-process run."""
    roots = {}
    for copy in ("child", "in_process"):
        roots[copy] = os.path.join(scratch, copy)
        for part in ("cg", "proc"):
            shutil.copytree(os.path.join(os.path.dirname(cfg.cgroup_root),
                                         part),
                            os.path.join(roots[copy], part))
    now = hooks_now(5)
    child = roots["child"]
    argv = ["--once", "--now", repr(now), "--runtime-hooks-mode", "nri",
            "--cgroup-root", os.path.join(child, "cg"),
            "--proc-root", os.path.join(child, "proc"),
            "--feature-gates", HOOKS_CHILD_GATES,
            "--checkpoint-dir", os.path.join(child, "ckpt")]
    if cfg.use_cgroup_v2:
        argv.append("--cgroup-v2")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "koordinator_tpu_torch.cmd.koordlet", *argv],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    child = dict(proc=proc, stamped=[], t0=t0, now=now, roots=roots,
                 v2=cfg.use_cgroup_v2)

    def read():
        for line in proc.stdout:
            child["stamped"].append((time.perf_counter(), line.rstrip("\n")))
        child["eof"] = time.perf_counter()

    child["reader"] = threading.Thread(target=read)
    child["reader"].start()
    return child


def hooks_child_finish(child) -> dict:
    """(d)'s child waited for (each line stamped as it arrived): exit 0,
    and its files equal an in-process ``build_koordlet(...).tick(now)``
    on the second copy, the checkpoints included. Returns its wall split
    into imports, build, the tick and the rest."""
    proc, t0 = child["proc"], child["t0"]
    try:
        rc = proc.wait(timeout=BINARY_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    child["reader"].join()
    stamped = child["stamped"]
    wall = child["eof"] - t0
    lines = [line for _, line in stamped]
    assert rc == 0, lines[-40:]
    built_at, built = next((t, x) for t, x in stamped
                           if x.startswith("koordlet: built"))
    ticked = next(x for x in lines if x.startswith("koordlet: tick returned"))
    build_s, tick_s = seconds_after(built, " in "), seconds_after(
        ticked, " after ")
    imports_s = built_at - t0 - build_s
    in_process = child["roots"]["in_process"]
    build_koordlet(KoordletConfig(
        feature_gates=HOOKS_CHILD_GATES, runtime_hooks_mode="nri",
        cgroup_root=os.path.join(in_process, "cg"),
        proc_root=os.path.join(in_process, "proc"),
        use_cgroup_v2=child["v2"],
        checkpoint_dir=os.path.join(in_process, "ckpt"))).tick(child["now"])
    got = hooks_files(child["roots"]["child"])
    want = hooks_files(in_process)
    assert "ckpt/metriccache.npz" in got and got == want, sorted(
        set(got) ^ set(want))
    return dict(wall=wall, imports=imports_s, build=build_s, tick=tick_s,
                rest=wall - imports_s - build_s - tick_s, files=len(got))


def koordlet_hooks(card, world, scratch) -> tuple:
    """Phase 23 on the card, on phase 21 (d)'s world after its round:
    :func:`hooks_actuation` with the wave's round driven on the card
    (every solve on the one-block kernel with extras rows, the final one
    held against its twin), then (d)'s child and (e)'s perf group. Returns
    ``(its kernels entry, what the CPU run is held to)``."""

    def drive_fn(run):
        result, launches, wall, captured = drive(run, clone=True)
        return result, (launches, wall, captured)

    names = world["names"]
    started = []
    proxy_child = proxy_binary_start()  # phase 24 (d)'s binary
    try:
        h = hooks_actuation(
            world["bus"], world["sched"], names, world["root"], drive_fn,
            after_a=lambda cfgs: started.append(hooks_child_start(
                cfgs[names[0]], scratch)))
    except BaseException:
        for child in started + [proxy_child]:
            if child["proc"].poll() is None:
                child["proc"].kill()
                child["proc"].wait()
        raise
    tm = h["timings"]
    launches, wall, captured = h["record"]
    assert captured and all(r.kind == "block" for _, r in captured), [
        r for _, r in captured]
    assert sum(launches.values()) == launches["block"] == len(captured), (
        launches, len(captured))
    inp, route = captured[-1]
    assert inp.extras is not None, "the wave's solve had no extras rows"
    n_nri = sum(hooks_nri(i) for i in range(len(names)))
    n_v2 = sum(koord_v2(i) for i in range(len(names)))
    out = h["out"]
    print(f"koordlet hooks (a) [{card}]: {len(names)} build_koordlet agents "
          f"({n_v2} on cgroup v2, {n_nri} in NRI mode, crossed; "
          f"{HOOKS_GATES}) over their trees: the kubelet's dirs "
          f"{tm['dirs']:.3f} s, build {tm['build']:.3f} s, wire_koordlet "
          f"{tm['wire']:.3f} s, the NodeSLO (group identity on) "
          f"{tm['slo']:.3f} s, the share pools from each NRT "
          f"{tm['topo']:.3f} s, one tick of the {len(names)} agents "
          f"{tm['tick']:.3f} s; {out['a']['pinned']} pods' cpusets in "
          f"their containers' files with cfs quota -1, "
          f"{out['a']['gpus']} GPU pods' env naming their minors (checked "
          f"in {tm['check']:.3f} s); no hook error", flush=True)
    label = (f"the koordlet hooks' second wave, {len(names)} x "
             f"{HOOKS_WAVE}")
    print(f"{label} [{card}]: {h['bound']} bound, wall {wall:.4f} s "
          f"({len(captured)} solves, every one on the one-block kernel with "
          f"extras rows); their hooks (the NRI half off the PLEG alone, the "
          f"reconciler half on its tick) {tm['wave_hooks']:.3f} s; "
          f"{h['gone']} pods deleted, their dirs removed, the NRI half's "
          f"stop stages and the reconcilers {tm['deletions']:.3f} s, no "
          f"stale cpuset", flush=True)
    stats = compare(inp, f"{label}, final solve", card, reps=3)
    print(f"koordlet hooks (c) [{card}]: ratio {HOOKS_RATIO} on "
          f"{len(names) // 2} nodes, removed from {len(names) // 4}: "
          f"{h['subjects']} cpu-share pods rescaled to ceil(q / "
          f"{HOOKS_RATIO}), the quarter's restored to their spec quotas, in "
          f"{tm['normalization']:.3f} s; the trees read back in "
          f"{tm['read_back']:.3f} s "
          f"({sum(len(t) for t in out['trees'].values())} files)",
          flush=True)
    proxy = out["proxy"]
    child = proxy_binary_finish(proxy_child, proxy["frames"],
                                proxy["replies"])
    PHASE24_TIMES.update(proxy=tm["proxy"], binary=child["tail"])
    print(f"CRI proxy (d) [{card}]: a kubelet stand-in's RunPodSandbox, "
          f"CreateContainer, StartContainer and StopContainer for "
          f"{PROXY_PODS} of the wave's pods through a "
          f"RuntimeManagerCriServer a node ({len(proxy['stores'])} nodes, "
          f"each agent's hook server, Fail policy, no hook error): every "
          f"one of the {proxy['created']} CreateContainer requests the "
          f"runtime saw carries its hooks' response ({proxy['pinned']} "
          f"cpusets == their files, {proxy['gpus']} GPU envs == their "
          f"minors); restarted, each proxy's fail_over rebuilt its store "
          f"from the runtime's pods; {tm['proxy']:.3f} s, this process's "
          f"binary proxy on {len(proxy['frames'])} frames included; "
          f"python -m "
          f"koordinator_tpu_torch.cmd.runtimeproxy --once on a short UDS "
          f"path (started beside phase 23): its reply frames == the "
          f"in-process proxy's; interpreter start and imports to "
          f"listening {child['start']:.3f} s, the exchange and exit "
          f"{child['tail']:.3f} s, wall {child['wall']:.3f} s", flush=True)
    split = hooks_child_finish(started[0])
    print(f"koordlet binary --once [{card}]: NRI mode over a copy of "
          f"{names[0]}'s tree ({HOOKS_CHILD_GATES}): exit 0, its "
          f"{split['files']} files (the checkpoint included) == an "
          f"in-process build_koordlet(...).tick(now) on a second copy; child "
          f"(run beside (b)-(c)) wall {split['wall']:.3f} s = interpreter start and imports "
          f"{split['imports']:.3f} s + build {split['build']:.3f} s + the "
          f"tick {split['tick']:.3f} s + the rest, process exit included "
          f"{split['rest']:.3f} s", flush=True)
    perf = h["perf"]
    if isinstance(perf, PerfUnavailable):
        print(f"koordlet CPI (e) [{card}]: PerfGroup.open_self() refused on "
              f"this machine: {perf}; the CPI collector over PerfGroup.fake "
              f"sources in {names[0]}'s agent: "
              f"{len(out['cpi'])} series", flush=True)
    else:
        cycles, instructions = perf
        print(f"koordlet CPI (e) [{card}]: PerfGroup.open_self() over the "
              f"wave's round (host side): {cycles} cycles, {instructions} "
              f"instructions (CPI {cycles / max(instructions, 1):.3f}); the "
              f"CPI collector over PerfGroup.fake sources in {names[0]}'s "
              f"agent: {len(out['cpi'])} series", flush=True)
    return (entry("binpack_koordlet_hooks_wave", launches["block"], stats,
                  259), out)


# -- phase 24: the warm pool on the card and the CRI proxy -------------------


def warm_child(addr, port, store, log, *extra):
    """A ``cmd.solver`` child on ``addr`` with its debug mux on ``port`` and
    ``store`` as its warm store (empty: none); its output appended to
    ``log``."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(log, "ab") as out:
        return subprocess.Popen(
            [sys.executable, "-m", "koordinator_tpu_torch.cmd.solver",
             "--listen", addr, "--debug-port", str(port), *CHILD_ARGV,
             *extra], cwd=root, stdout=out, stderr=subprocess.STDOUT,
            env=dict(os.environ, KTPU_COMPILATION_CACHE_DIR=store))


def warm_status(port) -> dict:
    return mux_get(port, "/apis/v1/plugins/warm-pool")


def wait_for(what, check, timeout_s=BINARY_TIMEOUT_S, step=0.05):
    """Poll ``check()`` (exceptions count as not yet) until it is truthy;
    returns it."""
    t0 = time.perf_counter()
    while True:
        try:
            got = check()
        except (OSError, ValueError):
            got = None
        if got:
            return got
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(step)


def warm_ready(addr, port, proc):
    """Wait until a child accepts solves and its debug mux answers (with
    its warm-pool section, or its solver section without a pool)."""
    def ready():
        assert proc.poll() is None, f"the child at {addr} exited"
        return connection_probe(addr) and (
            warm_status(port) if port is not None
            else True)

    return wait_for(f"the child at {addr}", ready)


def warm_problems():
    """Phase 24's config #11 solves on the host: one a signature."""
    return {p: testing.example_problem(OUTAGE.n_nodes, p, seed=24 + p,
                                       device="cpu") for p in WARM_PODS}


def remote_solve(addr, problem):
    """One solve through a fresh ``RemoteSolver``: ``(result, wall_s)``."""
    remote = RemoteSolver(addr, timeout=SOCKET_TIMEOUT_S)
    try:
        t0 = time.perf_counter()
        out = remote.solve_result(*problem, SolverConfig())
        return out, time.perf_counter() - t0
    finally:
        remote.close()


def same_answer(got, want, label) -> None:
    for f in ("assign", "commit", "waiting", "rejected"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu()), (
            f"{label}: {f} differs")
    assert torch.equal(got.node_state.used_req.cpu(),
                       want.node_state.used_req.cpu()), f"{label}: used_req"


def entry_paths(store, pods_of=WARM_PODS) -> dict:
    """The signature entries of ``store`` by pod count: what the children
    persisted (their manifest read by a pool over the store)."""
    pool = WarmPool().configure(store)
    out = {}
    for row in pool._read_manifest():
        sig = row["arrays"]
        n_pods = sig[1].req.shape[0]
        if n_pods in pods_of and sig[0].alloc.shape[0] == OUTAGE.n_nodes:
            key = warmpool._disk_key(row["program"], row["config"],
                                     warmpool._signature(sig))
            out[n_pods] = pool._cache._path(key)
    return out


def sabotage_entry(store, path, kind, seed) -> None:
    """``chaos.sabotage_store`` on the one entry ``path``: the store's other
    entries are set aside while it runs (it corrupts the newest in sorted
    order)."""
    others = [os.path.join(d, f) for d, _, files in os.walk(store)
              for f in files if f.endswith(".exec")
              and os.path.join(d, f) != path]
    for o in others:
        os.replace(o, o + ".hold")
    try:
        assert chaos.sabotage_store(store, kind, seed=seed) == path
    finally:
        for o in others:
            os.replace(o + ".hold", o)


def fault_children(store, work, sockets, log):
    """(b)'s stores: a copy of ``store`` per pair of WARM_FAULT_PAIRS, its
    two signatures' entries sabotaged one kind each; a child started on
    each. Returns ``[(kinds, store, addr, port, process)]``."""
    out = []
    for i, kinds in enumerate(WARM_FAULT_PAIRS):
        dst = os.path.join(work, f"fault{i}")
        shutil.copytree(store, dst)
        paths = entry_paths(dst)
        assert sorted(paths) == sorted(WARM_PODS), paths
        for (n_pods, path), kind in zip(sorted(paths.items()), kinds):
            sabotage_entry(dst, path, kind, seed=i)
        addr, port = sockets.path(f"fault{i}"), free_port()
        out.append((kinds, dst, addr, port,
                    warm_child(addr, port, dst, log)))
    return out


def fault_checks(children, problems, want, card) -> list:
    """(b): each child counted its two typed reasons and quarantined the
    two entries; its first solve at each signature ran cold on the kernel
    and equals the plain twin. Returns the children's lines."""
    lines = []
    for kinds, dst, addr, port, proc in children:
        st = warm_ready(addr, port, proc)
        reasons = {WARM_REASONS[k]: 1 for k in kinds}
        assert st["rejects"] == reasons, (kinds, st)
        assert st["quarantined"] == 2 and st["last_restore"]["failed"] == 2, st
        moved = sorted(f for _, _, fs in os.walk(dst) for f in fs
                       if f.endswith(".quarantined"))
        assert len(moved) == 2, moved
        served = st["served"]
        for n_pods, problem in problems.items():
            got, _ = remote_solve(addr, problem)
            same_answer(got, want[n_pods], f"{kinds}, {n_pods} pods")
        st = warm_status(port)
        assert st["served"] == served, ("a sabotaged signature served warm",
                                        st)
        lines.append(f"{' + '.join(kinds)} -> "
                     f"{' + '.join(sorted(reasons))}: quarantined 2, cold "
                     f"and equal")
    return lines


def fault_respawns(children, work, sockets, log) -> list:
    """(b)'s next respawn: each fault child killed and started again on its
    store, which no longer retries the quarantined entries."""
    again = []
    for i, (kinds, dst, addr, port, proc) in enumerate(children):
        proc.kill()
        proc.wait()
        addr2, port2 = sockets.path(f"again{i}"), free_port()
        again.append((kinds, dst, addr2, port2,
                      warm_child(addr2, port2, dst, log)))
    for kinds, dst, addr, port, proc in again:
        st = warm_ready(addr, port, proc)
        assert st["rejects"] == {} and st["quarantined"] == 0, (kinds, st)
        moved = [f for _, _, fs in os.walk(dst) for f in fs
                 if f.endswith(".quarantined")]
        assert len(moved) == 2, moved
    return again


def same_tree(a, b) -> bool:
    """Whether two solve-argument trees hold equal tensors (shape, dtype
    and values) and equal scalars."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.shape == b.shape
                and a.dtype == b.dtype and torch.equal(a, b))
    if isinstance(a, tuple):
        return (isinstance(b, tuple) and len(a) == len(b)
                and all(same_tree(x, y) for x, y in zip(a, b)))
    return a == b


def warm_main_route(card, main_args, work, main_twin) -> dict:
    """(c): the main path's solve (5,000 x 10,000, the cluster route)
    through a binding adopted into a pool, persisted, restored into a
    fresh pool as a CUDA graph and served twice with different pods:
    the second call leaves the first's result unchanged, both equal
    the ordinary solve and the plain twin on every pod. ``main_twin`` is
    phase 4's ``(kernel inputs, twin output)``: a call whose kernel
    inputs equal those reuses that twin, the other runs its own. Returns
    the ``binpack_warm_served`` entry."""
    args, kwargs = main_args
    state, pods, params, quota, gang, wsum = args
    # the observatory's warm manifest keeps the first 64 signatures it
    # sees, and phases 1-23 filled it: (c) records as a fresh process does
    DEVICE_OBS.reset()
    solve_args = (state, pods, params, quota, gang, kwargs.get("numa_aux"),
                  kwargs.get("resv"), kwargs.get("extras"),
                  kwargs.get("most_allocated", False), wsum)
    gen = torch.Generator().manual_seed(24)
    order = torch.randperm(pods.req.shape[0], generator=gen).to(
        pods.req.device)
    other = (solve_args[:1] + (map_args(pods, lambda t: t[order]),)
             + solve_args[2:])
    store = os.path.join(work, "main-store")
    seed = WarmPool().configure(store)
    ordinary = DEVICE_OBS.bind("warm_main_path", bk.solve_program)
    seed.adopt(ordinary, config_argpos=3)
    pool = WarmPool().configure(store)
    served = DEVICE_OBS.bind("warm_main_path", bk.solve_program)
    pool.adopt(served, config_argpos=3)
    try:
        want = [bk.run_solve(ordinary, *a) for a in (solve_args, other)]
        persisted = seed.persist()
        assert persisted["persisted"] == 1, persisted
        report = pool.restore()
        assert report["restored"] == 1 and report["failed"] == 0, (
            report, pool.status()["last_error"])
        (entry_,) = pool._execs.values()
        on_card = state.alloc.device.type == "cuda"
        assert entry_.graph is not None or not on_card, "no graph captured"
        assert entry_.kind == "cluster", entry_.config
        zero_launches()
        first = bk.run_solve(served, *solve_args)
        kept = map_args(first, torch.Tensor.clone)
        second = bk.run_solve(served, *other)
        if on_card:
            torch.cuda.synchronize()
        launches = dict(bk.LAUNCHES)
        st = pool.status()
        assert st["served"] == 2, st
        assert launches == {k: 2 * (k == "cluster") * on_card
                            for k in bk.LAUNCHES}, launches
        same_answer(first, kept, "the first served result after the second")
        assert torch.equal(first.node_state.est_extra,
                           kept.node_state.est_extra)
        same_answer(first, want[0], "served == ordinary")
        same_answer(second, want[1], "served == ordinary, other pods")
        inp = [bk.kernel_inputs(s_, p_, pr, bk.quota_inputs(q), wsum,
                                kwargs.get("numa_aux"), kwargs.get("resv"),
                                kwargs.get("most_allocated", False),
                                kwargs.get("extras"))
               for (s_, p_, pr, q) in (solve_args[:4], other[:4])]
        err, plain_s, reused = 0, [], []
        for call, (x, got) in enumerate(zip(inp, (first, second)), 1):
            if same_tree(x, main_twin[0]):
                twin_out = main_twin[1]
                reused.append(call)
            else:
                t0 = time.perf_counter()
                twin_out = twin(x, bk.route_of(x))
                if on_card:
                    torch.cuda.synchronize()
                plain_s.append(time.perf_counter() - t0)
            diff = got.raw_assign.long() - twin_out.assign.long()
            err = max(err, int(diff.abs().max()))
        assert err == 0, "a served solve != the plain twin"
        assert plain_s, "no twin was run on the served inputs"
        plain_ms = sum(plain_s) / len(plain_s) * 1e3
        route = bk.route_of(inp[0])
        if on_card:
            replay_ms = cuda_ms(entry_.graph.replay, 5)
            served_ms = cuda_ms(lambda: bk.run_solve(served, *solve_args), 5)
            launch_ms = cuda_ms(lambda: bk.binpack(inp[0]), 5)
            ordinary_ms = cuda_ms(lambda: bk.run_solve(ordinary,
                                                       *solve_args), 5)
        else:
            replay_ms = served_ms = launch_ms = ordinary_ms = float("nan")
        bound_ms, bound_by = bound(inp[0])
        p = inp[0].req.shape[0]
        print(f"warm pool (c) [{card}]: the main path's solve "
              f"({route_name(route)}, {inp[0].alloc.shape[0]} x {p}) "
              f"persisted (library "
              f"{persisted['library']}), restored into a fresh pool in "
              f"{report['wall_s']:.3f} s as a CUDA graph "
              f"({st['graphs']} captured), served twice with different "
              f"pods: the first result unchanged by the second, both == "
              f"the ordinary solve and the plain twin on all {p} pods "
              f"(max_abs_err {err}; phase 4's twin reused for call(s) "
              f"{reused}); replays {launches}; "
              f"graph replay {replay_ms:.3f} ms, a served call (signature, "
              f"copy-in, replay, copy-out) {served_ms:.3f} ms, the ordinary "
              f"launch {launch_ms:.3f} ms, the ordinary solve "
              f"{ordinary_ms:.3f} ms; the plain twin {plain_ms:.3f} ms "
              f"(mean of {len(plain_s)} run); bound {bound_ms:.5f} ms "
              f"({bound_by})", flush=True)
        return dict(name="binpack_warm_served", replaces=f"{REPLACES}:317",
                    source=CLUSTER_SOURCE, launches=launches["cluster"],
                    max_abs_err=err, ms=replay_ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by)
    finally:
        pool.reset()
        seed.reset()


def warm_respawn(card, main_args, main_twin) -> list:
    """Phase 24 (a)-(c) (``main_twin``: see :func:`warm_main_route`).
    Returns the ``binpack_warm_served`` entry."""
    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="koord-phase24-")
    store = os.path.join(work, "store")
    log = os.path.join(work, "children.log")
    sockets = Sockets()
    extra, sup = [], None
    try:
        problems = warm_problems()
        want = {n: bk.kernel_solve_batch(*pr) for n, pr in problems.items()}
        # (a) a cold child (no pool) and the first supervised child (an
        # empty store), started together
        cold_addr, cold_port = sockets.path("cold"), free_port()
        extra.append(warm_child(cold_addr, cold_port, "", log,
                                "--no-warm-pool"))
        addr, port = sockets.path("warm"), free_port()

        def probe():
            # ready once it accepts solves AND the supervisor has its
            # restore outcome from the mux
            return (sup.status()["respawn_warm"] is not None
                    and connection_probe(addr))

        sup = SolverSupervisor(
            addr, spawn_fn=lambda: warm_child(addr, port, store, log),
            probe_fn=probe, warm_outcome_fn=debug_port_warm_outcome(port),
            warm_ready_timeout_s=WARM_GRACE_S, ready_timeout_s=300.0,
            probe_interval_s=0.05, backoff_base_s=0.0, backoff_cap_s=0.0)
        t0 = time.perf_counter()
        sup.start(wait_ready=True, monitor=False)
        boot_s = time.perf_counter() - t0
        st = sup.status()
        assert st["respawn_warm"] is False, st   # an empty store: cold
        for n, problem in problems.items():
            got, _ = remote_solve(addr, problem)
            same_answer(got, want[n], f"the first child, {n} pods")
        on_card = CHILD_DEVICE == "cuda"
        persisted = wait_for("the first child's persist", lambda: (
            lambda s: s if len(entry_paths(store)) == len(WARM_PODS)
            and (s["library_stored"] or not on_card) else None)(
                warm_status(port)))
        warm_ready(cold_addr, None, extra[0])
        cold, cold_s = remote_solve(cold_addr, problems[WARM_PODS[0]])
        same_answer(cold, want[WARM_PODS[0]], "the cold child")
        # kill the first child; (b)'s stores are copied from its store
        # and their children start beside the respawn
        pid = sup.status()["child_pid"]
        os.kill(pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        faults = fault_children(store, work, sockets, log)
        extra += [f[-1] for f in faults]
        wait_for("the restart", lambda: sup.check_once() == "restarted")
        main_entry = warm_main_route(card, main_args, work, main_twin)
        wait_for("the respawn", lambda: sup.check_once() == "running")
        respawn_s = time.perf_counter() - t_kill
        st = sup.status()
        assert st["respawn_warm"] is True and \
            st["respawns_warm_total"] == 1, st
        assert st["ready_grace_s"] == WARM_GRACE_S, st
        ws = warm_status(port)
        report = ws["last_restore"]
        assert report["failed"] == 0 and report["restored"] >= len(WARM_PODS)
        assert not on_card or ws["graphs"] >= len(WARM_PODS), ws
        served = ws["served"]
        warm, warm_s = remote_solve(addr, problems[WARM_PODS[0]])
        ws = warm_status(port)
        assert ws["served"] == served + 1, ("the first solve was not served "
                                            "from a replayed graph", ws)
        same_answer(warm, want[WARM_PODS[0]], "the warm child != the twin")
        same_answer(warm, cold, "the warm child != the cold child")
        print(f"warm pool (a) [{card}]: config #11 ({OUTAGE.n_nodes} nodes, "
              f"{' and '.join(map(str, WARM_PODS))} pods) on a supervised "
              f"cmd.solver child over a store: the first child (cold, an "
              f"empty store; boot {boot_s:.3f} s) solved both signatures "
              f"and persisted {persisted['manifest_rows']} rows (its "
              f"boot warm-up's included; library stored "
              f"{persisted['library_stored']}); "
              f"SIGKILLed, the supervisor respawned it in {respawn_s:.3f} s "
              f"(warm outcome True, respawns_warm_total "
              f"{st['respawns_warm_total']}, ready grace "
              f"{st['ready_grace_s']:.1f} s, not "
              f"{sup.ready_timeout_s:.1f}); its restore before the bind: "
              f"restored {report['restored']}, failed {report['failed']}, "
              f"rows {report['rows']}, compiled {report['compiled']}, "
              f"library {report['library']}, {report['wall_s']:.3f} s, "
              f"{ws['graphs']} graphs; its first remote solve served from a "
              f"replayed graph (served {served} -> {ws['served']}) == the "
              f"plain twin == a cold child's; the first solve's wall in a "
              f"fresh process: cold {cold_s * 1e3:.3f} ms, warm "
              f"{warm_s * 1e3:.3f} ms", flush=True)
        lines = fault_checks(faults, problems, want, card)
        extra += [f[-1] for f in fault_respawns(faults, work, sockets, log)]
        print(f"warm pool (b) [{card}]: the six store faults, two to a "
              f"store on the two signatures' entries, each in a fresh "
              f"child: {'; '.join(lines)}; the next respawn of each "
              f"retried no quarantined entry (rejects {{}})", flush=True)
    except BaseException:
        if os.path.exists(log):
            with open(log, "rb") as f:
                sys.stderr.write(f.read()[-4000:].decode(errors="replace"))
        raise
    finally:
        if sup is not None:
            sup.stop()
        for proc in extra:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        sockets.close()
        shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    print(f"warm pool (a)-(c) wall {wall:.2f} s", flush=True)
    return [main_entry], wall


def cri_proxy(bus, agents, bound, responses) -> dict:
    """Phase 24 (d) on phase 23's world after its wave: a kubelet stand-in
    sends RunPodSandbox, CreateContainer, StartContainer and StopContainer
    for PROXY_PODS of the wave's bound pods through a
    ``RuntimeManagerCriServer`` a node (the agent's hook server, a
    recording runtime, hook errors failing the call): every
    CreateContainer the runtime sees carries the cpuset and the GPU env
    the hooks gave that container (``responses``, and the cpuset in its
    file); a restarted proxy's ``fail_over`` rebuilds its store from the
    runtime's pods. Returns the runtime's requests and the stores."""

    class Runtime:
        def __init__(self):
            self.requests, self.pods = [], {}

        def handle(self, request):
            self.requests.append(request)
            if request.method == "RunPodSandbox":
                self.pods[request.pod.uid] = request.pod
            return {"ok": True, "method": request.method}

        def list_pods(self):
            return list(self.pods.values())

    rng = np.random.default_rng(HOOKS_SEED + 3)
    picks = sorted(rng.choice(sorted(p.uid for p in bound), PROXY_PODS,
                              replace=False).tolist())
    metas = {m.uid: (name, m) for name, d in agents.items()
             for m in d.states_informer.running_pods()}
    proxies = {}
    for uid in picks:
        name, meta = metas[uid]
        if name not in proxies:
            runtime = Runtime()
            proxies[name] = (RuntimeManagerCriServer(
                agents[name].runtime_hooks.server, runtime,
                failure_policy=FailurePolicy.FAIL), runtime)
        proxy = proxies[name][0]
        proxy.intercept(CRIRequest(method="RunPodSandbox", pod=meta))
        for c in meta.containers:
            for method in ("CreateContainer", "StartContainer",
                           "StopContainer"):
                proxy.intercept(CRIRequest(method=method, pod=meta,
                                           container=c))
    created = pinned = gpus = 0
    for name, (proxy, runtime) in proxies.items():
        cfg = agents[name].executor.config
        for req in runtime.requests:
            if req.method != "CreateContainer":
                continue
            created += 1
            got = dataclasses.asdict(req.resources)
            assert got == responses[f"{req.pod.uid}/{req.container}"], (
                req.pod.uid, got)
            spec = bus.get(Kind.POD, req.pod.uid)
            cpuset = cpuset_from_annotation(spec.annotations)
            if cpuset is not None:
                pinned += 1
                assert got["cpuset"] == cpuset == hooks_read(
                    CPU_SET, req.pod.containers[req.container], cfg)
            raw = spec.annotations.get(ANNOTATION_DEVICE_ALLOCATED)
            if raw:
                gpus += 1
                minors = ",".join(str(d["minor"])
                                  for d in json.loads(raw)["gpu"])
                assert got["add_envs"]["NVIDIA_VISIBLE_DEVICES"] == minors
        again = RuntimeManagerCriServer(agents[name].runtime_hooks.server,
                                        runtime)
        assert again.fail_over() == len(runtime.pods) > 0
        assert sorted(again.store.pods) == sorted(runtime.pods) == sorted(
            proxy.store.pods)
    assert created >= PROXY_PODS and pinned > 0 and gpus > 0, (
        created, pinned, gpus)

    def plain(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return {f.name: plain(getattr(x, f.name))
                    for f in dataclasses.fields(x)}
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        return x.name if isinstance(x, enum.Enum) else x

    return dict(requests={n: plain(r.requests)
                          for n, (_, r) in sorted(proxies.items())},
                stores={n: sorted(p.store.pods)
                        for n, (p, _) in sorted(proxies.items())},
                created=created, pinned=pinned, gpus=gpus,
                frames=proxy_frames(picks, metas))


def proxy_frames(picks, metas) -> list:
    """(d)'s frames for the binary: the four calls of each picked pod in
    the documented framing, then a malformed line."""
    frames = []
    for uid in picks:
        meta = metas[uid][1]
        frames.append({"method": "RunPodSandbox", "pod_uid": uid})
        for c in meta.containers:
            for method in ("CreateContainer", "StartContainer",
                           "StopContainer"):
                frames.append({"method": method, "pod_uid": uid,
                               "container": c})
    return [json.dumps(f).encode() + b"\n" for f in frames] + [b"not json\n"]


def proxy_exchange(path, frames, deadline_s=SOCKET_TIMEOUT_S) -> list:
    """One kubelet stand-in on ``path``: each frame, its reply line."""
    t0 = time.perf_counter()
    while True:
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            conn.connect(path)
            break
        except OSError:
            conn.close()
            if time.perf_counter() - t0 > deadline_s:
                raise
            time.sleep(0.01)
    replies = []
    with conn, conn.makefile("rb") as rf:
        for frame in frames:
            conn.sendall(frame)
            replies.append(rf.readline())
    return replies


def proxy_in_process(frames) -> list:
    """(d)'s frames through this process's ``cmd.runtimeproxy`` proxy
    (``build_proxy`` of the default config, ``serve(once=True)``)."""
    sockets = Sockets()
    path = sockets.path("p")
    server = threading.Thread(target=proxy_cmd.serve, args=(
        proxy_cmd.build_proxy(proxy_cmd.RuntimeProxyConfig()), path),
        kwargs={"once": True, "log": lambda *_a: None})
    server.start()
    try:
        return proxy_exchange(path, frames)
    finally:
        server.join(timeout=60)
        sockets.close()


def proxy_binary_start() -> dict:
    """(d): ``python -m koordinator_tpu_torch.cmd.runtimeproxy --once`` on
    a short UDS path, started (beside phase 23's run, which makes its
    frames); each output line stamped as it arrives."""
    sockets = Sockets()
    path = sockets.path("p")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "koordinator_tpu_torch.cmd.runtimeproxy",
         "--once", "--listen", path],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    child = dict(proc=proc, sockets=sockets, path=path, t0=t0, stamped=[])

    def read():
        for line in proc.stdout:
            child["stamped"].append((time.perf_counter(), line.rstrip("\n")))

    child["reader"] = threading.Thread(target=read)
    child["reader"].start()
    return child


def proxy_binary_finish(child, frames, want) -> dict:
    """(d)'s binary answers ``frames`` on its socket: its reply frames ==
    ``want`` (this process's proxy's), exit 0. Returns its start-up (to
    its "listening" line), the exchange and exit after the frames were
    ready, and its whole wall."""
    proc = child["proc"]
    try:
        t_ready = time.perf_counter()
        got = proxy_exchange(child["path"], frames)
        rc = proc.wait(timeout=BINARY_TIMEOUT_S)
        child["reader"].join()
        t_end = time.perf_counter()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        child["sockets"].close()
    lines = [line for _, line in child["stamped"]]
    assert rc == 0, lines[-20:]
    listening = [t for t, line in child["stamped"] if "listening on" in line]
    assert listening, lines
    assert got == want, "the binary's reply frames != the in-process proxy's"
    return dict(start=listening[0] - child["t0"], tail=t_end - t_ready,
                wall=t_end - child["t0"])


def cpu_twin_cut(inp, route, label, card, pods=TWIN_CUT_PODS) -> dict:
    """The kernel held against its plain twin on the CPU (CPU_ROUND_THREADS
    torch threads) on the solve's first ``pods`` pods, every output; the
    full solve's first assignments equal to that cut's; the kernel timed
    at full size."""
    cut = first_pods(inp, pods)
    cut_route = bk.route_of(cut)
    got = bk.binpack(cut)
    assert torch.equal(bk.binpack(inp).assign[:pods], got.assign), (
        f"{label}: the full solve's first {pods} assignments != the cut's")
    cpu_cut = map_args(cut, torch.Tensor.cpu)
    threads = torch.get_num_threads()
    torch.set_num_threads(CPU_ROUND_THREADS)
    try:
        t0 = time.perf_counter()
        want = twin(cpu_cut, cut_route)
        plain_s = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    err = max_abs_err(map_args(got, torch.Tensor.cpu), want)
    ms = cuda_ms(lambda: bk.binpack(inp), 3)
    bound_ms, bound_by = bound(inp)
    p = inp.req.shape[0]
    print(f"{label}: {route_name(route)} kernel == the CPU's plain twin "
          f"({CPU_ROUND_THREADS} torch thread) on its first {pods} pods "
          f"(the CPU round on those pods; max_abs_err {err}), the full "
          f"solve's first {pods} assignments == the cut's [{card}]: kernel "
          f"{ms:.3f} ms ({ms / p * 1e3:.3f} us/pod), plain twin on the cut "
          f"{plain_s * 1e3:.3f} ms, bound {bound_ms:.5f} ms ({bound_by})",
          flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_s * 1e3,
                bound_ms=bound_ms, bound_by=bound_by, route=route,
                variant=variant(inp))

def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    lib = bk.build_library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in bk.build_log().splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or "smem" in line):
            print(f"ptxas: {line.strip()}", flush=True)
    print(f"rebalance_scan_kernel: {bk._library().rebalance_scan_shared_bytes()}"
          " B of dynamic shared memory per CTA", flush=True)

    # -- 2. the routed kernel vs its plain twin on the card -------------------
    state, pods, params = testing.example_problem(NODES, PENDING, seed=1)
    plain = compare(bk.kernel_inputs(state, pods, params),
                    f"plain {NODES} nodes x {PENDING} pods", card)
    state, pods, params, quota, gang = testing.quota_gang_problem(
        QUOTA_NODES, QUOTA_PODS, QUOTAS, GANGS, GANG_SIZE, seed=1)
    kernels = [solve_entry(
        f"quota+gang {QUOTA_NODES} nodes x {pods.req.shape[0]} pods "
        f"({QUOTAS} quotas, {GANGS} gangs x {GANG_SIZE})",
        lambda: bk.kernel_solve_batch(state, pods, params, quota, gang),
        card, "block", 93)]
    state, pods, params, quota, gang = testing.quota_gang_problem(
        WIDE_NODES, WIDE_PODS, WIDE_QUOTAS, 20, 8, seed=2)
    kernels.append(solve_entry(
        f"quota+gang {WIDE_NODES} nodes x {pods.req.shape[0]} pods "
        f"({WIDE_QUOTAS} quotas: tables in device memory)",
        lambda: bk.kernel_solve_batch(state, pods, params, quota, gang),
        card, "block", 282, name="binpack_quota_in_device_memory",
        quota_shared=False))

    # -- 3. the main path ------------------------------------------------------
    def snapshot():
        snap, _ = testing.churn_world(
            NODES, assigned_per_node=ASSIGNED_PER_NODE, seed=42)
        return testing.add_pending_wave(snap, PENDING, n_quota=QUOTAS,
                                        n_gangs=GANGS, gang_size=GANG_SIZE,
                                        seed=7)

    _, launches, captured = schedule_path(snapshot, "main path", card,
                                          "cluster")

    # -- 4. the kernel at the main path's inputs --------------------------------
    main = compare(captured[0][0], "the main path's inputs", card, reps=5)
    # phase 24 (c) serves this solve warm and holds it against this twin
    main_twin = (map_args(captured[0][0], torch.Tensor.clone),
                 main["twin_out"])
    main["max_abs_err"] = max(main["max_abs_err"], plain["max_abs_err"])
    kernels.append(entry("binpack", launches, main, 317))

    # -- 5. the reservation main path --------------------------------------------
    def resv_snapshot():
        return testing.add_reservations(snapshot(), LABEL_RESV,
                                        MIGRATION_RESV, seed=11)

    result, launches, captured = schedule_path(
        resv_snapshot, "reservation main path", card, "cluster")
    n_resv = captured[0][0].resv[0].shape[0]
    assert n_resv == LABEL_RESV + MIGRATION_RESV, n_resv
    consumed = len(result.resv_committed) + len(result.resv_allocs)
    assert consumed > 0, "no pod consumed a reservation"
    print(f"reservation main path: {n_resv} reservations, {consumed} pods "
          f"consumed one ({len(result.resv_committed)} committed, "
          f"{len(result.resv_allocs)} waiting)", flush=True)
    resv = compare(captured[0][0], "the reservation main path's inputs", card,
                   reps=5)
    kernels.append(entry("binpack", launches, resv, 205))

    # -- 6. the fused solve, bench config #8 -------------------------------------
    for most in (False, True):
        scorer = "most" if most else "least"
        s_, p_, pr, q, g, rv, aux = testing.full_features_problem(
            FUSED_NODES, FUSED_PODS, seed=8)
        safe = bk.kernel_resv_score_safe(rv.node, rv.free, s_.alloc)
        assert bk.kernel_routing_ok(s_, p_, None, rv, safe, aux)
        solved, launches, wall, captured = drive(
            lambda: bk.kernel_solve_batch(
                s_, p_, pr, q, g, numa_aux=aux, resv=rv, most_allocated=most,
                resv_score_checked=True))
        inp, route = routed(f"fused solve, NUMA {scorer}", launches,
                            captured, "cluster")
        placed = int(solved.commit.sum())
        took_numa = int(solved.numa_consumed.sum())
        took_resv = int((solved.resv_vstar >= 0).sum())
        assert placed > 0 and took_numa > 0 and took_resv > 0
        print(f"fused solve, NUMA {scorer} [{card}]: {FUSED_NODES} nodes x "
              f"{FUSED_PODS} pods, quota+gang+numa+resv: {placed} committed, "
              f"{took_numa} took NUMA, {took_resv} consumed a reservation; "
              f"wall {wall:.4f} s; route {route_name(route)}; launches "
              f"{launches[route.kind]}", flush=True)
        fused = compare_cut(inp, f"config #8, NUMA {scorer}", card, reps=3)
        loop_check(most, card)
        kernels.append(entry("binpack", launches[route.kind], fused, 259))
    kernels.append(extras_loop_check(card))
    s_, p_, pr, q, g, rv, aux = testing.full_features_problem(
        BLOCK_NODES, BLOCK_PODS, seed=8)
    for most in (False, True):
        kernels.append(solve_entry(
            f"config #8 cut to {BLOCK_NODES} x {BLOCK_PODS}, NUMA "
            f"{'most' if most else 'least'}",
            lambda: bk.kernel_solve_batch(s_, p_, pr, q, g, numa_aux=aux,
                                          resv=rv, most_allocated=most),
            card, "block", 259))
    kernels.append(solve_entry(
        f"config #8 cut to {BLOCK_NODES} x {BLOCK_PODS}, no NUMA",
        lambda: bk.kernel_solve_batch(s_, p_, pr, q, g, resv=rv),
        card, "block", 205))

    # -- 7. the cluster kernel at every CTA count ---------------------------------
    args, kwargs = main_path_solve_args(snapshot)
    main_args = (args, kwargs)  # phase 24 (c) serves this solve warm
    main_sharded = cluster_path(
        "main path's solve", "binpack_sharded",
        lambda: bk.kernel_solve_batch(*args, **kwargs),
        lambda k: shard_kernel_solver(k)(*args[:5]), card)
    s_, p_, pr, q, g, rv, aux = testing.full_features_problem(
        FUSED_NODES, FUSED_PODS, seed=8)
    fused_sharded = cluster_path(
        "config #8, NUMA least + reservations", "binpack_sharded_numa_resv",
        lambda: bk.kernel_solve_batch(s_, p_, pr, q, g, numa_aux=aux,
                                      resv=rv),
        lambda k: shard_kernel_solver(k)(s_, p_, pr, q, g, aux, rv), card)
    state, pods, params, quota, _ = testing.quota_gang_problem(
        QUOTA_NODES, QUOTA_PODS, QUOTAS, GANGS, GANG_SIZE, seed=1)
    reduced = compare(
        bk.kernel_inputs(state, pods, params, bk.quota_inputs(quota)),
        f"quota+gang {QUOTA_NODES} nodes x {pods.req.shape[0]} pods", card,
        shards=QUOTA_SHARDS)
    s_, p_, pr, q, g, rv, aux = testing.full_features_problem(
        LOOP_NODES, LOOP_PODS, seed=8)
    reduced_fused = compare(
        bk.kernel_inputs(s_, p_, pr, bk.quota_inputs(q), numa_aux=aux,
                         resv=rv, most_allocated=True),
        f"config #8 cut to {LOOP_NODES} nodes x {LOOP_PODS} pods, NUMA most "
        "+ reservations", card, shards=LOOP_SHARDS)
    main_sharded["max_abs_err"] = max(main_sharded["max_abs_err"],
                                      reduced["max_abs_err"])
    fused_sharded["max_abs_err"] = max(fused_sharded["max_abs_err"],
                                       reduced_fused["max_abs_err"])
    kernels += [main_sharded, fused_sharded]

    # -- 8. past 16 CTAs' shared memory: the L2 form --------------------------
    state, pods, params, quota, gang = testing.quota_gang_problem(
        L2_NODES, L2_QUOTA_PODS, QUOTAS, L2_GANGS, L2_GANG_SIZE, seed=3)
    kernels.append(solve_entry(
        f"quota+gang {L2_NODES} nodes x {pods.req.shape[0]} pods",
        lambda: bk.kernel_solve_batch(state, pods, params, quota, gang),
        card, "l2", 317))

    # -- 9. the scheduling round on the card -----------------------------------
    scheduler_burst(snapshot, card)
    launches, inp = churn_ticks(card)
    churn = compare(inp, f"churn tick, {CHURN_NODES} x {CHURN_PENDING}", card,
                    reps=5)
    kernels.append(entry("binpack_churn_tick", launches, churn, 317))

    # -- 10. the fine-grained burst through the Scheduler ----------------------
    kernels += fine_grained_burst(card)

    # -- 11. preemption on the card ----------------------------------------------
    kernels.extend(storm_rounds(card))
    for n_nodes in (STORM_NODES, SWEEP_WIDE_NODES):
        victim_sweep(n_nodes, card)
    scan_wave(card)
    defrag_check(card)

    # -- 12. descheduling on the card ------------------------------------------
    kernels.append(rebalance_config5(card))
    kernels.append(rebalance_storm(card))
    kernels.append(rebalance_wide(card))
    kernels.append(rebalance_serial(card))

    # -- 13. serving: the solver sidecar on the card -----------------------------
    kernels += serving(card)

    # -- 14. the colocation loop -------------------------------------------------
    kernels.append(colocation(card))

    # -- 15. the pipelined and streaming loops ---------------------------------
    kernels += loops(card)

    # -- 16. the serving failure domain ------------------------------------------
    kernels += failure_domain(card)

    # -- 17. the plugin chain, the aggregated mode and the explainer -----------
    kernels += plugin_chain_phase(card)

    # -- 18. the binaries: scheduler main(), the auditor, the descheduler ----
    kernels += binaries(card)

    # -- 19. the host route for tiny solves --------------------------------------
    kernels += host_route(card)

    # -- 20. the wire under faults, the eviction storm, the manager binary ---
    kernels += faults_and_manager(card)

    # -- 21. the node agents feed the colocation loop ----------------------------
    # -- 22. the agents act on pressure, the card re-places the victims -------
    # -- 23. the koordlet binary acts on the card's placements -----------------
    kernels += node_agents(card)

    # -- 24. the warm pool on the card, the CRI proxy ----------------------------
    warm_entries, warm_wall = warm_respawn(card, main_args, main_twin)
    kernels += warm_entries
    print(f"phase 24 wall {warm_wall + sum(PHASE24_TIMES.values()):.2f} s: "
          f"(a)-(c) {warm_wall:.2f} s, (d) the proxies "
          f"{PHASE24_TIMES['proxy']:.2f} s and the binary's exchange and "
          f"exit {PHASE24_TIMES['binary']:.2f} s (in phase 23's run; the "
          f"binary started beside it)", flush=True)

    print(f"chip_smoke wall {time.perf_counter() - t_start:.2f} s (the "
          "kernel library's build included)", flush=True)

    print(json.dumps({"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": k["launches"],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": None}
        for k in kernels]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
