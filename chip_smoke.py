#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ceph_tpu_torch``) once on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and exits non-zero):

1. Build the CUDA kernels from ``ceph_tpu_torch/csrc`` and print the card's
   name and power limit (``nvidia-smi``).
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it, from seeded random bytes (half of them >= 0x80):
   bit-exact, with kernel and plain times (beside the times of the codec
   kernels' first, mask-table designs) and the least time the card could
   take for the same work.  Then the three codec kernels at edge shapes,
   each bit-exact against its plain version: lanes n4 = 1 and 1003, the
   main path's width (2097152 at w=8, 131072 at w=16 and for the packet
   code), a pointer off the 16-byte grid, odd r and m, k = 1, all-zero
   bit-rows, the wide packet codes (cauchy_good k=32 m=8, liberation k=17
   w=31, a 1800-row table), tables staged in slices (w=8 k = 400; w=16 k =
   100, k = 50 at m = 8) and in passes (m = 12), and decode matrices
   (reed_sol_van w=8 and w=16 with chunks 1 and 6 erased, cauchy_good's
   decoding bitmatrix); ``sweep_pipelined_w8`` over the same w=8 cases.
3. The main path through the port's registry: ``factory("cuda",
   reed_sol_van k=8 m=4)`` encodes 8 distinct random 8 MiB stripes with
   ``encode_batch``, decodes them with chunks 1 and 6 erased with
   ``decode_batch``, then runs the sync ``encode``/``decode`` of one stripe.
   Every chunk is compared bit-exactly with the port's numpy ``jerasure``
   plugin.  The same runs at 1 MiB chunks and a batch of 4 for reed_sol_van
   w=16 and cauchy_good packetsize=2048.  Each kernel's launch count must
   rise during its profile.
3b. The storage path (``osd/storage_bench.py``, the OSD write and degraded
   read cycles over ``ecutil``, the batch coalescer and crc32c) on the
   card: reed_sol_van k=8 m=4 w=8 with 32 objects of 4 MiB (RBD's default
   object size, RGW's stripe), 8 writers, 2 erasures, best of 2 timed
   cycles; w=16 and cauchy_good packetsize=2048 with 16 objects each.
   The harness gates bit-exactness (per-op against coalesced, and the
   degraded read) and steady-state library builds; beside it, every
   object's stored shards are compared with the port's numpy
   ``jerasure`` plugin's encode of the same payload, the degraded read
   with the payload, and the C crc32c with its plain version over 64 KiB
   of a shard.  It prints write and read GiB/s per mode, the stage times,
   ``h2d_per_granule`` and ``steady_library_builds``; each configuration's
   codec kernel must be launched during it (counts zeroed at the start).
3c. The cluster path (``osd/cluster.py`` with the ``cuda`` plugin: objecter,
   primary OSD, ``ECBackend`` and its coalescers, shard op queues and QoS,
   the messenger, MemStore and recovery) on the card: ``ECCluster`` with 16
   OSDs over a flat CRUSH map runs the storage cycle of
   ``osd/cluster_bench.py`` -- write with 8 client tasks, kill the first OSD
   of obj0's acting set, overwrite a quarter of the objects while
   degraded, read everything (reads that lost a data shard decode),
   revive, auto-recover until ``degraded_report()`` is empty (120 s
   deadline), read everything again -- for reed_sol_van k=8 m=4 w=8 with
   32 objects of 4 MiB, and w=16 and cauchy_good packetsize=2048 with 16
   each.  Every read is checked against its payload; after recovery every
   stored shard in every OSD's store is compared with the port's numpy
   ``jerasure`` encode of the object's final payload and every shard's
   ``HashInfo`` crc with the plain (byte-table) crc32c of its bytes.  The
   codec kernel's launches are zeroed before and read after each of the
   write, degraded-read and recovery steps and must rise in each.  It
   prints the write and degraded-read GiB/s, time to clean and rebuilt
   MiB/s, client op p50/p99 and the coalescers' encode and decode
   dispatches and granules per step.
3d. The device cache tier on the card, at the JAX package's tier defaults
   (``osd_tier_hbm_bytes`` 256 MiB, ``osd_tier_h2d_cache_bytes`` 64 MiB)
   and reed_sol_van k=8 m=4 w=8, where a 4 MiB object's resident block is
   12 x 512 KiB = 6 MiB.  First the H2D upload cache: the same 8 x 8 MiB
   batch through the one-shot ``encode`` twice, the second pass issuing
   no H2D (the residency ledger's h2d ops rise 0, the stream's cache hits
   rise), a third with ``CEPH_TPU_TORCH_NO_H2D_CACHE=1``, which uploads
   again, and two through ``encode_batch``, whose persistent write lane
   uploads its fresh granules every time and caches none; then the cost
   of the cache's blake2b: phase 3b's write pass of 32 objects, per-op
   and coalesced, with the cache on and off in turns.
   Then ``cluster_bench.run_tier_cycle`` on ``ECCluster(16, ...,
   plugin="cuda")`` with 8 client tasks: in writeback mode with 64 objects
   of 4 MiB (384 MiB of blocks over the 256 MiB budget, so eviction runs;
   the rewrite of every object is promote-from-encode) and in readproxy
   mode with 16 (the rewrite invalidates every resident copy).  In both
   the agent's tick must promote and never fail.  Every
   read is checked against its payload, and after each cycle every stored
   shard against the numpy ``jerasure`` plugin and every ``HashInfo`` crc
   against the plain crc32c; the tier's resident bytes stay within
   ``osd_tier_hbm_bytes`` at the end of every step, and the ledger's
   ``tier`` + ``h2d`` bytes equal the change of the caching allocator's
   requested bytes (``memory_stats``) over the cycle, up to the small
   device tables the codec makes (``memory_allocated`` is printed beside,
   with the allocator's rounding).  Last, ``run_tier_path_bench`` at 32 x
   4 MiB with 2 erasures on a private ledger (192 MiB resident): hot and
   cold read GiB/s.  The codec kernels' launches on the tier path are
   zeroed just before each cycle and read just after it (per step too);
   ``tier_bench``'s are counted apart.
3e. The rest of the plugin layer on the card, each plugin against the
   same plugin on the CPU in the port (``backend=cpu``, the host engine;
   ``device=cpu`` for regen; lrc's layers on ``jerasure``): isa
   reed_sol_van and cauchy at k=7 m=3 (``backend=cuda``), shec k=4 m=3
   c=2 at w=8 and w=16 (``backend=cuda``), lrc k=4 m=2 l=3 with its
   generated layers on the ``cuda`` plugin, and regen k=4 m=3 (d=6).
   Each encodes 8 seeded 4 MiB stripes (half the bytes >= 0x80; every
   chunk size a whole number of 4-byte lanes, so the products take the
   kernel) and decodes them with two chunks erased (one, in a local
   group, for lrc), through the sync ``encode``/``decode`` (regen through
   ``encode_batch``/``decode_batch``, its device lanes); every chunk is
   compared bit for bit, and
   ``gf2_matrix_w8``'s launches (``gf2_matrix_w16``'s for shec w=16)
   must rise during the plugin's step.  For regen also, for every single
   lost node, the d survivors' helper symbols (``compute_helpers`` on
   the card) and ``regenerate_batch`` against the host LUT engine and
   the lost chunk, with the kernel's launches rising; and helpers of a
   width off the 4-byte lane grid (beta = 4099), which take the host
   path on the card (no launch) and give the same bytes.
3f. The native layer and the EC tools (``native/``, ``ops/native_engine.py``
   and ``tools/{ec_non_regression,ec_bench_sweep,ec_info,crushtool}.py``).
   (a) On the card machine's host: the native libraries build there
   (``native/build.py``, host ``g++ -march=native``); the dlopen registry's
   handshake -- ``xor_native`` loads and its codec encodes and decodes,
   ``regen_native`` loads, the five broken fixtures and a missing file
   return the reference's codes (-EXDEV twice, -ENOENT, -3, -EBADF,
   -ENOENT) and ``hangs_native`` gives up at its 300 ms watchdog; then
   jerasure reed_sol_van and cauchy_good packetsize=2048 at k=8 m=4, isa
   reed_sol_van k=8 m=4 and shec k=4 m=3 c=2 at ``backend=native`` encode
   8 seeded 4 MiB stripes and decode them with two chunks erased, every
   chunk equal to ``backend=cpu``'s; it prints the host GiB/s of both
   engines with the host CPU's model (``/proc/cpuinfo``).  (b) The port's
   ``ec_non_regression --check`` over every directory of the committed
   corpus (``tests/data/ec_corpus``, made by the JAX package's tool): each
   exits 0, and each card profile (``backend=cuda``, ``plugin=cuda``,
   ``regen``) launches ``gf2_matrix_w8``, ``gf2_matrix_w16`` or
   ``gf2_packet`` (counts printed before and after).  (c) ``ec_bench_sweep
   --plugins cuda,jerasure,isa --backend cuda`` at its defaults (1 MiB,
   16 MiB total): one JSON line per cell with no ``error`` line (the
   reference's sweep prints none at these sizes), each ``cuda`` row's
   ``h2d_ops``, and the codec kernels' launches over the sweep.  (d)
   ``ec_info --plugin_exists`` for every built-in plugin, and ``crushtool
   --build 16 --rule erasure --num-rep 12 --show-utilization`` (run in a
   child process beside (a) to (c); bad mappings 0).
3g. The durable cluster: the OSDs keep their shards in the port's
   persistent object stores, under a fresh directory of the checkout's
   ``ceph_tpu_torch/build/`` on the machine's local disk (its filesystem
   from ``df -T`` is printed), removed at the end.  (a)
   ``ECCluster.create_with_mons`` with 16 OSDs and 3 mons, reed_sol_van
   k=8 m=4 w=8 on the ``cuda`` plugin, ``objectstore="blockstore"``: the
   pool and its profile are paxos-committed, then ``osd/durable_bench.py``'s
   cycle -- 8 client tasks write 32 objects of 4 MiB (RBD's object size;
   192 MiB stored over 16 block files), one OSD is killed and every object
   read degraded, the mon leader is killed and, once the lease has failed
   over (a new leader answers ``status``), 8 more objects are written; then
   the cluster is abandoned without unmounting its stores (a crash), a new
   mon-backed cluster mounts the same data path and reads every object
   back with the same OSD down, revives it and recovers until clean; the
   recovery's tick loops stop and everything is read again.  After it
   every stored shard is compared with the port's numpy ``jerasure``
   encode of its object (the shards' crcs are phase 3c's check).  (b) The same cycle without mons at 16 x 4
   MiB (4 more written degraded): reed_sol_van w=16 on ``filestore`` and
   cauchy_good packetsize=2048 on ``kstore``.  (c) On (a)'s OSDs,
   ``add_pool("meta", pool_type="replicated", size=3)``: 256 small objects
   each with 16 omap keys (an RGW bucket index's shape), every object and
   omap read back with one OSD down, and every replica's data and omap
   copy compared.  The codec kernel's launches are zeroed before and read
   after each step, and must rise in every step that encodes or decodes.
   It prints each step's seconds, write and read GiB/s, time to clean, the
   mon failover's seconds, the bytes on disk, and the card's name and
   power limit.
3h. The mesh data plane (``parallel/``) over 4 slots: every card the
   process sees when it sees 4 or more, else ``cuda:0`` four times (one
   stream a slot; ``parallel.configure_devices``).  (a) ``ECCluster(16,
   reed_sol_van k=8 m=4 w=8, plugin="cuda")`` runs phase 3c's cycle at 32
   x 4 MiB with ``osd_mesh_data_plane`` on (osd.0-3 bound to the slots;
   ``osd_mesh_scatter`` auto, on for CUDA: encodes reduce-scattered over
   the slots, decodes on the primary's slot, chunks to bound OSDs through
   the delivery board), the killed OSD one the plane binds, then the same
   cycle with the plane off: every stored shard is equal in the two runs
   and to the numpy ``jerasure`` encode, ``mesh_wire_bytes_avoided`` > 0,
   ``mesh_claim_miss`` 0, the board lost nothing, and ``gf2_matrix_w8``'s
   launches (zeroed before and read after each step) rise in the write,
   degraded read and recovery.  (b) ``DistributedCodec`` on (data, shard,
   sub) = (1, 4, 1) and (2, 2, 1) with ``osd_mesh_scatter=on``: encode,
   encode_scatter, verify and reconstruct (chunks 1 and 6) of 8 x 8 MiB
   stripes against ``cpu_engine``, a corrupted stripe failing verify, and
   each owner's parity slice on its cell's device.  (c)
   ``entry.dryrun_multichip(4, fast=True)``.  (d) A ``mesh_shard=2`` pool,
   k=4 m=2, 8 OSDs, 16 x 4 MiB through the storage cycle, every shard
   against numpy.  It prints the GiB/s, time to clean, the plane's
   counters, ledger and board, and the launches per step.
3i. The control plane, reed_sol_van k=8 m=4 w=8 on the ``cuda`` plugin,
   16 OSDs, objects of 4 MiB (RBD's object size).  (a) Object classes
   through librados: ``Rados(16)`` and ``pool_create`` with that profile,
   32 objects by ``IoCtx.write_full``, an ``rbd`` header lifecycle on
   ``rbd_header.img`` (create, set_size, snap_add, snap_protect,
   add_child, set_features, metadata_set / get, a refused unprotect), a
   ``lock`` contended between two ``IoCtx``s, ``version`` inc / check, a
   class method registered here that moves 4 objects through the codec
   (``ClsContext.read`` and ``write_full``), then the header's primary
   OSD killed: ``exec`` and the omap still answer and every object reads
   back exact; every stored shard against the numpy ``jerasure`` encode
   and its crc.  It prints the ``exec`` p50 and p99.  (b) The manager: a
   ``MgrDaemon`` over a cycle of 32 x 4 MiB writes, an OSD killed, a
   quarter overwritten and everything read degraded, revive and
   recovery; ``/health``, ``/status`` and ``/metrics`` scraped over
   HTTP (127.0.0.1, port 0) before the kill, while the OSD is down,
   after recovery and after the balancer: HEALTH_OK, HEALTH_WARN
   (OSD_DOWN, PG_DEGRADED), HEALTH_OK, HEALTH_OK, with
   ``ceph_transfer_bytes_total{direction="h2d"}`` equal to the residency
   ledger's ``h2d_bytes`` at the scrape (the tick loops stopped, so it
   holds still) and every OSD's ``mgr_report_stats`` folded into a
   ``PGMap`` whose health equals ``health_checks``; the balancer's
   ``optimize`` reweights CRUSH and the cluster goes clean again; every
   read exact and every stored shard against numpy.  It prints the scrape
   ms.  (c) ``run_elastic_path_bench()`` at its full shape and gates (10
   OSDs, 3 mons, k=2 m=1, 72 + 16 objects of 12 KiB, 24 clients), then
   its ``_run`` at 16 + 8 objects of 4 MiB and 8 clients under the same
   gates, each with 0 steady library builds.  (d) ``run_failover_bench()``
   at its defaults and at 16 x 4 MiB.  Before each bench's cluster shuts
   down it recovers until clean, and every object's stored shards are
   held against the numpy ``jerasure`` encode of what it reads back
   (without crcs in (b), (c) and (d): (a) and phase 3c check them).
   ``gf2_matrix_w8``'s launches are
   zeroed before and read after every step and must rise in each step
   that encodes or decodes; the phase prints their sum.
3j. The wire: the TCP messenger (``msg/tcp.py`` on the Python wire
   codec, ``osd_wire_codec_native=false`` for (a)-(c)), reed_sol_van k=8 m=4 w=8 on
   the ``cuda`` plugin, 12 OSDs (k+m), each an ``OSDShard`` on its own
   ``TCPMessenger`` on localhost, and a client ``Objecter``.  (a)
   ``run_cluster_path_bench`` at 8 objects of 4 MiB (RBD's object
   size), 8 writers, one iteration: per-message frames, then corked
   bursts, then the messenger-level wire stage (64 fan-outs of 512 KiB
   sub-ops to 12 peers, 32 in flight).  Its gates: every read back exact
   in each cycle, the stored shards equal across the modes; besides,
   every stored shard against the numpy ``jerasure`` encode of its
   object, ``h2d_per_granule`` <= 1 in each write pass and 0 steady
   library builds.  It prints each mode's write and read GiB/s, the wire
   stage's speedup and the wire counters.  (b) One corked cycle of 8 x
   4 MiB with a ``KeyRing`` holding every entity's key (cephx handshake
   on every connection, every frame signed), and one with
   ``osd_msgr_shm_ring=true`` (colocated daemons on shared-memory
   rings): both store (a)'s shards.  (c) ``run_mesh_path_bench`` at
   k=8 m=4, 8 x 4 MiB, 8 writers, mesh sizes 1, 2, 4 and 8 (every card
   when the process sees 8, else ``cuda:0`` eight times): its gates
   (read-back, shards equal across configurations, wire bytes avoided
   monotone, 0 steady library builds) and the ``tcp_only`` shards
   against numpy.  (d) ``gf2_matrix_w8``'s launches are zeroed before and
   read after each of (a), (b) and (c) and must rise in each.  (e) The
   mon repair on the card's cluster: ``create_with_mons`` (12 OSDs, 3
   mons), mon.0's reply to ``osd add`` held past the client's wait: the
   resend answers 0 and every mon's osdmap holds the OSD once.
3k. The native wire codec (``native/wire_native.c``, built with the
   host compiler at first use; the stage markers are its C ones), the
   default configuration.  (a) The codec corpus on the card machine's
   host: ``wire_fuzz.run_fuzz`` over 600 seeded messages (every typed
   kind plain and forced to the Python fallback, then a random mix),
   4 truncation and flip mutants each, the leak gate and 50 ring cases:
   bodies byte-identical and decodes equal; 256 messages sealed in bursts
   of 16 by ``seal_frames`` byte-identical to the Python codec's entry
   frames.  (b) ``run_cluster_path_bench`` at 3j (a)'s shape (12 OSDs on
   localhost TCP, 8 x 4 MiB, 8 writers, per-message and corked, the wire
   stage) on the Python codec, then on the native one: the stored shards
   equal across the codecs and against the numpy ``jerasure`` encode;
   both codecs' write and read GiB/s side by side, ``h2d_per_granule``
   <= 1 and 0 steady library builds.  (c) ``run_wire_tax_bench`` at the
   JAX package's full shape (48 x 16 KiB, 12 writers, ``iters`` 2,
   reed_sol_van k=4 m=2 on ``cuda``) with ``wire_codec.status()`` and
   the marker class printed first, its six host-timing gates at the JAX
   package's smoke-arm limits (coverage 50%, overhead 50%, codec gain
   0.5, share ratio 0.95, OSD-exec share ratio 5.0, ring gain 0.3) and
   every correctness gate as it is, each figure printed beside its
   default gate.  (d) ``run_trace_overhead_bench`` at its shape (48 x 16
   KiB, 8 writers, k=4 m=2 on ``cuda``): stitched trace with the
   ``batch_encode`` span, timeline sums, slow ops, 0 unfinished spans;
   the sampled overhead at the JAX smoke arm's 50%, printed beside its
   3% default gate.
   ``gf2_matrix_w8``'s launches are zeroed before and read after each
   of (b)-(d) and must rise in each.
3l. ``osdc/`` on the card: ``ECCluster(16, plugin="cuda")``, reed_sol_van
   k=8 m=4.  ``RadosStriper`` at libradosstriper's default layout (4 MiB
   objects, 512 KiB stripe unit, stripe count 4) writes a 64 MiB file,
   reads it whole and by 4 ranges, then again with 2 OSDs of its first
   object's acting set down (data shards 1 and 6: decodes); ``Journaler``
   at 4 MiB objects appends 1,024 entries of 4 KiB, a second reader
   replays them, commit and trim drop the first object; ``ObjectCacher``
   write-back at librbd's 32 MiB budget takes 64 MiB of 64 KiB writes to
   16 objects of 4 MiB, flushes, invalidates and reads through;
   ``KvStore`` sets 1,000 keys, scans them sorted and reads 256 back.
   Every data object's stored shards against the numpy ``jerasure``
   encode of its bytes; ``gf2_matrix_w8``'s launches per step, which must
   rise in the writes and the degraded read.
3m. The services on RADOS, each step on ``ECCluster(16, reed_sol_van k=8
   m=4, plugin="cuda")`` (and a second cluster of 8 OSDs at k=4 m=2 where
   it names one).  (a) RBD: a 512 MiB image at order 22 (4 MiB objects) with
   the object map and fast-diff; 128 MiB filled in 4 MiB writes, 512
   writes of 4 KiB at seeded random offsets (read-modify-write encodes),
   snapshot ``s1``, 128 more (copy-on-write), ``s1`` protected and cloned,
   16 writes of 4 KiB to the clone (each copies up a 4 MiB parent block);
   the head, ``s1`` and the clone read whole against a numpy model,
   ``fast_diff(s1)`` and the object map against the objects the model
   touched, the head's written 128 MiB read again with the OSDs of data
   shards 1 and 6 of its first object down (decodes).  (b) A journaled 64
   MiB image (16 writes of 4 MiB, 64 of 4 KiB), mirrored by
   ``MirrorDaemon`` into the k=4 m=2 cluster (bootstrap, then a replay of
   64 more writes), its head checked there; the source demoted, the copy
   promoted, 16 writes of 4 KiB on it, mirrored back; both clusters' shards
   checked.  (c) ``NBDServer`` on a localhost socket, driven by a
   fixed-newstyle client of its own: 64 MiB written and read in 128 KiB
   requests, FLUSH, TRIM, DISC, every reply's error 0, the image equal to
   the client's model.  (d) ``CephFS``: a tree of 500 dentries (48
   directories nested 4 deep, files spread over them, one file in 8 with 4
   KiB), a 64 MiB file at CephFS's documented default layout (4 MiB stripe
   unit, count 1, 4 MiB objects) written in 4 MiB writes and read whole; an
   event journaled and never applied (the MDS died), a fresh MDS replaying
   it, the whole namespace equal to the model; ``MultiMDS`` with 2 ranks, a
   subtree exported and each rank replayed alone.  (e) ``RGWGateway`` with
   one SigV4 user signing with the current time (metadata on a replicated
   pool): 16 PUTs and GETs of 4 MiB (ETag = md5), HEAD, a prefix listing,
   DELETE, the error envelopes of NoSuchKey, NoSuchBucket,
   SignatureDoesNotMatch and BucketNotEmpty, a 64 MiB multipart upload in 8
   MiB parts (the ``-8`` ETag), 3 versions of one key listed and read, 4
   GETs with 2 OSDs down, ``RGWSyncAgent`` into a second zone on the k=4
   m=2 cluster whose listings and bodies must equal the first's; every
   request's status is checked.  (f) The port's ``rbd_cli``: ``import`` of
   a 64 MiB file, ``snap create``, ``ls``, ``info`` and ``export`` (each
   command a process-local cluster of 16 OSDs on ``blockstore`` under the
   checkout's ``build/``), the export byte-equal to the source.  In every
   step every data object's stored shards equal the numpy ``jerasure``
   encode of the model's bytes, and ``gf2_matrix_w8``'s launches, zeroed
   before and read after each write step and degraded read, rise (read-only
   steps that decode nothing print theirs).  The phase prints its seconds
   beside its 120 s budget.
3n. Daemons in processes of their own and the load generator.  (a) The
   port's ``vstart.start_cluster`` boots 3 mons, 1 mgr and 8 OSD processes
   (``python -m ceph_tpu_torch.daemon.*``; each OSD makes its own CUDA
   context and loads the kernel library at boot), the pool reed_sol_van
   k=4 m=2 w=8 on the ``cuda`` plugin, the OSDs on ``blockstore`` under a
   short run directory (``tempfile.mkdtemp``).  A ``RemoteClient`` writes
   32 x 4 MiB of seeded bytes with 8 writers and reads them back; every
   OSD's ``residency status`` is read over its admin socket before and
   after, and the H2D and D2H ops must rise summed over the OSDs and on
   each OSD that led a written object's placement group.  One OSD (data
   shard 0 of the first object) is SIGKILLed and the mon marks it down
   from peer heartbeats alone; every object reads back degraded,
   bit-exact (the summed H2D and D2H ops rise again); the OSD is revived
   through ``ceph_volume prepare`` and ``activate`` (phase 3o (c)) and
   the mgr's ``pg stat`` degraded count, sampled over its admin
   socket from the kill on, rises and then drains with at most one uptick
   to HEALTH_OK.  ``ceph_daemon`` runs ``perf dump``, ``config show``,
   ``residency status`` and ``cpu_profiler`` start and stop against the
   revived OSD, each a process; then phase 3o (b) runs ``rados_cli``
   against the cluster.  ``rbd_nbd`` runs as a process over the
   cluster and exports a 16 MiB image (order 22), which phase 3m's NBD
   client writes and reads in 128 KiB requests against its model (FLUSH,
   TRIM, DISC); the image read back through a new client equals the
   model.  After ``stop_cluster`` (SIGTERM; each OSD unmounts its store)
   every OSD's blockstore is mounted in this process and every stored
   shard of the 32 objects, the objects ``rados_cli`` left and the
   image's 4 data objects is compared with the port's numpy ``jerasure``
   encode of its bytes; then phase 3o (d) runs the offline tools on what
   the cluster left.  Each daemon's
   card memory from ``nvidia-smi --query-compute-apps`` is printed
   (information only).  (b) ``run_telemetry_bench()`` at its defaults (6
   OSDs, k=2 m=1, 48 x 16 KiB, 8 writers, 2 iterations, chaos 24 clients
   for 6 s) on ``cuda``, its report-loop overhead run at the JAX smoke
   arm's 25% and printed beside its 3% default gate, then
   ``run_vstart_smoke()`` (4 OSD processes, 30 x 16 KiB, k=2 m=1 on
   ``cuda``).  (c) ``qos_bench``'s four stages at the JAX package's
   acceptance shape on ``cuda``: overload (8 gold, 80 bulk clients), chaos
   (300 clients), scale (1,000) and scale10x (10,000), every correctness
   gate armed (the exactly-once audit, client counts, ops moved, admission
   waits, bulk ops, chaos fired) and the three host-timing gates
   (reservation ratio >= 0.9, closed-loop clients at zero ops <= max(2,
   closed / 50), scale10x p99 <= the scale stage's p99) run open and
   printed beside their defaults.  The OSDs of (b)'s bench and of every
   (c) stage run in this process: ``gf2_matrix_w8``'s launches, zeroed
   before and read after each, must rise in each.  The phase prints its
   seconds, less those of phase 3o's steps inside (a), beside its 240 s
   budget.
3o. The operator's command-line tools (``ceph_tpu_torch/tools/``), each
   called through its ``main(argv)`` with its output checked line by
   line.  (a) ``rados_bench`` at its own defaults (20 OSDs of an
   in-process ``ECCluster``, 16 x 4 MiB) with ``--profile
   "plugin=cuda technique=reed_sol_van k=8 m=4 w=8"``: its two JSON
   lines, ``gf2_matrix_w8``'s launches (zeroed before, must rise), and
   every stored shard against the numpy ``jerasure`` encode of its
   payload with its HashInfo crc against the plain crc32c, before the
   cluster shuts down; then ``rados_bench`` with no arguments (its
   default lrc profile, whose layers are ``jerasure``'s: the host, no
   kernel launch).  (b) Inside 3n (a), between ``ceph_daemon`` and
   ``rbd_nbd``: every ``rados_cli`` subcommand against the 8 OSD
   processes: ``put`` of 3 x 4 MiB (the first a process of its own; the
   OSDs' summed H2D and D2H ops must rise), ``get`` to stdout (a process)
   and to a file, ``stat``, ``setomapval`` and ``listomapvals``, ``rm``
   of one, ``ls``, ``df``, ``health [detail]``, ``pg stat``, ``status``,
   ``log last``, ``tier status``, ``recovery status``, ``ops`` (in
   flight, historic, slow), ``trace`` (status and one trace id from an
   OSD's ring), ``profile`` (status, dump, reset) and ``residency
   status``; the objects it leaves join 3n (a)'s shard check.  (c)
   ``ceph_volume prepare`` and ``activate`` revive 3n (a)'s SIGKILLed
   OSD on its blockstore (a daemon that builds its codec on the card
   before it listens); ``prepare``, a refused second ``prepare``, an
   ``activate`` without a cluster and ``list`` on a fresh run directory.
   (d) After 3n (a)'s clean stop: ``monstore_tool`` (``show-versions``,
   ``dump-paxos``, ``dump-keys``, ``get-osdmap``) on ``mon.0``'s store;
   ``osdmaptool`` on that map (``--print``, ``--test-map-pgs`` summing
   to pg_num x 6 with no holes, ``--test-map-object d0`` equal to the
   client's acting set, ``--mark-out`` of the victim, whose count goes
   to 0); ``objectstore_tool`` ``list``, ``info``, ``export``, ``import``
   into a fresh store (bytes and attributes equal) and ``remove`` on a
   filestore and a kstore of 3 x 4 MiB written here; ``ceph_cli`` with
   the flagship ``cuda`` profile (a pool on it, a refused ``rm``).  Any
   wrong byte, missing line or exit code fails the smoke; the phase
   prints its seconds, (a) and the steps inside 3n (a), beside its 90 s
   budget.
4. One run of the port's ``ec_benchmark`` (batched decode, chunks 1 and 6
   erased), one of ``-w storage-path --profile`` at the flagship profile
   (32 objects of 4 MiB), one of ``-w recovery-path`` with 32 objects
   of 4 MiB (its bench called directly; its gates: bit-exact rebuild,
   identical rebuilt stores in both modes, the batched lane used, client
   p99 under the JAX test's 10,000 ms, printed beside its 2000 ms default
   gate), one of ``-w repair-path`` (its bench called directly) with 32
   objects of 4 MiB on 8 OSDs, at an
   ``osd_recovery_batch_bytes`` of 256 MiB (at the default 8 MiB a 4 MiB
   object's chunks exceed its share of a batch and take the windowed
   per-object path, which has no regen lane) (its gates:
   the chaos drain, bit-exact reads in both modes, identical rebuilt
   victim stores, the regen lane used by the fractional mode only,
   gather ratio <= 0.75 and time-to-clean ratio <= the JAX test's 2.0,
   printed beside its 1.25 default gate; it prints per
   mode the gather bytes, time to clean and helper symbols served, and
   ``gf2_matrix_w8`` must be launched in the fractional mode's rebuild),
   and one of ``-w tier-path`` with 8 objects of 4 MiB (its gates: every
   object promoted, hot and cold reads bit-exact), then ``-w
   cluster-path`` (8 x 4 MiB, k=8 m=4) and ``-w mesh-path`` (8 x 4 MiB,
   k=8 m=4, mesh sizes 1 and 2) on the native wire codec, each printing
   the JAX tool's JSON keys.
5. The fourteen sweep kernels (``csrc/sweep_kernels.cu`` and
   ``csrc/xornet_kernel.cu``) against their plain versions at the sweep's
   shape, lanes [8, 2097152], and at a ragged one: ``sweep_xornet`` for
   reed_sol_van and for cauchy_good k=8 m=4 (a second library, built for
   that bitmatrix), the three ``sweep_prec_*`` kernels at tiles 4096 and
   16384 (beside their PR 5 designs' times), ``sweep_split_f32`` at parts
   2 (tile 8192) and parts 4 and 8 (tile 16384), ``sweep_planes_f32``
   over the 1 GiB of ``field_planes``
   (freed after use).  ``sweep_copy`` and its library call,
   ``x[:m].clone()``, are timed in turns (7 of each, flushed and back to
   back; medians and spread).  Then ``sweep_copy`` at m = 1, a ragged
   total, an unaligned pointer and a partial last block, and
   ``sweep_split_f32`` at k = 1, k = 16 m = 8, m = 1, 3 and 5, n4 = 1003
   and 100003, unaligned pointers and sums past 2^23, each at parts 2, 4
   and 8 and tiles 32 * parts, 8192 and 16384, and the three precision
   kernels at the same cases, each at tiles 4096, 16384 and 4128 (a
   ragged last 64-lane sub-tile), and the four wgmma product rows
   (``sweep_int8_4dot``, ``sweep_bf16_4dot``, ``sweep_f32_4dot``,
   ``sweep_bf16_blockdiag``) at the same cases where they take k and m,
   with an all-ones table over all-ones words (k=8 m=4 and k=16 m=8) and
   the block-diagonal row at its widest k (24 at m = 4, 75 at m = 1),
   unaligned and ragged, and ``sweep_xornet`` at every n4 % 8, n4 = 4,
   an unaligned pointer, k = 1, k = 16 m = 8, m = 1, 3 and 5, and all-ones
   words (under both bitmatrices and the all-ones one), also against
   ``matrix_encode_w8``.  Then the port's kernel
   sweep (``ec_kernel_sweep.main``, all three stages) at 8 MiB chunks,
   which must exit 0 with every variant and probe row bit-exact, the
   HIGHEST and HIGH precision rows bit-exact and the DEFAULT rows
   MISMATCH.  The first eleven sweep kernels' launches are counted during
   the sweep.
6. The port's split-chain and split-cost probes (``kernel_r4_split.main``,
   ``kernel_r4_probe.main``) at 8 MiB chunks, each of which must exit 0:
   split2, split4 and split8 bit-exact and split1 DEFAULT MISMATCH; full,
   extract-only and mxu-only bit-exact.  ``sweep_split_f32``,
   ``sweep_extract_fold`` and ``sweep_planes_f32``'s launches are counted
   during these runs.

The kernel sources build at once, one ``nvcc`` each (the XOR network's
once per bitmatrix that phase 5 runs).  Every phase prints ``[phase]
<name> <seconds> s``.  Only correctness decides the exit code: a ratio
of host wall times (a bench's overhead, share or speed ratio, a client
p99) runs at the limit the JAX package's own smoke arm or test gives the
same bench and is printed beside its default gate as ``held`` or
``MISSED``; where the JAX package has no looser value, the gate runs
open.  It prints the ``kernels`` JSON line and, last, the device
line.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import gc
import hashlib
import io
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ceph_tpu_torch import parallel
from ceph_tpu_torch.analysis import residency
from ceph_tpu_torch.matrices import cauchy, liberation, reed_sol
from ceph_tpu_torch.native import build as native_build
from ceph_tpu_torch.native import gf_native, registry_native
from ceph_tpu_torch.osd import (cluster_bench, durable_bench, ecutil,
                                storage_bench)
from ceph_tpu_torch.osd.cluster import ECCluster
from ceph_tpu_torch.matrices.bitmatrix import (matrix_to_bitmatrix,
                                               survivor_decode_bitmatrix)
from ceph_tpu_torch.msg import cluster_bench as wire_bench
from ceph_tpu_torch.msg import mesh_bench
from ceph_tpu_torch.ops import cpu_engine, cuda_gf, sweep_gf
from ceph_tpu_torch.ops.gf import gf
from ceph_tpu_torch.ops.pipeline import DeviceStream, granules_dispatched
from ceph_tpu_torch.parallel import mesh_plane
from ceph_tpu_torch.plugins import registry as registry_mod
from ceph_tpu_torch.tier.device_tier import (DeviceByteAccount,
                                             device_byte_account)
from ceph_tpu_torch.tier.tier_bench import run_tier_path_bench
from ceph_tpu_torch.tools import (ec_bench_sweep, ec_benchmark, ec_info,
                                  ec_kernel_sweep, ec_non_regression,
                                  kernel_r4_probe, kernel_r4_split)
from ceph_tpu_torch.utils.config import get_config
from ceph_tpu_torch.utils.encoding import Decoder, Encoder
from ceph_tpu_torch.utils.perf import PerfCounters

#: H100 SXM published memory rate (NVIDIA data sheet) at the 700 W limit
HBM_BYTES_PER_S = 3.35e12

K, M = 8, 4
STRIPE = 8 << 20  # 8 MiB payload -> 1 MiB chunks at k=8
ERASED = (1, 6)

#: (label, profile, stripes in the batch, the kernel the profile runs)
PROFILES = (
    ("reed_sol_van w=8", {"technique": "reed_sol_van"}, 8, "gf2_matrix_w8"),
    ("reed_sol_van w=16", {"technique": "reed_sol_van", "w": "16"}, 4,
     "gf2_matrix_w16"),
    ("cauchy_good packetsize=2048",
     {"technique": "cauchy_good", "packetsize": "2048"}, 4, "gf2_packet"),
)

#: the storage path's configurations: (label, profile, objects, the kernel
#: the profile runs).  4 MiB is RBD's default object (rbd_default_order 22)
#: and RGW's stripe (rgw_obj_stripe_size); the flagship's 32 objects were
#: 64 until phase 3o needed the room (so were 3g's, 3h's, 3i's, the tier
#: bench's and phase 4's storage path)
STORAGE_PROFILES = (
    ("reed_sol_van w=8", {"technique": "reed_sol_van"}, 32, "gf2_matrix_w8"),
    ("reed_sol_van w=16", {"technique": "reed_sol_van", "w": "16"}, 16,
     "gf2_matrix_w16"),
    ("cauchy_good packetsize=2048",
     {"technique": "cauchy_good", "packetsize": "2048"}, 16, "gf2_packet"),
)
OBJECT = 4 << 20
WRITERS = 8
#: the cluster path: OSDs over a flat CRUSH map, the configurations (as
#: the storage path's), every CLUSTER_OVERWRITE-th object overwritten
#: while degraded, and the recovery deadline
CLUSTER_OSDS = 16
CLUSTER_PROFILES = STORAGE_PROFILES
CLUSTER_OVERWRITE = 4
CLUSTER_DEADLINE_S = 120.0
#: the cycle's steps whose codec launches must rise
CLUSTER_KERNEL_STEPS = ("write", "degraded_read", "recovery")
STORAGE_ERASURES = 2
STORAGE_ITERS = 2
CRC_PREFIX = 64 << 10
#: the tier path (phase 3d): objects of the writeback and readproxy
#: cycles, the tier bench's objects, and turns of the hash-cost passes
TIER_OBJECTS = 64
TIER_READPROXY_OBJECTS = 16
TIER_BENCH_OBJECTS = 32
HASH_TURNS = 2
#: device bytes the codec itself keeps during a cycle, outside the ledger:
#: the nibble tables of the encode and decode streams (1 KiB each at k=8
#: m=4 w=8) -- the slack of the ledger-against-allocator check
CODEC_TABLE_SLACK = 1 << 20

#: the plugin family (phase 3e): (label, plugin, profile on the card,
#: profile of its CPU twin, the kernel it runs, chunks erased in decode)
FAMILY_STRIPES = 8
FAMILY_STRIPE = 4 << 20
_LRC_KML = {"k": "4", "m": "2", "l": "3"}
FAMILY = (
    ("isa reed_sol_van k=7 m=3", "isa",
     {"technique": "reed_sol_van", "backend": "cuda"},
     {"technique": "reed_sol_van"}, "gf2_matrix_w8", (1, 8)),
    ("isa cauchy k=7 m=3", "isa", {"technique": "cauchy", "backend": "cuda"},
     {"technique": "cauchy"}, "gf2_matrix_w8", (1, 8)),
    ("shec k=4 m=3 c=2 w=8", "shec", {"backend": "cuda"}, {},
     "gf2_matrix_w8", (1, 5)),
    ("shec k=4 m=3 c=2 w=16", "shec", {"w": "16", "backend": "cuda"},
     {"w": "16"}, "gf2_matrix_w16", (1, 5)),
    ("lrc k=4 m=2 l=3, cuda layers", "lrc", None, dict(_LRC_KML),
     "gf2_matrix_w8", (1,)),
    ("regen k=4 m=3 d=6", "regen", {"k": "4", "m": "3"},
     {"k": "4", "m": "3", "device": "cpu"}, "gf2_matrix_w8", (1, 5)),
)
#: a regen helper width off the 4-byte lane grid: the host path on the card
OFF_LANE_BETA = 4099
#: the native engine (phase 3f): (label, plugin, profile, chunks erased),
#: each run at backend=native against backend=cpu over phase 3e's stripes
NATIVE = (
    ("jerasure reed_sol_van k=8 m=4", "jerasure",
     {"technique": "reed_sol_van", "k": "8", "m": "4"}, (1, 6)),
    ("jerasure cauchy_good k=8 m=4 packetsize=2048", "jerasure",
     {"technique": "cauchy_good", "k": "8", "m": "4",
      "packetsize": "2048"}, (1, 6)),
    ("isa reed_sol_van k=8 m=4", "isa",
     {"technique": "reed_sol_van", "k": "8", "m": "4"}, (1, 6)),
    ("shec k=4 m=3 c=2", "shec", {"k": "4", "m": "3", "c": "2"}, (1, 5)),
)
#: the reference's failure codes of the broken fixtures and of a missing
#: file (tests/test_native_registry.py)
NATIVE_FAILURES = {
    "missing_version_native": -18, "wrong_version_native": -18,
    "missing_entry_point_native": -2, "fail_to_initialize_native": -3,
    "fail_to_register_native": -9, "no_such_plugin_native": -2,
}
HANG_TIMEOUT_MS = 300
CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "data", "ec_corpus")
CODEC_KERNELS = ("gf2_matrix_w8", "gf2_matrix_w16", "gf2_packet")
CRUSHTOOL_ARGV = ("--build", "16", "--rule", "erasure", "--num-rep", "12",
                  "--show-utilization")
#: the durable cluster (phase 3g): (label, profile, object store, with
#: mons, objects, objects written degraded, the kernel the profile runs);
#: the OSDs and mons, the cycle's steps that must launch the kernel, and
#: the replicated index pool's objects, their bytes and omap keys
DURABLE_OSDS = 16
DURABLE_MONS = 3
DURABLE_PROFILES = (
    ("reed_sol_van w=8 on blockstore, 3 mons", {"technique": "reed_sol_van"},
     "blockstore", True, 32, 8, "gf2_matrix_w8"),
    ("reed_sol_van w=16 on filestore",
     {"technique": "reed_sol_van", "w": "16"}, "filestore", False, 16, 4,
     "gf2_matrix_w16"),
    ("cauchy_good packetsize=2048 on kstore",
     {"technique": "cauchy_good", "packetsize": "2048"}, "kstore", False, 16,
     4, "gf2_packet"),
)
DURABLE_KERNEL_STEPS = ("write", "degraded_read", "degraded_write",
                        "remount_read", "recovery")
INDEX_OBJECTS = 256
INDEX_BYTES = 512
INDEX_KEYS = 16
#: where the durable cluster's data paths go: the checkout's gitignored
#: build directory, on the machine's local disk
DURABLE_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "ceph_tpu_torch", "build")
#: the mesh data plane (phase 3h): slots of the plane (every card the
#: process sees, else one card this many times), the full-width cluster's
#: OSDs and objects, the grids of the codec step, and the mesh_shard pool
MESH_SLOTS = 4
MESH_OSDS = 16
MESH_OBJECTS = 32
MESH_GRIDS = ((1, 4, 1), (2, 2, 1))
MESH_STRIPES = 8
MESH_SHARD_PROFILE = {"technique": "reed_sol_van", "k": "4", "m": "2",
                      "mesh_shard": "2"}
MESH_SHARD_OSDS = 8
MESH_SHARD_OBJECTS = 16
#: the control plane (phase 3i): OSDs, objects of RBD's object size, the
#: deadline of a wait for clean, the elastic bench's second run (phase
#: 3c's client count at RBD's object size; 16 + 8 objects, cut from 32 +
#: 8, which took 52.8 s of a 103.8 s phase on the H100) and the failover
#: bench's second run
CONTROL_OSDS = 16
CONTROL_OBJECTS = 32
CONTROL_DEADLINE_S = 120.0
ELASTIC_4M = {"n_objects": 16, "obj_bytes": OBJECT, "n_hot": 8,
              "n_clients": WRITERS, "moved_ratio_bound": 1.25,
              "uptick_bound": 2, "client_p99_bound_ms": 2000.0, "seed": 99}
FAILOVER_4M = {"n_objects": 16, "obj_bytes": OBJECT}
#: the wire (phase 3j): the cluster-path bench's objects (of OBJECT
#: bytes, on k+m OSDs; cut from 64, whose bench alone took 50.6 s on the
#: H100's host, then 32, 24 and 16, with which the phase took 51-82 s;
#: 8 since phase 3o needed the room) and its payload seed, the signed and
#: ring cycles' objects (16 until phase 3o), the mesh-path sweep's
#: objects (cut from 32, 16 and 12), sizes and payload seed, and the mon
#: repair's wait and held reply
WIRE_OBJECTS = 8
WIRE_SEED = 4321
WIRE_SIDE_OBJECTS = 8
WIRE_MESH_OBJECTS = 8
WIRE_MESH_SIZES = (1, 2, 4, 8)
WIRE_MESH_SEED = 1717
WIRE_MON_WAIT_S = 0.5
WIRE_MON_HOLD_S = 1.5
#: the native wire (phase 3k): the codec corpus (cases of the fuzzer's
#: seeded corpus, messages sealed in bursts), and the JAX package's full
#: shapes of its wire-tax and trace-path benches (their defaults); the
#: gates are the benches' own defaults
NATIVE_CORPUS_CASES = 600
NATIVE_SEAL_MESSAGES = 256
NATIVE_SEAL_BURST = 16
WIRE_TAX_SHAPE = {"n_objects": 48, "obj_bytes": 16 << 10, "writers": 12,
                  "iters": 2}
TRACE_SHAPE = {"n_objects": 48, "obj_bytes": 16 << 10, "writers": 8,
               "iters": 2}
#: the JAX package's k=4 m=2 profile of both benches, on the cuda plugin
WIRE_TAX_PROFILE = {"technique": "reed_sol_van", "k": "4", "m": "2"}
#: the wire-tax bench's gates at their defaults (the JAX package's), and
#: the limits phase 3k (c) runs: the JAX package's own smoke arm's
#: (``ceph_tpu/profiling/wire_tax_bench.py:628-630``, the limits of its
#: ``--smoke``).  Each of the six is a ratio of host wall times on the
#: card machine's shared host, not a fact about correctness: in ten runs
#: of the bench on the H100 machine the enabled overhead read -10.5% to
#: 49.0% (gate 3%) and the OSD-exec share ratio 0.44 to 0.94 (gate 0.6).
#: The phase prints each figure beside its default gate
WIRE_TAX_GATES = {"coverage_min_pct": 90.0, "overhead_limit_pct": 3.0,
                  "codec_gain_min": 1.5, "codec_share_ratio_max": 0.5,
                  "osd_share_ratio_max": 0.6, "ring_gain_min": 0.85}
WIRE_TAX_LIMITS = {"coverage_min_pct": 50.0, "overhead_limit_pct": 50.0,
                   "codec_gain_min": 0.5, "codec_share_ratio_max": 0.95,
                   "osd_share_ratio_max": 5.0, "ring_gain_min": 0.3}
#: the trace-path bench's sampled-overhead gate at its default (the JAX
#: package's) and the limit phase 3k (d) runs: the JAX package's smoke
#: arm's (``ceph_tpu/osd/trace_bench.py:301``); a ratio of host wall
#: times, -31.5% to +2.5% in ten runs on the H100 machine
TRACE_GATE_PCT = 3.0
TRACE_LIMIT_PCT = 50.0
#: osdc (phase 3l): OSDs; libradosstriper's default layout
#: (``rados_striper.py:35-38``) and the striped file's size; the
#: journal's object size, entries and entry size; the object cacher's
#: budget (librbd's rbd_cache_size), bytes written and write size; the
#: key-value store's keys; OSDs down for the striper's degraded reads
OSDC_OSDS = 16
OSDC_FILE = 64 << 20
OSDC_RANGES = ((0, 1 << 20), (3 << 19, 5 << 20), (OSDC_FILE - 777_777,
                                                  777_777),
               ((17 << 20) + 12345, 9 << 20))
OSDC_JOURNAL_OBJECT = 4 << 20
OSDC_JOURNAL_ENTRIES = 1024
OSDC_JOURNAL_ENTRY = 4 << 10
OSDC_CACHE_BYTES = 32 << 20
OSDC_CACHE_WRITTEN = 64 << 20
OSDC_CACHE_WRITE = 64 << 10
#: cut from 10,000 (66-94 s of host-bound omap round trips on the H100
#: machine) to make room for phase 3n, then from 2,000 for phase 3o;
#: 1,000 keys still split the store into a dozen or more 64-key buckets
OSDC_KV_KEYS = 1_000
OSDC_DOWN = 2
#: the services on RADOS (phase 3m): OSDs of the primary cluster (the
#: flagship profile) and of the mirror's and the second zone's cluster,
#: whose profile is k=4 m=2; RBD: a 512 MiB image (1 GiB until the tools'
#: phase 3o needed the room, which also halved the bytes filled, the
#: random writes before the snapshot and CephFS's dentries and
#: directories) at librbd's default order 22 (4 MiB objects), the bytes
#: filled in 4 MiB writes, ``rbd bench``'s
#: default 4 KiB io size, the random 4 KiB writes before the snapshot,
#: after it and to the clone (each of the last copies up a parent block);
#: the journaled image, its 4 KiB writes and those on the promoted copy;
#: the NBD export and its request size; RGW's 4 MiB objects, the multipart
#: upload in the AWS CLI's default 8 MiB parts, the versions and the
#: degraded GETs; CephFS's tree (its dentries, its directories and how
#: deep they nest, one file in so many with 4 KiB), the file at CephFS's
#: documented default layout (4 MiB stripe unit, count 1, 4 MiB objects:
#: the JAX package's ``DEFAULT_LAYOUT`` is 1 MiB) and its write size; the
#: file the CLI imports and the object store under it (``blockstore``, the
#: counterpart of BlueStore, Ceph's default store); the data shards whose
#: OSDs go down; the phase's budget
SVC_OSDS = 16
SVC_PEER_OSDS = 8
SVC_PEER_PROFILE = {"k": "4", "m": "2"}
SVC_IMAGE = 512 << 20
SVC_ORDER = 22
SVC_FILLED = 128 << 20
SVC_IO = 4 << 10
SVC_RANDOM_WRITES = 512
SVC_SNAP_WRITES = 128
SVC_CHILD_WRITES = 16
SVC_JOURNAL_IMAGE = 64 << 20
SVC_JOURNAL_WRITES = 64
SVC_FAILBACK_WRITES = 16
SVC_NBD_BYTES = 64 << 20
SVC_NBD_REQUEST = 128 << 10
SVC_RGW_ACCESS, SVC_RGW_SECRET = "smoke", "smokesecret"
SVC_RGW_OBJECTS = 16
SVC_RGW_MULTIPART = 64 << 20
SVC_RGW_PART = 8 << 20
SVC_RGW_VERSIONS = 3
SVC_RGW_DEGRADED = 4
SVC_FS_DENTRIES = 500
SVC_FS_DIRS = 48
SVC_FS_DEPTH = 4
SVC_FS_DATA_EVERY = 8
SVC_FS_BIG = 64 << 20
SVC_FS_WRITE = 4 << 20
SVC_FS_LAYOUT = (4 << 20, 1, 4 << 20)
SVC_CLI_BYTES = 64 << 20
SVC_CLI_STORE = "blockstore"
SVC_DOWN = (1, 6)
SVC_BUDGET_S = 120.0
#: phase 3n (a): a cluster of processes booted by the port's vstart: 3
#: mons, 1 mgr and 8 OSD daemons (each its own process and CUDA context),
#: reed_sol_van k=4 m=2 w=8 on the cuda plugin, blockstore under a short
#: run directory (an admin socket's path must fit in 107 bytes)
DAEMON_OSDS = 8
DAEMON_MONS = 3
DAEMON_PROFILE = {"plugin": "cuda", "technique": "reed_sol_van", "k": "4",
                  "m": "2", "w": "8"}
DAEMON_OBJECTS = 32
DAEMON_WRITERS = 8
DAEMON_STORE = "blockstore"
#: seconds the daemons get to boot (each loads torch, makes its CUDA
#: context and loads the kernel library) and to mark down and drain
DAEMON_WAIT_S = 120.0
DAEMON_DEADLINE_S = 90.0
#: the daemons' settings (their environment layer): the vstart telemetry
#: smoke's chaos time scale, so the mgr's degraded series is observable
DAEMON_ENV = {
    "CEPH_TPU_TORCH_MGR_BEACON_INTERVAL": "0.1",
    "CEPH_TPU_TORCH_MGR_REPORT_INTERVAL": "0.2",
    "CEPH_TPU_TORCH_MGR_DAEMON_BEACON_GRACE": "1.5",
    "CEPH_TPU_TORCH_MGR_PG_STALE_GRACE": "3.0",
}
DAEMON_IMAGE = "nbd0"
#: the image ``rbd_nbd`` exports, in ``SVC_NBD_REQUEST`` requests (64 MiB
#: until phase 3o needed the room, then 32)
DAEMON_NBD_BYTES = 16 << 20
DAEMON_CEPH_DAEMON = (("perf", "dump"), ("config", "show"),
                      ("residency", "status"),
                      ("cpu_profiler", "action=start"),
                      ("cpu_profiler", "action=stop"))
DAEMON_BUDGET_S = 240.0
#: phase 3o: the operator's command-line tools.  (a) ``rados_bench`` at
#: its own defaults (``rados_bench.OSDS``, ``OBJECTS``, ``SIZE``: 20 OSDs,
#: 16 x 4 MiB) under the flagship profile on the card (``bench.py:32-37``),
#: then once at its default lrc profile, whose generated layers are
#: jerasure's (the host); (b) ``rados_cli`` against 3n (a)'s cluster, its
#: objects of 4 MiB; (d) ``objectstore_tool``'s filestore and kstore, each
#: holding a few 4 MiB objects; the phase's budget
TOOLS_PROFILE = "plugin=cuda technique=reed_sol_van k=8 m=4 w=8"
TOOLS_CLI_OBJECTS = 3
TOOLS_STORE_OBJECTS = 3
TOOLS_BUDGET_S = 90.0
#: phase 3n (b) and (c): the host-timing gates at their defaults (the JAX
#: package's) and the limits the smoke runs them at: the telemetry report
#: loop's overhead at the JAX smoke arm's 25%
#: (``ceph_tpu/mgr/telemetry_bench.py:218-221``); the QoS gates, for which
#: the JAX package has no looser value (its smoke arm skips the two scale
#: gates), open
TELEMETRY_OVERHEAD_GATE_PCT = 3.0
TELEMETRY_OVERHEAD_LIMIT_PCT = 25.0
QOS_RESERVATION_GATE = 0.9
QOS_STARVED_DIVISOR = 50
QOS_P99_VS_1K_GATE = 1.0
#: scale10x at the JAX package's acceptance shape (10^4 clients); True
#: runs its smoke shape (500 clients)
QOS_SCALE10X_SMOKE = False
#: the repair path (phase 4): objects of RBD's default size on 8 OSDs,
#: with a recovery batch budget that gives each object of a full batch
#: (32) its k whole 1 MiB chunks: at the default 8 MiB a 4 MiB object's
#: chunk exceeds its share of the batch, so both modes recover it through
#: the windowed per-object path, where no regen lane exists
REPAIR_OBJECTS = 32
REPAIR_BATCH_BYTES = 256 << 20
#: phase 4's host-timing gates at their defaults (the JAX package's) and
#: the limits it runs them at, those the JAX package's own tests give the
#: same benches: the repair path's time-to-clean ratio (two cleanups of
#: about 0.3 s; 0.66 to 1.32 in ten runs on the H100 machine) at 2.0
#: (``tests/test_regen.py:407``) and the recovery path's client p99 at
#: 10,000 ms (``tests/test_recovery_path.py:347``)
REPAIR_TIME_RATIO_GATE = 1.25
REPAIR_TIME_RATIO_LIMIT = 2.0
RECOVERY_P99_GATE_MS = 2000.0
RECOVERY_P99_LIMIT_MS = 10_000.0

KERNEL_SOURCE = "ceph_tpu_torch/csrc/gf_kernels.cu"
REPLACES = {
    "gf2_matrix_w8": "ceph_tpu/ops/pallas_gf.py:57",
    "gf2_matrix_w16": "ceph_tpu/ops/pallas_gf.py:153",
    "gf2_packet": "ceph_tpu/ops/pallas_gf.py:240",
}
#: each codec kernel's flushed time at this phase's shape in its first,
#: bit-sliced mask-table design (NVIDIA H100 80GB HBM3 at 700 W), printed
#: beside the time measured now
MASK_TABLE_MS = {"gf2_matrix_w8": 0.0970, "gf2_matrix_w16": 0.0998,
                 "gf2_packet": 0.1029}
#: sweep kernels redesigned since: their flushed time in the earlier
#: design at phase 5's shape (the mask-table ``sweep_pipelined_w8``; same
#: card and limit), printed beside the time measured now
EARLIER_MS = {"sweep_pipelined_w8": 0.0932, "sweep_copy": 0.0296,
              "sweep_split_f32": 0.6323, "sweep_prec_f32": 0.5431,
              "sweep_prec_tf32x3": 0.2974, "sweep_prec_tf32": 0.1963,
              "sweep_int8_4dot": 0.1562, "sweep_bf16_4dot": 0.2380,
              "sweep_f32_4dot": 0.2738, "sweep_bf16_blockdiag": 0.6130,
              "sweep_xornet": 0.0741}
#: turns of the interleaved copy and clone timings (each a mean of 20
#: flushed launches and a CUDA graph of 48 back to back)
COPY_TURNS = 7
CSRC_PATH = "ceph_tpu_torch/csrc/"
SWEEP_REPLACES = {
    "sweep_copy": "tools/ec_kernel_sweep.py:117",
    "sweep_extract": "tools/ec_kernel_sweep.py:121",
    "sweep_pipelined_w8": "tools/ec_kernel_sweep.py:76",
    "sweep_int8_4dot": "experiments/kernel_r4.py:76",
    "sweep_bf16_4dot": "experiments/kernel_r4.py:52",
    "sweep_f32_4dot": "experiments/kernel_r4.py:52",
    "sweep_bf16_blockdiag": "experiments/kernel_r4.py:100",
    "sweep_xornet": "experiments/kernel_r4.py:129",
    "sweep_prec_f32": "experiments/kernel_r4.py:315",
    "sweep_prec_tf32x3": "experiments/kernel_r4.py:315",
    "sweep_prec_tf32": "experiments/kernel_r4.py:315",
    "sweep_split_f32": "experiments/kernel_r4_split.py:51",
    "sweep_extract_fold": "experiments/kernel_r4_probe.py:38",
    "sweep_planes_f32": "experiments/kernel_r4_probe.py:54",
}
#: the kernels that phase 6's probe tools run, and count
PROBE_KERNELS = ("sweep_split_f32", "sweep_extract_fold", "sweep_planes_f32")
#: why a sweep kernel has no library call to time beside it
_PRODUCT = "no single PyTorch call computes extraction + product + parity"
NO_LIBRARY = {
    "sweep_extract": "no single PyTorch call computes the 16 shifted "
                     "field sums",
    "sweep_extract_fold": "no single PyTorch call computes the folded "
                          "field sums",
    "sweep_pipelined_w8": "no single PyTorch call computes a GF(2) "
                          "bitmatrix product",
    **dict.fromkeys(("sweep_int8_4dot", "sweep_bf16_4dot", "sweep_f32_4dot",
                     "sweep_bf16_blockdiag", "sweep_prec_f32",
                     "sweep_prec_tf32x3", "sweep_prec_tf32",
                     "sweep_split_f32", "sweep_planes_f32"), _PRODUCT),
    "sweep_xornet": "no single PyTorch call computes a GF(2) bitmatrix "
                    "product",
}
#: lanes per row: the sweep's 8 MiB chunks, and a ragged width that is no
#: multiple of 4 lanes, of the pipelined tile or of a warp's 32 int8 lanes
SWEEP_N4 = (8 << 20) // cuda_gf.LANE_BYTES
RAGGED_N4 = 100003


def _profile(extra: dict) -> dict:
    return {"k": str(K), "m": str(M), **extra}


def _kernel_case(name, ec, batch, dev, gen):
    """The kernel's wrapper, plain version and operands at the shape the
    main path's encode granule gives it (``batch`` stripes of 1 MiB
    chunks fused into one granule)."""
    chunk = STRIPE // K
    bit_rows, bit_cols = M * ec.w, K * ec.w
    if name == "gf2_packet":
        B = ec.bitmatrix
        stream = DeviceStream("packet", B, K, M, ec.w, ec.packetsize, dev)
        op_np, rows_in, rows_out = cuda_gf.prep_packet(B), bit_cols, bit_rows
    else:
        B = matrix_to_bitmatrix(ec.matrix, ec.w)
        stream = DeviceStream("matrix", B, K, M, ec.w, device=dev)
        prep = cuda_gf.prep_matrix_w8 if ec.w == 8 else cuda_gf.prep_matrix_w16
        op_np, rows_in, rows_out = prep(B, K), K, M
    cols = batch * stream.cols_of(chunk)
    # nibble tables (w=8 and w=16) or per-row lists (packet)
    op = torch.from_numpy(op_np).to(dev)
    x = torch.randint(0, 256, (rows_in, cols * cuda_gf.LANE_BYTES),
                      dtype=torch.uint8, device=dev, generator=gen
                      ).view(torch.int32)
    if name == "gf2_matrix_w8":
        kern = lambda: cuda_gf.matrix_encode_w8(op, x, K, M)  # noqa: E731
        plain = lambda: cuda_gf.matrix_encode_w8_plain(op, x, K, M)  # noqa: E731
    elif name == "gf2_matrix_w16":
        kern = lambda: cuda_gf.matrix_encode_w16(op, x, K, M)  # noqa: E731
        plain = lambda: cuda_gf.matrix_encode_w16_plain(op, x, K, M)  # noqa: E731
    else:
        kern = lambda: cuda_gf.packet_encode(op, x, rows_out)  # noqa: E731
        plain = lambda: cuda_gf.packet_encode_plain(op, x, rows_out)  # noqa: E731
    # least time: each input byte read once, each output byte written once,
    # over the memory rate.  No operations term: the data sheet gives no
    # rate for bitwise integer work, and counting the product as int8
    # multiply-adds would price a tensor-core formulation these kernels do
    # not use, not the least work the function needs
    row_bytes = x.shape[1] * cuda_gf.LANE_BYTES
    nbytes = (rows_in + rows_out) * row_bytes + op.numel() * 4
    return kern, plain, x, nbytes


def phase_kernels(reg, dev, gen, flush) -> dict:
    results = {}
    for label, extra, batch, name in PROFILES:
        ec = reg.factory("cuda", _profile(extra))
        kern, plain, x, nbytes = _kernel_case(name, ec, batch, dev, gen)
        a, b = kern(), plain()
        torch.cuda.synchronize()
        err = (a.view(torch.uint8).int() - b.view(torch.uint8).int()).abs()
        max_abs_err = int(err.max().item())
        assert torch.equal(a, b), f"{name}: kernel != plain version"
        assert (x.view(torch.uint8) >= 0x80).any().item()
        ms = ec_kernel_sweep.flushed_ms(kern, 20, flush)
        plain_ms = ec_kernel_sweep.flushed_ms(plain, 3, flush)
        results[name] = {
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
        }
        print(f"[kernel] {name} ({label}) lanes {tuple(x.shape)}: bit-exact, "
              f"kernel {ms:.4f} ms (mask-table design: "
              f"{MASK_TABLE_MS[name]:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound "
              f"{results[name]['bound_ms']:.4f} ms (bytes; {nbytes} bytes), "
              "library_ms null: no single PyTorch call computes a GF(2) "
              "bitmatrix product", flush=True)
        del a, b, x
    return results


def _lanes(gen, dev, rows, n4, aligned=True):
    """Seeded random lanes [rows, n4]; unaligned: a contiguous copy whose
    data starts 4 bytes past a 16-byte boundary."""
    x = torch.randint(0, 256, (rows, n4 * cuda_gf.LANE_BYTES),
                      dtype=torch.uint8, device=dev, generator=gen
                      ).view(torch.int32)
    if aligned:
        return x
    buf = torch.empty(x.numel() + 1, dtype=torch.int32, device=dev)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 == 4
    return y


def _decode_bits(w: int):
    """reed_sol_van k=8 m=4 at width w: the bitmatrix that rebuilds chunks
    1 and 6 from the first 8 survivors (as ``torch_gf.matrix_decode``)."""
    Mw = reed_sol.vandermonde_coding_matrix(K, M, w)
    sel = [c for c in range(K + M) if c not in ERASED][:K]
    A = np.zeros((K, K), dtype=np.uint32)
    for r, cid in enumerate(sel):
        if cid < K:
            A[r, cid] = 1
        else:
            A[r] = Mw[cid - K]
    return matrix_to_bitmatrix(gf(w).mat_invert(A)[list(ERASED)], w)


def _widest_tile(k: int, m: int, tables: bool) -> int:
    """The widest ``sweep_pipelined_w8`` tile whose two stages (and, with
    ``tables``, its nibble tables) fit in shared memory."""
    room = cuda_gf.SMEM_LIMIT - (128 * k * -(-m // 4) if tables else 0)
    return room // (2 * k * cuda_gf.LANE_BYTES) // 4 * 4


def _bits(r: int, c: int) -> np.ndarray:
    """A random 0/1 bitmatrix [r, c], seeded by its shape."""
    return np.random.RandomState(r * c).randint(0, 2, (r, c)).astype(np.uint8)


def _codec_edge_cases():
    """(label, kernel, bitmatrix, k or None, lanes n4, aligned): the shapes
    and matrices the three redesigned kernels must take."""
    cg = matrix_to_bitmatrix(cauchy.good_general_coding_matrix(K, M, 8), 8)
    sel = [c for c in range(K + M) if c not in ERASED][:K]
    zero_rows = _bits(13, 27)
    zero_rows[[0, 6, 12]] = 0
    rsv16 = matrix_to_bitmatrix(reed_sol.vandermonde_coding_matrix(K, M, 16),
                                16)
    zero16 = _bits(5 * 16, 3 * 16)
    zero16[[0, 17, 79]] = 0
    rsv8 = _sweep_bits()
    zero8 = _bits(3 * 8, 5 * 8)
    zero8[[0, 9, 23]] = 0
    cases = [(f"reed_sol_van k=8 m=4 n4={n4}", "gf2_matrix_w8", rsv8, K, n4,
              True) for n4 in (1, 1003, SWEEP_N4)]
    cases += [
        ("reed_sol_van k=8 m=4 unaligned", "gf2_matrix_w8", rsv8, K, 4096,
         False),
        ("k=1 m=1", "gf2_matrix_w8", _bits(8, 8), 1, 4099, True),
        ("odd m=3, k=5, zero rows", "gf2_matrix_w8", zero8, 5, 1003, True),
        ("odd m=5, k=3", "gf2_matrix_w8", _bits(40, 24), 3, 4096, False),
        ("k=400 m=4: two slices", "gf2_matrix_w8", _bits(32, 3200), 400,
         1003, True),
        ("k=5 m=12: two passes", "gf2_matrix_w8", _bits(96, 40), 5, 4099,
         True),
        ("reed_sol_van w=8 decode erased 1,6", "gf2_matrix_w8",
         _decode_bits(8), K, 131072, True),
    ]
    for n4 in (1, 1003, 131072):
        cases.append((f"cauchy_good k=8 m=4 n4={n4}", "gf2_packet", cg,
                      None, n4, True))
        cases.append((f"reed_sol_van k=8 m=4 n4={n4}", "gf2_matrix_w16",
                      rsv16, K, n4, True))
    cases += [
        ("cauchy_good k=8 m=4 unaligned", "gf2_packet", cg, None, 4096,
         False),
        ("odd r=13, three zero rows", "gf2_packet", zero_rows, None, 1003,
         True),
        ("k=1 (one input row)", "gf2_packet", _bits(5, 1), None, 4096, True),
        ("cauchy_good k=32 m=8 (c=256)", "gf2_packet",
         matrix_to_bitmatrix(cauchy.good_general_coding_matrix(32, 8, 8), 8),
         None, 4099, True),
        ("liberation k=17 w=31 (c=527)", "gf2_packet",
         liberation.liberation_coding_bitmatrix(17, 31), None, 4096, False),
        ("1800-row table", "gf2_packet", _bits(12, 1800), None, 4 * 4099,
         True),
        ("cauchy_good decode erased 1,6", "gf2_packet",
         survivor_decode_bitmatrix(cg, K, 8, sel, list(ERASED)), None,
         131072, True),
        ("reed_sol_van k=8 m=4 unaligned", "gf2_matrix_w16", rsv16, K, 4096,
         False),
        ("odd m=5, k=3, zero rows", "gf2_matrix_w16", zero16, 3, 1003, True),
        ("k=1 m=1", "gf2_matrix_w16", _bits(16, 16), 1, 4096, True),
        ("k=100 m=3: two slices", "gf2_matrix_w16", _bits(48, 1600), 100,
         1003, True),
        ("k=50 m=8: two slices of two groups", "gf2_matrix_w16",
         _bits(128, 800), 50, 4096, True),
        ("k=5 m=12: two passes", "gf2_matrix_w16", _bits(192, 80), 5, 4099,
         True),
        ("reed_sol_van w=16 decode erased 1,6", "gf2_matrix_w16",
         _decode_bits(16), K, 131072, True),
    ]
    return cases


def phase_codec_edges(dev, gen) -> None:
    """The codec kernels against their plain versions at the edge shapes
    and decode matrices of :func:`_codec_edge_cases`; ``gf2_matrix_w8``'s
    cases also through ``sweep_pipelined_w8`` (its default tile, or the
    widest that fits)."""
    for label, name, B, k, n4, aligned in _codec_edge_cases():
        if name == "gf2_packet":
            r, c = B.shape
            op = torch.from_numpy(cuda_gf.prep_packet(B)).to(dev)
            x = _lanes(gen, dev, c, n4, aligned)
            got = cuda_gf.packet_encode(op, x, r)
            want = cuda_gf.packet_encode_plain(op, x, r)
        elif name == "gf2_matrix_w8":
            m = B.shape[0] // 8
            op = torch.from_numpy(cuda_gf.prep_matrix_w8(B, k)).to(dev)
            x = _lanes(gen, dev, k, n4, aligned)
            got = cuda_gf.matrix_encode_w8(op, x, k, m)
            want = cuda_gf.matrix_encode_w8_plain(op, x, k, m)
            tile = min(sweep_gf.DEFAULT_TILE, _widest_tile(k, m, False))
            assert torch.equal(sweep_gf.pipelined_w8(op, x, k, m, tile),
                               want), \
                f"sweep_pipelined_w8 ({label}, tile {tile}): kernel != " \
                f"plain version at lanes {tuple(x.shape)}"
            label += f"; sweep_pipelined_w8 tile {tile} too"
        else:
            m = B.shape[0] // 16
            op = torch.from_numpy(cuda_gf.prep_matrix_w16(B, k)).to(dev)
            x = _lanes(gen, dev, k, n4, aligned)
            got = cuda_gf.matrix_encode_w16(op, x, k, m)
            want = cuda_gf.matrix_encode_w16_plain(op, x, k, m)
        assert torch.equal(got, want), \
            f"{name} ({label}): kernel != plain version at lanes " \
            f"{tuple(x.shape)}"
        print(f"[kernel] {name} {label} lanes {tuple(x.shape)}, "
              f"{tuple(got.shape)[0]} rows out: bit-exact", flush=True)


def _code_bits(code: str, k: int, m: int) -> np.ndarray:
    coding = {"reed_sol_van": reed_sol.vandermonde_coding_matrix,
              "cauchy_good": cauchy.good_general_coding_matrix}[code]
    return matrix_to_bitmatrix(coding(k, m, 8), 8)


def _sweep_bits():
    return _code_bits("reed_sol_van", K, M)


def _sweep_cases(dev):
    """name -> (kernel, plain version, library call or None, bytes of its
    coding table) over lanes x (over ``PREP[name](x)`` where PREP names the
    kernel), for reed_sol_van k=8 m=4 w=8 as the sweep and its probes run
    it (the precision kernels at tile 4096, ``sweep_split_f32`` as split2:
    parts 2, tile 8192)."""
    bits = _sweep_bits()
    xornet = sweep_gf.make_xornet(bits, K, M)
    w8 = torch.from_numpy(cuda_gf.prep_matrix_w8(bits, K)).to(dev)
    bp32 = torch.from_numpy(sweep_gf.prep_shift_major_w8(bits, K)).to(dev)
    bp, bp16 = bp32.to(torch.int8), bp32.to(torch.bfloat16)
    bblk = torch.from_numpy(sweep_gf.prep_blockdiag_w8(bits, K, M)).to(
        dev, torch.bfloat16)
    tile = sweep_gf.DEFAULT_TILE
    return {
        "sweep_copy": (lambda x: sweep_gf.copy_rows(x, M),
                       lambda x: sweep_gf.copy_plain(x, M),
                       lambda x: x[:M].clone(), 0),
        "sweep_extract": (lambda x: sweep_gf.extract_rows(x, M),
                          lambda x: sweep_gf.extract_plain(x, M), None, 0),
        "sweep_pipelined_w8": (
            lambda x: sweep_gf.pipelined_w8(w8, x, K, M, tile),
            lambda x: sweep_gf.pipelined_w8_plain(w8, x, K, M), None,
            w8.nbytes),
        "sweep_int8_4dot": (lambda x: sweep_gf.int8_4dot(bp, x, K, M),
                            lambda x: sweep_gf.int8_4dot_plain(bp, x, K, M),
                            None, bp.nbytes),
        "sweep_bf16_4dot": (lambda x: sweep_gf.bf16_4dot(bp16, x, K, M),
                            lambda x: sweep_gf.bf16_4dot_plain(bp16, x, K, M),
                            None, bp16.nbytes),
        "sweep_f32_4dot": (lambda x: sweep_gf.f32_4dot(bp32, x, K, M),
                           lambda x: sweep_gf.f32_4dot_plain(bp32, x, K, M),
                           None, bp32.nbytes),
        "sweep_bf16_blockdiag": (
            lambda x: sweep_gf.bf16_blockdiag(bblk, x, K, M),
            lambda x: sweep_gf.bf16_blockdiag_plain(bblk, x, K, M), None,
            bblk.nbytes),
        "sweep_xornet": (xornet,
                         lambda x: sweep_gf.xornet_plain(bits, x, K, M),
                         None, 0),
        **{name: (
            lambda x, p=prec: sweep_gf.prec_product(bp32, x, K, M, p,
                                                    sweep_gf.PREC_TILES[0]),
            lambda x, p=prec: sweep_gf.prec_plain(bp32, x, K, M, p), None,
            bp32.nbytes) for prec, name in sweep_gf.PREC_KERNELS.items()},
        "sweep_split_f32": (
            lambda x: sweep_gf.split_product(bp32, x, K, M, "HIGHEST", 2,
                                             8192),
            lambda x: sweep_gf.split_plain(bp32, x, K, M, 2), None,
            bp32.nbytes),
        "sweep_extract_fold": (lambda x: sweep_gf.extract_fold(x, K, M),
                               lambda x: sweep_gf.extract_fold_plain(x, K, M),
                               None, 0),
        "sweep_planes_f32": (
            lambda p: sweep_gf.planes_product(bp32, p, K, M,
                                              kernel_r4_probe.PLANES_TILE),
            lambda p: sweep_gf.planes_plain(bp32, p, K, M), None,
            bp32.nbytes),
    }


#: kernel -> its operand made from the lanes, outside the timed calls
PREP = {"sweep_planes_f32": lambda x: sweep_gf.field_planes(x, K)}


def _sweep_more_cases(dev):
    """name -> [(label, kernel, plain version)]: the same kernels at the
    other precision tile, ``sweep_split_f32`` at the probe's other parts,
    ``sweep_pipelined_w8`` at tile 4, at the widest tile whose stages and
    tables fit in shared memory and at the widest whose stages fit (its
    tables then read through L1), and the XOR network of a second
    bitmatrix (cauchy_good k=8 m=4 w=8: another generated library)."""
    bits = _code_bits("cauchy_good", K, M)
    xornet = sweep_gf.make_xornet(bits, K, M)
    w8 = torch.from_numpy(cuda_gf.prep_matrix_w8(_sweep_bits(), K)).to(dev)
    bp32 = torch.from_numpy(sweep_gf.prep_shift_major_w8(_sweep_bits(),
                                                         K)).to(dev)
    tile = sweep_gf.PREC_TILES[1]
    return {
        "sweep_pipelined_w8": [(
            f"tile {t}",
            lambda x, t=t: sweep_gf.pipelined_w8(w8, x, K, M, t),
            lambda x: sweep_gf.pipelined_w8_plain(w8, x, K, M))
            for t in (4, _widest_tile(K, M, True), _widest_tile(K, M, False))],
        "sweep_xornet": [(
            "cauchy_good k=8 m=4", xornet,
            lambda x: sweep_gf.xornet_plain(bits, x, K, M))],
        **{name: [(
            f"tile {tile}",
            lambda x, p=prec: sweep_gf.prec_product(bp32, x, K, M, p, tile),
            lambda x, p=prec: sweep_gf.prec_plain(bp32, x, K, M, p))]
           for prec, name in sweep_gf.PREC_KERNELS.items()},
        "sweep_split_f32": [(
            f"parts {parts} tile {tile}",
            lambda x, parts=parts: sweep_gf.split_product(
                bp32, x, K, M, "HIGHEST", parts, tile),
            lambda x, parts=parts: sweep_gf.split_plain(bp32, x, K, M, parts))
            for parts in (4, 8)],
    }


def _spread(values) -> str:
    return (f"median {statistics.median(values):.4f} ms (min "
            f"{min(values):.4f}, max {max(values):.4f})")


def _against_library(name, kern, library, dev, flush):
    """The kernel and its library call timed in turns, ``COPY_TURNS`` of
    each (the order reversed every other turn), flushed (mean of 20
    launches) and back to back (a CUDA graph of 48): the medians of the
    flushed times, printed with the spread of both."""
    times = {what: ([], []) for what in ("kernel", "library")}
    fns = {"kernel": kern, "library": library}
    for turn in range(COPY_TURNS):
        for what in (("kernel", "library") if turn % 2 == 0
                     else ("library", "kernel")):
            cold, warm = times[what]
            cold.append(ec_kernel_sweep.flushed_ms(fns[what], 20, flush))
            warm.append(ec_kernel_sweep.time_ms(fns[what], 48, dev))
    for what, (cold, warm) in times.items():
        print(f"[sweep-kernel] {name} {what} in {COPY_TURNS} turns: flushed "
              f"{_spread(cold)}; back to back {_spread(warm)}", flush=True)
    return (statistics.median(times["kernel"][0]),
            statistics.median(times["library"][0]))


def phase_sweep_kernels(dev, gen, flush) -> dict:
    """Each sweep kernel against its plain version on the card, bit-exact,
    at the sweep's lanes [8, 2097152] (timed) and at a ragged width."""
    results = {}
    cases, more = _sweep_cases(dev), _sweep_more_cases(dev)
    for n4 in (SWEEP_N4, RAGGED_N4):
        x = torch.randint(0, 256, (K, n4 * cuda_gf.LANE_BYTES),
                          dtype=torch.uint8, device=dev, generator=gen
                          ).view(torch.int32)
        for name, (kern, plain, library, table_bytes) in cases.items():
            arg = PREP[name](x) if name in PREP else x
            a, b = kern(arg), plain(arg)
            torch.cuda.synchronize()
            # the extraction probes' lanes are counts; the other outputs
            # are bytes
            if name in ("sweep_extract", "sweep_extract_fold"):
                err = (a.long() - b.long()).abs()
            else:
                err = (a.view(torch.uint8).int() - b.view(torch.uint8).int()
                       ).abs()
            max_abs_err = int(err.max().item())
            assert torch.equal(a, b), \
                f"{name}: kernel != plain version at lanes {tuple(x.shape)}"
            del a, b, err
            more_notes = []
            for label, more_kern, more_plain in more.get(name, ()):
                assert torch.equal(more_kern(x), more_plain(x)), \
                    f"{name} ({label}): kernel != plain version at lanes " \
                    f"{tuple(x.shape)}"
                note = f"{label} bit-exact"
                if n4 == SWEEP_N4:
                    ms = ec_kernel_sweep.flushed_ms(lambda: more_kern(x), 20,
                                                    flush)
                    note += f" {ms:.4f} ms"
                more_notes.append(note)
            if more_notes:
                print(f"[sweep-kernel] {name} lanes {tuple(x.shape)}: "
                      f"{'; '.join(more_notes)}", flush=True)
            if n4 != SWEEP_N4:
                print(f"[sweep-kernel] {name} lanes {tuple(x.shape)}: "
                      "bit-exact (ragged)", flush=True)
                del arg
                continue
            bound, by, nbytes, ops = ec_kernel_sweep.kernel_bound_ms(
                name, K, M, n4, table_bytes)
            if library is None:
                ms = ec_kernel_sweep.flushed_ms(lambda: kern(arg), 20, flush)
                library_ms = None
            else:
                ms, library_ms = _against_library(name, lambda: kern(arg),
                                                  lambda: library(arg), dev,
                                                  flush)
            plain_ms = ec_kernel_sweep.flushed_ms(lambda: plain(arg), 3,
                                                  flush)
            del arg
            results[name] = {
                "name": name, "route": "cuda",
                "source": CSRC_PATH + sweep_gf.KERNEL_SOURCES.get(
                    name, sweep_gf.SOURCE),
                "replaces": SWEEP_REPLACES[name], "max_abs_err": max_abs_err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": by, "library_ms": library_ms,
            }
            lib_note = (f"library x[:m].clone() {library_ms:.4f} ms (medians "
                        "of the turns above)"
                        if library_ms is not None else
                        f"library_ms null: {NO_LIBRARY[name]}")
            if name in EARLIER_MS:
                lib_note += (f"; earlier design {EARLIER_MS[name]:.4f} ms")
            ops_note = (f", {ops} {ec_kernel_sweep.OP_RATES[name][0]} ops"
                        if ops else "")
            print(f"[sweep-kernel] {name} lanes {tuple(x.shape)}: bit-exact, "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({by}; {nbytes} bytes{ops_note}), "
                  f"{lib_note}", flush=True)
        del x
    return results


def _xornet_edge_cases():
    """(label, bitmatrix, k, m, n4, aligned, all-ones words) of the shapes
    ``sweep_xornet`` must take, for reed_sol_van and cauchy_good: every n4
    % 8 from 1 to 7, less than one group of 8 lanes, a pointer 4 bytes off
    the 16-byte grid, k = 1, k = 16 m = 8, m = 1, 3 and 5; and all-ones
    words under both k=8 m=4 bitmatrices and under the all-ones bitmatrix
    at k=8 m=4 and k=16 m=8."""
    shapes = [*[(f"n4 % 8 = {r}", K, M, 2048 + r, True) for r in range(1, 8)],
              ("less than one group", K, M, 4, True),
              ("unaligned", K, M, 4096, False),
              ("k=1", 1, 4, 1003, True), ("k=16 m=8", 16, 8, 1003, True),
              ("m=1", K, 1, 1003, True), ("m=3, unaligned", K, 3, 1003, False),
              ("m=5", 7, 5, 1003, True)]
    cases = [(f"{code} {label}", _code_bits(code, k, m), k, m, n4, aligned,
              False)
             for code in ("reed_sol_van", "cauchy_good")
             for label, k, m, n4, aligned in shapes]
    cases += [(f"{code}, all-ones words", _code_bits(code, K, M), K, M, 4099,
               True, True) for code in ("reed_sol_van", "cauchy_good")]
    cases += [(f"all-ones bitmatrix k={k} m={m}, all-ones words",
               np.ones((8 * m, 8 * k), np.uint8), k, m, 4099, aligned, True)
              for k, m, aligned in ((K, M, True), (16, 8, False))]
    return cases


def _split_edge_cases():
    """(label, k, m, n4, aligned, bitmatrix or None): the shapes
    ``sweep_split_f32`` must take at every parts and tile (None: all-ones
    rows of Bp over lanes whose high halves are all ones, so the sums
    reach 8k * 65537, past 2^23 at k = 16)."""
    return [
        ("k=1 m=4", 1, 4, 1003, True, _bits(32, 8)),
        ("k=16 m=8", 16, 8, 100003, True, _bits(64, 128)),
        ("m=1", 8, 1, 1003, True, _bits(8, 64)),
        ("m=3", 8, 3, 100003, True, _bits(24, 64)),
        ("m=5, unaligned", 7, 5, 1003, False, _bits(40, 56)),
        ("reed_sol_van k=8 m=4 n4=1003", K, M, 1003, True, _sweep_bits()),
        ("reed_sol_van k=8 m=4 n4=100003, unaligned", K, M, 100003, False,
         _sweep_bits()),
        ("k=16 m=8, counts past 2^23", 16, 8, 4099, True, None),
        ("k=16 m=4, counts past 2^23", 16, 4, 4099, False, None),
        ("k=16 m=2, counts past 2^23", 16, 2, 4099, True, None),
    ]


#: the precision kernels' tiles at the edge shapes: the JAX tool's two, and
#: one that leaves a ragged last 64-lane sub-tile in each tile
PREC_EDGE_TILES = (*sweep_gf.PREC_TILES, 4128)


def _dot_rows(B, k: int, m: int, dev) -> dict:
    """name -> (wrapper, plain version, table on the card) of the wgmma
    product rows that take k and m, for the bitmatrix ``B`` [8m, 8k]."""
    bp = torch.from_numpy(sweep_gf.prep_shift_major_w8(B, k)).to(dev)
    rows = {name: (getattr(sweep_gf, name.removeprefix("sweep_")),
                   getattr(sweep_gf, name.removeprefix("sweep_") + "_plain"),
                   bp.to(dtype))
            for name, (dtype, max_k, max_m) in sweep_gf.DOT_KERNELS.items()
            if k <= max_k and m <= max_m}
    if m <= sweep_gf.BLOCKDIAG_MAX_M and sweep_gf.blockdiag_smem_bytes(
            k, m) <= cuda_gf.SMEM_LIMIT:
        rows["sweep_bf16_blockdiag"] = (
            sweep_gf.bf16_blockdiag, sweep_gf.bf16_blockdiag_plain,
            torch.from_numpy(sweep_gf.prep_blockdiag_w8(B, k, m)).to(
                dev, torch.bfloat16))
    return rows


def _check_dot_rows(label, x, B, k, m, dev) -> None:
    rows = _dot_rows(B, k, m, dev)
    for name, (wrapper, plain, table) in rows.items():
        assert torch.equal(wrapper(table, x, k, m), plain(table, x, k, m)), \
            f"{name} ({label}): kernel != plain version at lanes " \
            f"{tuple(x.shape)}"
    print(f"[sweep-edge] {', '.join(rows)} {label} lanes {tuple(x.shape)}: "
          "bit-exact", flush=True)


def phase_sweep_edges(dev, gen) -> None:
    """``sweep_copy``, ``sweep_xornet``, ``sweep_split_f32``, the three
    precision kernels and the four wgmma product rows against their plain
    versions at edge shapes: the copy at m = 1, a ragged total, an
    unaligned pointer and a partial last block; the XOR network at
    :func:`_xornet_edge_cases`, also against ``matrix_encode_w8``; the
    split at :func:`_split_edge_cases`, each at
    parts 2, 4 and 8 and tiles 32 * parts, 8192 and 16384; the precision
    kernels at the same cases, each at ``PREC_EDGE_TILES``; the product
    rows at the same cases where they take k and m (:func:`_dot_rows`), an
    all-ones table over all-ones words at k=8 m=4 and k=16 m=8, and the
    block-diagonal row at its widest k at m = 4 and m = 1."""
    for label, k, m, n4, aligned in (
            ("m=1", K, 1, 1003, True), ("ragged total", K, 3, 4097, True),
            ("unaligned", K, M, 4096, False),
            ("a partial last block", 1, 1, 262148, True)):
        x = _lanes(gen, dev, k, n4, aligned)
        got = sweep_gf.copy_rows(x, m)
        assert torch.equal(got, sweep_gf.copy_plain(x, m)), \
            f"sweep_copy ({label}): kernel != plain version at lanes " \
            f"{tuple(x.shape)}"
        print(f"[sweep-edge] sweep_copy {label} lanes {tuple(x.shape)}, "
              f"{m} rows: bit-exact", flush=True)
    for label, bits, k, m, n4, aligned, ones in _xornet_edge_cases():
        x = _lanes(gen, dev, k, n4, aligned)
        if ones:
            x[:, :n4 // 2] = -1
        got = sweep_gf.make_xornet(bits, k, m)(x)
        w8 = torch.from_numpy(cuda_gf.prep_matrix_w8(bits, k)).to(dev)
        assert torch.equal(got, sweep_gf.xornet_plain(bits, x, k, m)), \
            f"sweep_xornet ({label}): kernel != plain version at lanes " \
            f"{tuple(x.shape)}"
        assert torch.equal(got, cuda_gf.matrix_encode_w8(w8, x, k, m)), \
            f"sweep_xornet ({label}): kernel != matrix_encode_w8 at lanes " \
            f"{tuple(x.shape)}"
        print(f"[sweep-edge] sweep_xornet {label} lanes {tuple(x.shape)}: "
              "bit-exact (plain version and matrix_encode_w8)", flush=True)
    for label, k, m, n4, aligned, B in _split_edge_cases():
        x = _lanes(gen, dev, k, n4, aligned)
        if B is None:
            x[:, :2048] = (x[:, :2048] & 0xFFFF) | -65536
            B = _bits(8 * m, 8 * k)
            B[::3] = 1
        bp = torch.from_numpy(sweep_gf.prep_shift_major_w8(B, k)).to(dev)
        want = sweep_gf.split_plain(bp, x, k, m, 2)
        for parts in sweep_gf.SPLIT_PARTS[1:]:
            for tile in (32 * parts, 8192, 16384):
                got = sweep_gf.split_product(bp, x, k, m, "HIGHEST", parts,
                                             tile)
                assert torch.equal(got, want), \
                    f"sweep_split_f32 ({label}, parts {parts}, tile " \
                    f"{tile}): kernel != plain version at lanes " \
                    f"{tuple(x.shape)}"
        print(f"[sweep-edge] sweep_split_f32 {label} lanes {tuple(x.shape)}: "
              "bit-exact at parts 2, 4, 8 x tiles 32 * parts, 8192, 16384",
              flush=True)
        for prec, name in sweep_gf.PREC_KERNELS.items():
            want = sweep_gf.prec_plain(bp, x, k, m, prec)
            for tile in PREC_EDGE_TILES:
                got = sweep_gf.prec_product(bp, x, k, m, prec, tile)
                assert torch.equal(got, want), \
                    f"{name} ({label}, tile {tile}): kernel != plain " \
                    f"version at lanes {tuple(x.shape)}"
        print(f"[sweep-edge] {', '.join(sweep_gf.PREC_KERNELS.values())} "
              f"{label} lanes {tuple(x.shape)}: bit-exact at tiles "
              f"{', '.join(map(str, PREC_EDGE_TILES))}", flush=True)
        _check_dot_rows(label, x, B, k, m, dev)
    # the largest sums (every table entry 1 over words of all ones), and
    # the block-diagonal product at its widest k
    for label, k, m, n4, aligned in (
            ("all-ones table over all-ones words", K, M, 4099, True),
            ("k=16 m=8, all-ones table over all-ones words", 16, 8, 1003,
             False)):
        x = _lanes(gen, dev, k, n4, aligned)
        x[:, :n4 // 2] = -1
        _check_dot_rows(label, x, np.ones((8 * m, 8 * k), np.uint8), k, m,
                        dev)
    # at m = 1 the widest k passes 31, where its sums may reach 256 and
    # the epilogue takes each byte position's parity on its own
    for m in (M, 1):
        widest = max(k for k in range(1, 128)
                     if sweep_gf.blockdiag_smem_bytes(k, m)
                     <= cuda_gf.SMEM_LIMIT)
        x = _lanes(gen, dev, widest, RAGGED_N4, False)
        x[:, :4096] = -1
        _check_dot_rows(f"k={widest} m={m} (the block-diagonal's widest k), "
                        "unaligned", x, _bits(8 * m, 8 * widest), widest, m,
                        dev)


def _tool(tool, argv, rc: int = 0) -> str:
    """``tool.main(argv)`` in this process with its stdout captured; it
    must exit ``rc``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = tool.main(argv)
    name = tool.__name__.rsplit(".", 1)[-1]
    assert got == rc, \
        f"{name} {' '.join(argv)} exited {got}: {buf.getvalue()[-2000:]}"
    return buf.getvalue()


def _tool_lines(tool, argv) -> list:
    """Run ``tool.main(argv)`` in-process; its output lines, printed with a
    tag.  Fails unless it exits 0."""
    out = _tool(tool, argv).strip().splitlines()
    tag = tool.__name__.rsplit(".", 1)[-1]
    for line in out:
        print(f"[{tag}] {line}", flush=True)
    return out


def phase_sweep(card: str) -> dict:
    """The port's kernel sweep at 8 MiB chunks, all three stages; the
    sweep kernels' launches, counted from zero over this run."""
    argv = ["--size-mib", "8", "--iters", "48"]
    sweep_gf.reset_launches()
    out = _tool_lines(ec_kernel_sweep, argv)
    launched = dict(sweep_gf.launches)
    for row in (*ec_kernel_sweep.VARIANTS, *ec_kernel_sweep.PROBES):
        assert any(line.split()[:2] == [row, "bit-exact"] for line in out), \
            f"ec_kernel_sweep: no bit-exact {row} row"
    for prec, tile in ec_kernel_sweep.PRECISION_ROWS:
        # one reduced-precision pass cannot hold 65537: DEFAULT mismatches
        want = [f"prec={prec}", f"tile={tile}",
                "MISMATCH" if prec == "DEFAULT" else "bit-exact"]
        assert any(line.split()[:3] == want for line in out), \
            f"ec_kernel_sweep: no {' '.join(want)} row"
    print(f"[sweep] {' '.join(argv)} exited 0; launches {launched}; card "
          f"{card}", flush=True)
    return launched


def phase_probes(card: str) -> dict:
    """The port's split-chain and split-cost probes at 8 MiB chunks; the
    launches of the kernels they add, counted from zero over these runs."""
    argv = ["--size-mib", "8", "--iters", "48"]
    sweep_gf.reset_launches()
    out = _tool_lines(kernel_r4_split, argv)
    for parts, tile, prec in kernel_r4_split.ROWS:
        # one reduced-precision pass cannot hold 65537: DEFAULT mismatches
        want = [f"split{parts}", f"tile={tile}", prec,
                "MISMATCH" if prec == "DEFAULT" else "bit-exact"]
        assert any(line.split()[:4] == want for line in out), \
            f"kernel_r4_split: no {' '.join(want)} row"
    out = _tool_lines(kernel_r4_probe, argv)
    for row in kernel_r4_probe.ROWS:
        assert any(line.startswith(f"{row:30s} bit-exact") for line in out), \
            f"kernel_r4_probe: no bit-exact {row} row"
    launched = {name: sweep_gf.launches[name] for name in PROBE_KERNELS}
    print(f"[probes] {' '.join(argv)} exited 0 twice; launches {launched}; "
          f"card {card}", flush=True)
    return launched


def _stripes(rs, n: int):
    return [np.frombuffer(rs.bytes(STRIPE), dtype=np.uint8) for _ in range(n)]


def _same(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), f"{what}: chunk ids {sorted(got)}"
    for c in want:
        assert np.array_equal(np.asarray(got[c]), want[c]), \
            f"{what}: chunk {c} differs from the numpy jerasure plugin"


def phase_main_path(reg, rs, card: str) -> dict:
    cuda_gf.reset_launches()
    per_profile = {}
    for label, extra, batch, name in PROFILES:
        before = cuda_gf.launches[name]
        ec = reg.factory("cuda", _profile(extra))
        ref = reg.factory("jerasure", _profile(extra))
        want = set(range(K + M))
        stripes = _stripes(rs, batch)
        expect = [ref.encode(want, s) for s in stripes]

        # warm with the whole batch: matrix upload and the pinned staging
        # and device buffers of this granule shape, which the caching
        # allocators then reuse
        ec.encode_batch(stripes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = ec.encode_batch(stripes)
        enc_s = time.perf_counter() - t0
        for i, (got, exp) in enumerate(zip(enc, expect)):
            _same(got, exp, f"{label} encode_batch stripe {i}")

        maps = [{c: a for c, a in e.items() if c not in ERASED}
                for e in expect]
        ec.decode_batch(maps)  # warm: reconstruction matrix, buffers
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec = ec.decode_batch(maps)
        dec_s = time.perf_counter() - t0
        for i, (got, exp) in enumerate(zip(dec, expect)):
            _same(got, exp, f"{label} decode_batch stripe {i}")

        _same(ec.encode(want, stripes[0]), expect[0], f"{label} encode")
        _same(ec.decode(want, maps[0]), expect[0], f"{label} decode")

        rose = cuda_gf.launches[name] - before
        assert rose > 0, f"{label}: {name} was never launched"
        gib = batch * STRIPE / 2**30
        per_profile[label] = {"kernel": name, "launches": rose,
                              "encode_GiBs": gib / enc_s,
                              "decode_GiBs": gib / dec_s}
        print(f"[main] {label}: {batch} x {STRIPE} B stripes bit-exact vs "
              f"numpy jerasure; encode_batch {gib / enc_s:.3f} GiB/s, "
              f"decode_batch {gib / dec_s:.3f} GiB/s (erased {list(ERASED)}),"
              f" {name} launches {rose}; card {card}", flush=True)
    return per_profile


def _storage_check(ec, ref, n_objects: int, seed: int) -> str:
    """One coalesced write and degraded read pass: every stored shard
    against the numpy ``jerasure`` plugin's encode of the same payload (in
    ecutil's stripe layout), the read against the payload, and the C
    crc32c against its plain version over a parity shard's first 64 KiB.
    Returns the crc line."""
    h = storage_bench.StoragePathHarness(ec, erasures=STORAGE_ERASURES)
    payloads = storage_bench.make_payloads(n_objects, OBJECT, seed)
    loop = asyncio.new_event_loop()
    try:
        store = loop.run_until_complete(
            h.write_pass(payloads, coalesce=True, writers=WRITERS))
        got = loop.run_until_complete(
            h.read_pass(store, n_objects, [len(p) for p in payloads],
                        coalesce=True, readers=WRITERS))
    finally:
        loop.close()
    for i, p in enumerate(payloads):
        buf = np.zeros(h.sinfo.logical_to_next_stripe_offset(len(p)),
                       np.uint8)
        buf[:len(p)] = np.frombuffer(p, np.uint8)
        want = ecutil.encode(h.sinfo, ref, buf, range(h.km))
        for s in range(h.km):
            assert store[f"obj{i}@{s}"] == want[s].tobytes(), \
                f"storage path: obj{i} shard {s} differs from the numpy " \
                f"jerasure plugin"
        assert got[i] == p, f"storage path: degraded read of obj{i}"
    shard = np.frombuffer(store[f"obj0@{h.k}"], np.uint8)[:CRC_PREFIX]
    crc, plain = gf_native.crc32c(shard), gf_native.crc32c_plain(shard)
    assert crc == plain, f"crc32c: C build {crc:#x} != plain {plain:#x}"
    return (f"crc32c ({'sse4.2' if gf_native.sse42() else 'table'} build) "
            f"== plain over {CRC_PREFIX} B of obj0@{h.k}: {crc:#010x}")


def phase_storage_path(reg, seed: int, card: str) -> dict:
    """The OSD storage path on the card (docstring, phase 3b); launches
    are zeroed at its start and read at its end."""
    cuda_gf.reset_launches()
    results = {}
    for label, extra, n_objects, name in STORAGE_PROFILES:
        ec = reg.factory("cuda", _profile(extra))
        ref = reg.factory("jerasure", _profile(extra))
        t0 = time.perf_counter()
        r = storage_bench.run_storage_path_bench(
            ec, n_objects=n_objects, obj_bytes=OBJECT, writers=WRITERS,
            iters=STORAGE_ITERS, seed=seed, erasures=STORAGE_ERASURES)
        bench_s = time.perf_counter() - t0
        assert r["bit_exact"], f"storage path {label}: not bit-exact"
        assert r["steady_library_builds"] == {"per_op": 0, "coalesced": 0}
        crc_line = _storage_check(ec, ref, n_objects, seed)
        head = (f"[storage] {label}: {n_objects} x {OBJECT} B objects, "
                f"{WRITERS} writers, {r['erasures']} erasures")
        modes = {}
        for mode in ("per_op", "coalesced"):
            m = r[mode]
            res = m["residency"]
            modes[mode] = {
                "write_GiBs": m["write_GiBs"], "read_GiBs": m["read_GiBs"],
                "stages_s": m["stages_s"],
                "h2d_per_granule": {lane: res[lane]["h2d_per_granule"]
                                    for lane in ("write", "read")},
                "granules": {lane: res[lane]["granules"]
                             for lane in ("write", "read")}}
            print(f"{head}, {mode}: write {m['write_GiBs']:.4f} GiB/s, "
                  f"read {m['read_GiBs']:.4f} GiB/s (best of "
                  f"{STORAGE_ITERS}); card {card}", flush=True)
            print(f"{head}, {mode}: stage seconds summed over ops "
                  f"{json.dumps(m['stages_s'])}; card {card}", flush=True)
            print(f"{head}, {mode}: h2d_per_granule "
                  f"{json.dumps(modes[mode]['h2d_per_granule'])}, granules "
                  f"{json.dumps(modes[mode]['granules'])}; card {card}",
                  flush=True)
        print(f"{head}: steady_library_builds "
              f"{json.dumps(r['steady_library_builds'])}; every shard "
              f"bit-exact vs numpy jerasure, degraded read == payload; "
              f"{crc_line}; {bench_s:.1f} s; card {card}", flush=True)
        results[label] = {"kernel": name, "objects": n_objects,
                          "obj_bytes": OBJECT, "writers": WRITERS,
                          "steady_library_builds":
                              r["steady_library_builds"], **modes}
    launched = dict(cuda_gf.launches)
    for label, _extra, _n, name in STORAGE_PROFILES:
        assert launched[name] > 0, \
            f"storage path {label}: {name} was never launched"
        results[label]["launches"] = launched[name]
    print(f"[storage] codec kernel launches on the storage path {launched}; "
          f"card {card}", flush=True)
    return results


def _crc32c_plain_rows(rows: np.ndarray) -> np.ndarray:
    """The plain byte-table crc32c (``gf_native.crc32c_plain``'s loop) of
    every row of ``rows`` at once: one numpy step per byte position."""
    table = np.array(gf_native._TABLE, dtype=np.uint32)
    crc = np.full(rows.shape[0], 0xFFFFFFFF, dtype=np.uint32)
    for col in np.ascontiguousarray(rows.T):
        crc = table[(crc ^ col) & 0xFF] ^ (crc >> 8)
    return crc


def _cluster_check(cluster, ref, final: dict, crc: bool = True) -> str:
    """After recovery: every stored shard of every object against the
    numpy ``jerasure`` encode of its final payload (ecutil's stripe
    layout), and (``crc``) every shard's HashInfo crc against the plain
    crc32c."""
    backend = cluster.osds[0].pools[cluster.pool]
    sinfo, km = backend.sinfo, backend.km
    n_shards, shards, hashes = 0, [], []
    for oid, payload in final.items():
        buf = np.zeros(sinfo.logical_to_next_stripe_offset(len(payload)),
                       np.uint8)
        buf[:len(payload)] = np.frombuffer(payload, np.uint8)
        want = ecutil.encode(sinfo, ref, buf, range(km))
        acting = cluster.backend.acting_set(oid)
        for s in range(km):
            store = cluster.osds[acting[s]].store
            soid = f"{oid}@{s}"
            got = store.read(soid)
            assert got == want[s].tobytes(), \
                f"cluster path: {soid} on osd.{acting[s]} differs from " \
                f"the numpy jerasure plugin"
            n_shards += 1
            if crc:
                hinfo = ecutil.HashInfo.from_dict(
                    store.getattr(soid, ecutil.HINFO_KEY))
                shards.append(np.frombuffer(got, np.uint8))
                hashes.append(hinfo.get_chunk_hash(s))
    if not crc:
        return f"{n_shards} shards bit-exact vs numpy jerasure"
    plain = _crc32c_plain_rows(np.stack(shards))
    bad = [i for i, (h, p) in enumerate(zip(hashes, plain)) if h != int(p)]
    assert not bad, f"cluster path: {len(bad)} HashInfo crcs differ from " \
        f"the plain crc32c"
    return (f"{n_shards} shards bit-exact vs numpy jerasure, their "
            f"HashInfo crcs == plain crc32c")


def _coalescer_counts() -> dict:
    """Encode and decode dispatches of every primary's coalescers (the
    ``ec_*_coalesce`` perf counters) and the pipeline's granules."""
    dump = json.loads(PerfCounters.dump())
    out = {key: sum(v.get(key, 0) for v in dump.values()
                    if isinstance(v, dict))
           for key in ("ec_encode_coalesce", "ec_decode_coalesce")}
    out["granules"] = granules_dispatched()
    return out


def phase_cluster_path(seed: int, card: str) -> dict:
    """The EC cluster's storage cycle on the card (docstring, phase 3c);
    launches are zeroed before and read after each step."""
    reg = registry_mod.instance()
    results = {}
    for label, extra, n_objects, name in CLUSTER_PROFILES:
        ref = reg.factory("jerasure", _profile(extra))
        payloads = cluster_bench.make_payloads(n_objects, OBJECT, seed)
        overwrites = cluster_bench.make_overwrites(
            payloads, CLUSTER_OVERWRITE, seed + 1)
        launches, counts = {}, {}

        def hook(_cluster, step, when):
            if when == "start":
                cuda_gf.reset_launches()
                counts[step] = _coalescer_counts()
            else:
                torch.cuda.synchronize()
                launches[step] = cuda_gf.launches[name]
                before = counts[step]
                counts[step] = {key: v - before[key]
                                for key, v in _coalescer_counts().items()}

        PerfCounters.reset_all()
        t0 = time.perf_counter()
        r = cluster_bench.run_storage_cycle(
            lambda: ECCluster(CLUSTER_OSDS, _profile(extra), plugin="cuda"),
            payloads, overwrites, writers=WRITERS,
            deadline_s=CLUSTER_DEADLINE_S, hook=hook)
        cycle_s = time.perf_counter() - t0
        for step in CLUSTER_KERNEL_STEPS:
            assert launches[step] > 0, \
                f"cluster path {label}: {name} not launched in {step}"
        t0 = time.perf_counter()
        check = _cluster_check(r["cluster"], ref, r["final"])
        check_s = time.perf_counter() - t0
        head = (f"[cluster] {label}: {CLUSTER_OSDS} OSDs, {n_objects} x "
                f"{OBJECT} B objects, {WRITERS} client tasks, "
                f"{len(overwrites)} overwritten while osd.{r['victim']} "
                f"was down")
        op = r["op_ms"]
        print(f"{head}: write {r['write_GiBs']:.4f} GiB/s, degraded write "
              f"{r['degraded_write_GiBs']:.4f} GiB/s, degraded read "
              f"{r['degraded_read_GiBs']:.4f} GiB/s, read "
              f"{r['read_GiBs']:.4f} GiB/s; card {card}", flush=True)
        print(f"{head}: time to clean {r['time_to_clean_s']:.3f} s, rebuilt "
              f"{r['rebuilt_bytes']} B at {r['rebuild_MiBs']:.2f} MiB/s; "
              f"card {card}", flush=True)
        print(f"{head}: client op ms p50/p99 " + ", ".join(
            f"{step} {op[step]['p50']:.1f}/{op[step]['p99']:.1f}"
            for step in op) + f"; card {card}", flush=True)
        print(f"{head}: {name} launches per step {json.dumps(launches)}; "
              f"coalescer dispatches and pipeline granules per step "
              f"{json.dumps(counts)}; card {card}", flush=True)
        print(f"{head}: {check} ({check_s:.1f} s); cycle "
              f"{cycle_s:.1f} s, steps {json.dumps(r['steps_s'])}; "
              f"card {card}", flush=True)
        results[label] = {
            "kernel": name, "objects": n_objects, "obj_bytes": OBJECT,
            "osds": CLUSTER_OSDS, "overwritten": len(overwrites),
            "launches": launches, "coalescer": counts,
            **{key: r[key] for key in (
                "steps_s", "write_GiBs", "degraded_write_GiBs",
                "degraded_read_GiBs", "read_GiBs", "time_to_clean_s",
                "rebuilt_bytes", "rebuild_MiBs", "op_ms")}}
    return results


def _device_bytes() -> dict:
    """The caching allocator's live bytes: ``allocated`` (block sizes,
    ``memory_allocated``) and ``requested`` (the sizes asked for).  A
    freed block that another stream used (``record_stream``) leaves
    ``requested`` only once its event is processed; ``empty_cache``
    processes them all first."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    stats = torch.cuda.memory_stats()
    return {"allocated": stats["allocated_bytes.all.current"],
            "requested": stats["requested_bytes.all.current"]}


def _ledger() -> dict:
    acct = device_byte_account()
    return {"tier": acct.used("tier"), "h2d": acct.used("h2d")}


def _held_bytes(cluster) -> dict:
    """What the cluster's tiers and its codec's upload caches hold: their
    tensors' bytes, the bytes of the distinct storages under them, and
    how many lie off the card."""
    codec = cluster.ec._dc()
    streams = [codec.encode_stream()] + [
        stream for _sel, stream in codec._decode_streams.values()]
    held = {"tier": [e.block for o in cluster.osds
                     for e in o.tier._entries.values()],
            "h2d": [e[0] for stream in streams
                    for e in stream._h2d_cache.values()]}
    out = {}
    for owner, tensors in held.items():
        storages = {t.untyped_storage().data_ptr():
                    t.untyped_storage().nbytes() for t in tensors}
        out[owner] = {"tensors": len(tensors),
                      "bytes": sum(t.nbytes for t in tensors),
                      "storage_bytes": sum(storages.values()),
                      "off_card": sum(not t.is_cuda for t in tensors)}
    return out


def _tier_h2d_cache(reg, rs, card) -> dict:
    """The same 8 x 8 MiB batch twice through the one-shot ``encode`` (the
    sync contract, whose uploads go through the cache): the second pass's
    data uploads are cache hits; with the escape hatch set, a third pass
    uploads again.  Then the batch twice through ``encode_batch``, whose
    persistent write lane neither hashes nor keeps its fresh granules: it
    uploads every time and the cache's entries stay as they were."""
    ec = reg.factory("cuda", _profile({"technique": "reed_sol_van"}))
    ref = reg.factory("jerasure", _profile({"technique": "reed_sol_van"}))
    want = set(range(K + M))
    stripes = _stripes(rs, 8)
    first = [ec.encode(want, s) for s in stripes]
    _same(first[0], ref.encode(want, stripes[0]),
          "h2d cache: encode stripe 0")
    stream = ec._dc().encode_stream()
    one_shot = lambda: [ec.encode(want, s) for s in stripes]  # noqa: E731
    calls = []
    for label, env, fn in (("repeat", None, one_shot),
                           ("escape_hatch", "1", one_shot),
                           ("encode_batch", None,
                            lambda: ec.encode_batch(stripes)),
                           ("encode_batch_again", None,
                            lambda: ec.encode_batch(stripes))):
        if env is not None:
            os.environ["CEPH_TPU_TORCH_NO_H2D_CACHE"] = env
        try:
            before, hits = residency.counters().snapshot(), \
                stream.h2d_cache_hits
            entries = len(stream._h2d_cache)
            t0 = time.perf_counter()
            again = fn()
            wall = time.perf_counter() - t0
            delta = residency.ResidencyCounters.delta(
                before, residency.counters().snapshot())
        finally:
            os.environ.pop("CEPH_TPU_TORCH_NO_H2D_CACHE", None)
        for i, (a, b) in enumerate(zip(again, first)):
            _same(a, b, f"h2d cache {label}: stripe {i}")
        calls.append({"call": label, "h2d_ops": delta["h2d_ops"],
                      "h2d_bytes": delta["h2d_bytes"],
                      "cache_hits": stream.h2d_cache_hits - hits,
                      "entries_added": len(stream._h2d_cache) - entries,
                      "wall_ms": wall * 1e3})
    repeat, hatch, batch, batch2 = calls
    assert repeat["h2d_ops"] == 0 and \
        repeat["cache_hits"] >= len(stripes), \
        f"h2d cache: the repeated batch was uploaded again: {repeat}"
    assert hatch["h2d_ops"] >= len(stripes) and hatch["cache_hits"] == 0, \
        f"h2d cache: the escape hatch did not upload: {hatch}"
    for call in (batch, batch2):
        assert call["h2d_ops"] >= 1 and call["cache_hits"] == 0 and \
            call["entries_added"] == 0, \
            f"h2d cache: encode_batch's fresh granules were cached: {call}"
    ledger = _ledger()
    stream.release_h2d()
    print(f"[tier] h2d cache: 8 x {STRIPE} B stripes through the one-shot "
          f"encode twice, then with CEPH_TPU_TORCH_NO_H2D_CACHE=1, then "
          f"through encode_batch twice: {json.dumps(calls)}; ledger with "
          f"the batch cached {json.dumps(ledger)}; card {card}", flush=True)
    return {"calls": calls, "ledger": ledger}


def _tier_hash_cost(reg, seed, card) -> dict:
    """Phase 3b's write pass (32 x 4 MiB, w=8, 8 writers) per-op and
    coalesced, with the upload cache on and with the escape hatch set, in
    turns; and blake2b-128's own rate over one 32 MiB granule."""
    ec = reg.factory("cuda", _profile({"technique": "reed_sol_van"}))
    h = storage_bench.StoragePathHarness(ec, erasures=STORAGE_ERASURES)
    payloads = storage_bench.make_payloads(STORAGE_PROFILES[0][2], OBJECT,
                                           seed)
    nbytes = sum(len(p) for p in payloads)
    loop = asyncio.new_event_loop()
    out = {}
    try:
        for coalesce in (False, True):
            mode = "coalesced" if coalesce else "per_op"
            loop.run_until_complete(h.write_pass(
                payloads, coalesce=coalesce, writers=WRITERS))  # warm
            rates = {"cache": [], "no_cache": []}
            for turn in range(HASH_TURNS):
                order = ("cache", "no_cache") if turn % 2 == 0 else \
                    ("no_cache", "cache")
                for label in order:
                    if label == "no_cache":
                        os.environ["CEPH_TPU_TORCH_NO_H2D_CACHE"] = "1"
                    try:
                        t0 = time.perf_counter()
                        loop.run_until_complete(h.write_pass(
                            payloads, coalesce=coalesce, writers=WRITERS))
                        rates[label].append(
                            nbytes / 2**30 / (time.perf_counter() - t0))
                    finally:
                        os.environ.pop("CEPH_TPU_TORCH_NO_H2D_CACHE", None)
            out[mode] = rates
    finally:
        loop.close()
    granule = np.random.RandomState(seed).bytes(32 << 20)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        hashlib.blake2b(granule, digest_size=16).digest()
        times.append(time.perf_counter() - t0)
    out["blake2b_GiBs"] = (32 << 20) / 2**30 / min(times)
    out["blake2b_s_per_pass"] = nbytes / 2**30 / out["blake2b_GiBs"]
    print(f"[tier] the upload cache's hash: write GiB/s of {len(payloads)} "
          f"x {OBJECT} B objects with the cache on / off in turns "
          f"{json.dumps({m: out[m] for m in ('per_op', 'coalesced')})}; "
          f"blake2b-128 {out['blake2b_GiBs']:.3f} GiB/s on one core, "
          f"{out['blake2b_s_per_pass']:.3f} s of hashing a pass; "
          f"card {card}", flush=True)
    return out


def _tier_cluster(mode: str, n_objects: int, seed: int, card: str) -> dict:
    """One ``run_tier_cycle`` on a 16-OSD cluster (docstring, phase 3d)."""
    gc.collect()  # the last cycle's codec releases its upload cache
    profile = _profile({"technique": "reed_sol_van"})
    ref = registry_mod.instance().factory("jerasure", dict(profile))
    payloads = cluster_bench.make_payloads(n_objects, OBJECT, seed)
    rewrites = cluster_bench.make_payloads(n_objects, OBJECT, seed + 1)
    budget = DeviceByteAccount.budget()
    launches, ledgers, at_start = {}, {}, {}

    def hook(cluster, step, when):
        # the counts run on through the cycle: each step's launches are
        # the change over it
        torch.cuda.synchronize()
        if when == "start":
            at_start[step] = dict(cuda_gf.launches)
            return
        launches[step] = {name: n - at_start[step][name]
                          for name, n in cuda_gf.launches.items()}
        resident = sum(o.tier.resident_bytes for o in cluster.osds)
        assert resident <= budget, \
            f"tier {mode}: {resident} B resident after {step}, budget " \
            f"{budget}"
        ledgers[step] = _ledger()

    async def main():
        cluster = ECCluster(CLUSTER_OSDS, dict(profile), plugin="cuda")
        mem0, led0 = _device_bytes(), _ledger()
        try:
            cuda_gf.reset_launches()
            r = await cluster_bench.run_tier_cycle(
                cluster, mode, payloads, rewrites, writers=WRITERS,
                deadline_s=CLUSTER_DEADLINE_S, hook=hook)
            torch.cuda.synchronize()
            cycle_launches = dict(cuda_gf.launches)
            mem1, led1 = _device_bytes(), _ledger()
            held = _held_bytes(cluster)
        finally:
            await cluster.shutdown()
        return cluster, r, mem0, mem1, led0, led1, held, cycle_launches

    loop = asyncio.new_event_loop()
    try:
        cluster, r, mem0, mem1, led0, led1, held, cycle_launches = \
            loop.run_until_complete(main())
    finally:
        loop.close()
    t0 = time.perf_counter()
    check = _cluster_check(cluster, ref, r["final"])
    check_s = time.perf_counter() - t0
    led = sum(led1.values()) - sum(led0.values())
    req = mem1["requested"] - mem0["requested"]
    alloc = mem1["allocated"] - mem0["allocated"]
    memory = {"ledger_delta": led, "requested_delta": req,
              "allocated_delta": alloc, "allocated_before": mem0["allocated"],
              "allocated_after": mem1["allocated"],
              "ledger_before": led0, "ledger_after": led1, "held": held}
    print(f"[tier] {mode}: device memory over the cycle "
          f"{json.dumps(memory)}; card {card}", flush=True)
    # the allocator's rounding: the block sizes it handed out beyond the
    # sizes asked for, over the cycle
    rounding = abs(alloc - req)
    assert abs(alloc - led) <= rounding + CODEC_TABLE_SLACK and \
        abs(req - led) <= CODEC_TABLE_SLACK, \
        f"tier {mode}: the ledger moved {led} B, memory_allocated " \
        f"{alloc} B, requested {req} B"
    assert all(h["off_card"] == 0 for h in held.values()), held
    # the agent's failures are swallowed into a counter: none may occur,
    # and its tick must have promoted in either mode
    assert all(d["tier_agent_failed"] == 0 for d in r["tier"].values()), \
        f"tier {mode}: the agent failed {r['tier']}"
    assert r["tier"]["tick"]["tier_promote_ops"] > 0, \
        f"tier {mode}: the agent's tick promoted nothing {r['tier']['tick']}"
    if mode == "readproxy":
        assert not r["rewritten_still_resident"], \
            f"tier readproxy: rewrites left resident copies " \
            f"{r['rewritten_still_resident']}"
        assert r["tier"]["read_hot"]["hits"] == 0
    else:
        assert r["tier"]["rewrite"]["tier_promote_from_encode"] > 0
        assert r["tier"]["read_hot"]["hits"] > 0
        assert r["tier"]["degraded_read"]["hits"] > 0
    for step in ("write", "rewrite"):
        assert launches[step]["gf2_matrix_w8"] > 0, \
            f"tier {mode}: gf2_matrix_w8 not launched in {step}"
    head = (f"[tier] {mode}: {CLUSTER_OSDS} OSDs, {n_objects} x {OBJECT} B "
            f"objects, {WRITERS} client tasks, osd.{r['victim']} killed for "
            f"the degraded read")
    rates = {key: r[key] for key in (
        "write_GiBs", "rewrite_GiBs", "read_GiBs", "read_hot_GiBs",
        "degraded_read_GiBs", "read_after_GiBs")}
    print(f"{head}: GiB/s {json.dumps(rates)}; card {card}", flush=True)
    print(f"{head}: tier per step {json.dumps(r['tier'])}; resident bytes "
          f"per step {json.dumps(r['resident_bytes'])} (budget {budget}); "
          f"card {card}", flush=True)
    print(f"{head}: ledger per step {json.dumps(ledgers)}; codec kernel "
          f"launches per step {json.dumps(launches)}, over the cycle "
          f"{json.dumps(cycle_launches)}; card {card}", flush=True)
    print(f"{head}: {check} ({check_s:.1f} s); steps "
          f"{json.dumps(r['steps_s'])}; card {card}", flush=True)
    return {"objects": n_objects, "obj_bytes": OBJECT, **rates,
            "steps_s": r["steps_s"], "tier": r["tier"],
            "resident_bytes": r["resident_bytes"], "budget": budget,
            "ledger": ledgers, "memory": memory, "launches": launches,
            "cycle_launches": cycle_launches}


def phase_tier_path(reg, seed: int, card: str) -> dict:
    """The device cache tier on the card (docstring, phase 3d).  The
    tier path's launches are those of its two cluster cycles, each zeroed
    just before the cycle and read just after; ``tier_bench``'s are
    counted apart."""
    gc.collect()  # earlier phases' codecs release their upload caches
    assert _ledger() == {"tier": 0, "h2d": 0}, \
        f"tier path: the ledger holds {_ledger()} before the phase"
    t0 = time.perf_counter()
    out = {"h2d_cache": _tier_h2d_cache(reg, np.random.RandomState(seed),
                                        card),
           "hash_cost": _tier_hash_cost(reg, seed, card),
           "writeback": _tier_cluster("writeback", TIER_OBJECTS, seed, card),
           "readproxy": _tier_cluster("readproxy", TIER_READPROXY_OBJECTS,
                                      seed + 2, card)}
    out["launches"] = {
        name: sum(out[mode]["cycle_launches"][name]
                  for mode in ("writeback", "readproxy"))
        for name in out["writeback"]["cycle_launches"]}
    assert out["launches"]["gf2_matrix_w8"] > 0
    ec = reg.factory("cuda", _profile({"technique": "reed_sol_van"}))
    t1 = time.perf_counter()
    cuda_gf.reset_launches()
    bench = run_tier_path_bench(ec, n_objects=TIER_BENCH_OBJECTS,
                                obj_bytes=OBJECT, iters=2,
                                erasures=STORAGE_ERASURES, seed=seed)
    torch.cuda.synchronize()
    out["tier_bench_launches"] = dict(cuda_gf.launches)
    assert bench["bit_exact"] and \
        bench["resident_bytes"] == TIER_BENCH_OBJECTS * (K + M) * OBJECT // K
    print(f"[tier] run_tier_path_bench {TIER_BENCH_OBJECTS} x {OBJECT} B, "
          f"{bench['erasures']} erasures, private ledger: hot read "
          f"{bench['hot_read_GiBs']:.4f} GiB/s, cold (decode) read "
          f"{bench['cold_read_GiBs']:.4f} GiB/s, read_speedup "
          f"{bench['read_speedup']} ({time.perf_counter() - t1:.1f} s); "
          f"codec kernel launches "
          f"{json.dumps(out['tier_bench_launches'])}; card {card}",
          flush=True)
    out["tier_bench"] = bench
    out["seconds"] = time.perf_counter() - t0
    print(f"[tier] codec kernel launches on the tier path (its writeback "
          f"and readproxy cycles, each zeroed before it) "
          f"{json.dumps(out['launches'])}; phase {out['seconds']:.1f} s; "
          f"card {card}", flush=True)
    return out


def _lrc_cuda_profile(reg) -> dict:
    """lrc k=4 m=2 l=3's generated mapping and layers, each layer on the
    ``cuda`` plugin (the card)."""
    gen = reg.factory("lrc", dict(_LRC_KML, plugin="jerasure"))
    layers = [[layer.chunks_map, "plugin=cuda"] for layer in gen.layers]
    return {"mapping": gen.get_profile()["mapping"],
            "layers": json.dumps(layers)}


def _family_stripes(seed: int):
    """Seeded stripes, half of their bytes >= 0x80."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(FAMILY_STRIPES):
        s = np.frombuffer(rs.bytes(FAMILY_STRIPE), dtype=np.uint8).copy()
        s[::2] |= 0x80
        out.append(s)
    return out


def _same_chunks(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), f"{what}: chunk ids {sorted(got)}"
    for c in want:
        assert np.array_equal(np.asarray(got[c]), np.asarray(want[c])), \
            f"{what}: chunk {c} differs from the CPU twin"


def _regen_repair(ec, twin, chunks, card) -> dict:
    """Every single lost node of regen: the d survivors' helper symbols
    on the card and ``regenerate_batch`` over the stripes, against the
    CPU twin (the host LUT engine) and the lost chunk; then helpers of a
    width off the lane grid, which take the host path on the card."""
    from ceph_tpu_torch.plugins import regen

    n = ec.get_chunk_count()
    before = cuda_gf.launches["gf2_matrix_w8"]
    t0 = time.perf_counter()
    for lost in range(n):
        helpers = [s for s in range(n) if s != lost][:ec.d]
        coeffs = ec.repair_coeffs(lost)
        symbols, want = {}, {}
        for h in helpers:
            shards = [c[h] for c in chunks]
            symbols[h] = regen.compute_helpers(coeffs, shards, device="cuda")
            want[h] = regen.compute_helpers(coeffs, shards, device="cpu")
            for i, (a, b) in enumerate(zip(symbols[h], want[h])):
                assert np.array_equal(a, b), \
                    f"regen helpers: lost {lost} helper {h} stripe {i}"
        stacks = [np.stack([symbols[h][i] for h in helpers])
                  for i in range(len(chunks))]
        got = ec.regenerate_batch(lost, helpers, stacks)
        ref = twin.regenerate_batch(lost, helpers, stacks)
        for i, (a, b) in enumerate(zip(got, ref)):
            assert np.array_equal(a, b) and \
                np.array_equal(a, chunks[i][lost]), \
                f"regen regenerate_batch: lost {lost} stripe {i}"
    torch.cuda.synchronize()
    repair_s = time.perf_counter() - t0
    rose = cuda_gf.launches["gf2_matrix_w8"] - before
    assert rose > 0, "regen repair: gf2_matrix_w8 was never launched"
    # off the lane grid: host path on the card, the same bytes
    rs = np.random.RandomState(OFF_LANE_BETA)
    shard_len = ec.alpha * OFF_LANE_BETA
    shards = [rs.randint(0, 256, shard_len, dtype=np.uint8)
              for _ in range(ec.d)]
    coeffs = ec.repair_coeffs(0)
    before_off = cuda_gf.launches["gf2_matrix_w8"]
    off = regen.compute_helpers(coeffs, shards, device="cuda")
    stack = np.stack(off)
    regen_off = ec.regenerate_batch(0, list(range(1, ec.d + 1)), [stack])
    torch.cuda.synchronize()
    assert cuda_gf.launches["gf2_matrix_w8"] == before_off, \
        "regen off-lane widths launched the kernel"
    want_off = regen.compute_helpers(coeffs, shards, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(off, want_off))
    assert np.array_equal(regen_off[0], twin.regenerate_batch(
        0, list(range(1, ec.d + 1)), [stack])[0])
    print(f"[family] regen k=4 m=3 d=6: helper symbols and regenerate_batch "
          f"for each of {n} lost nodes over {len(chunks)} stripes "
          f"bit-exact vs the host LUT engine and the lost chunk "
          f"({repair_s:.2f} s, gf2_matrix_w8 launches {rose}); beta = "
          f"{OFF_LANE_BETA} (off the lane grid) through the host path, no "
          f"launch, bit-exact; card {card}", flush=True)
    return {"repair_s": repair_s, "repair_launches": rose}


def phase_plugin_family(reg, seed: int, card: str) -> dict:
    """The rest of the plugin layer on the card (docstring, phase 3e)."""
    results = {}
    stripes = _family_stripes(seed)
    gib = FAMILY_STRIPES * FAMILY_STRIPE / 2**30
    t_phase = time.perf_counter()
    for label, name, card_prof, cpu_prof, kern, erased in FAMILY:
        prof = _lrc_cuda_profile(reg) if card_prof is None else card_prof
        ec = reg.factory(name, dict(prof))
        twin = reg.factory(name, dict(cpu_prof))
        km = ec.get_chunk_count()
        want = set(range(km))
        cs = ec.get_chunk_size(FAMILY_STRIPE)
        assert cs % cuda_gf.LANE_BYTES == 0, f"{label}: chunk {cs} B"
        before = dict(cuda_gf.launches)
        t0 = time.perf_counter()
        # regen's device lanes are its batched API (its sync decode runs
        # the host engine, as the JAX package's does)
        batched = hasattr(ec, "decode_batch")
        enc = ec.encode_batch(stripes) if batched else \
            [ec.encode(want, s) for s in stripes]
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        ref = [twin.encode(want, s) for s in stripes]
        for i, (a, b) in enumerate(zip(enc, ref)):
            _same_chunks(a, b, f"{label} encode stripe {i}")
        maps = [{c: a for c, a in e.items() if c not in erased}
                for e in ref]
        t0 = time.perf_counter()
        dec = ec.decode_batch(maps) if batched else \
            [ec.decode(want, dict(mp)) for mp in maps]
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        for i, (a, mp) in enumerate(zip(dec, maps)):
            _same_chunks(a, twin.decode(want, dict(mp)),
                         f"{label} decode stripe {i}")
            _same_chunks({c: a[c] for c in erased},
                         {c: ref[i][c] for c in erased},
                         f"{label} decode stripe {i} vs encode")
        rose = cuda_gf.launches[kern] - before[kern]
        assert rose > 0, f"{label}: {kern} was never launched"
        row = {"plugin": name, "kernel": kern, "chunk_bytes": cs,
               "erased": list(erased), "launches": rose,
               "encode_GiBs": gib / enc_s, "decode_GiBs": gib / dec_s}
        print(f"[family] {label}: {FAMILY_STRIPES} x {FAMILY_STRIPE} B "
              f"stripes, {cs} B chunks, encode {row['encode_GiBs']:.3f} "
              f"GiB/s, decode {row['decode_GiBs']:.3f} GiB/s (erased "
              f"{list(erased)}), every chunk bit-exact vs the CPU twin; "
              f"{kern} launches {rose}; card {card}", flush=True)
        if name == "regen":
            row.update(_regen_repair(ec, twin, ref, card))
        results[label] = row
    print(f"[family] phase {time.perf_counter() - t_phase:.1f} s; card "
          f"{card}", flush=True)
    return results


def _native_handshake() -> dict:
    """The dlopen registry's load handshake (docstring, phase 3f a)."""
    assert registry_native.load("xor_native") == 0, \
        registry_native.last_error()
    codec = registry_native.factory("xor_native", {"k": "4"})
    rs = np.random.RandomState(4)
    data = [rs.randint(0, 256, 4096, dtype=np.uint8) for _ in range(4)]
    parity = codec.encode(data)[0]
    assert np.array_equal(parity, np.bitwise_xor.reduce(data))
    chunks = {i: d for i, d in enumerate(data) if i != 2}
    chunks[4] = parity
    assert np.array_equal(codec.decode(chunks, [2], 4096)[2], data[2])
    assert registry_native.load("regen_native") == 0, \
        registry_native.last_error()
    codes = {name: registry_native.load(name) for name in NATIVE_FAILURES}
    assert codes == NATIVE_FAILURES, codes
    t0 = time.perf_counter()
    hang = registry_native.load_with_timeout("hangs_native",
                                             HANG_TIMEOUT_MS)
    hang_s = time.perf_counter() - t0
    assert hang == -110 and hang_s < 5.0, (hang, hang_s)
    return {"failure_codes": codes, "hang_rc": hang, "hang_s": hang_s}


def _native_engine_rows(seed: int) -> dict:
    """backend=native against backend=cpu (docstring, phase 3f a)."""
    reg = registry_mod.ErasureCodePluginRegistry()
    stripes = _family_stripes(seed)
    gib = FAMILY_STRIPES * FAMILY_STRIPE / 2**30
    rows = {}
    for label, name, prof, erased in NATIVE:
        nat = reg.factory(name, dict(prof, backend="native"))
        cpu = reg.factory(name, dict(prof, backend="cpu"))
        want = set(range(nat.get_chunk_count()))
        times = {}
        out = {}
        for engine, ec in (("native", nat), ("cpu", cpu)):
            t0 = time.perf_counter()
            enc = [ec.encode(want, s) for s in stripes]
            enc_s = time.perf_counter() - t0
            maps = [{c: a for c, a in e.items() if c not in erased}
                    for e in enc]
            t0 = time.perf_counter()
            dec = [ec.decode(want, mp) for mp in maps]
            times[engine] = (gib / enc_s, gib / (time.perf_counter() - t0))
            out[engine] = (enc, dec)
        for i in range(FAMILY_STRIPES):
            _same_chunks(out["native"][0][i], out["cpu"][0][i],
                         f"{label} native encode stripe {i}")
            _same_chunks(out["native"][1][i], out["cpu"][1][i],
                         f"{label} native decode stripe {i}")
        rows[label] = {
            "encode_GiBs": times["native"][0],
            "decode_GiBs": times["native"][1],
            "cpu_encode_GiBs": times["cpu"][0],
            "cpu_decode_GiBs": times["cpu"][1], "erased": list(erased)}
    return rows


def _corpus_checks(card: str) -> dict:
    """The port's --check of every corpus directory (phase 3f b)."""
    rows = {}
    for name in sorted(os.listdir(CORPUS)):
        if not os.path.isdir(os.path.join(CORPUS, name)):
            continue
        on_card = name.startswith(("plugin=cuda ", "plugin=regen ")) or \
            " backend=cuda" in name
        before = {k: cuda_gf.launches[k] for k in CODEC_KERNELS}
        argv = ["--check", "--base", CORPUS] + \
            ec_non_regression.directory_argv(name)
        t0 = time.perf_counter()
        rc = ec_non_regression.main(argv)
        torch.cuda.synchronize()
        check_s = time.perf_counter() - t0
        after = {k: cuda_gf.launches[k] for k in CODEC_KERNELS}
        rose = {k: after[k] - before[k] for k in CODEC_KERNELS}
        assert rc == 0, f"corpus {name}: --check exited {rc}"
        if on_card:
            assert any(rose.values()), \
                f"corpus {name}: no codec kernel launched ({rose})"
        else:
            assert not any(rose.values()), f"corpus {name}: {rose}"
        rows[name] = {"card": on_card, "launches": rose, "s": check_s}
        print(f"[corpus] {name}: --check 0 in {check_s:.3f} s "
              f"({'card' if on_card else 'host'}); launches before "
              f"{json.dumps(before)} after {json.dumps(after)}; card {card}",
              flush=True)
    return rows


def _bench_sweep(card: str) -> dict:
    """ec_bench_sweep on the card (docstring, phase 3f c)."""
    argv = ["--plugins", "cuda,jerasure,isa", "--backend", "cuda"]
    before = {k: cuda_gf.launches[k] for k in CODEC_KERNELS}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = ec_bench_sweep.main(argv)
    sweep_s = time.perf_counter() - t0
    assert rc == 0, f"ec_bench_sweep exited {rc}"
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    errors = [r for r in rows if "error" in r]
    assert not errors, f"ec_bench_sweep error lines: {errors}"
    assert len(rows) == 42, len(rows)
    for row in rows:
        print(f"[sweep] {json.dumps(row)}", flush=True)
    launches = {k: cuda_gf.launches[k] - before[k] for k in CODEC_KERNELS}
    assert launches["gf2_matrix_w8"] > 0 and launches["gf2_packet"] > 0, \
        launches
    print(f"[sweep] {' '.join(argv)}: {len(rows)} cells in {sweep_s:.1f} s, "
          f"launches {json.dumps(launches)}; cuda rows' h2d_ops "
          f"{[r['h2d_ops'] for r in rows if r['plugin'] == 'cuda']}; card "
          f"{card}", flush=True)
    return {"rows": rows, "launches": launches, "s": sweep_s}


def phase_native_tools(seed: int, card: str) -> dict:
    """The native layer and the EC tools (docstring, phase 3f)."""
    t_phase = time.perf_counter()
    crush = subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.tools.crushtool",
         *CRUSHTOOL_ARGV], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        t0 = time.perf_counter()
        lib_dir = native_build.native_dir()
        build_s = time.perf_counter() - t0
        features = gf_native.cpu_features()
        cpu = native_build.cpu_model()
        out = {"build_s": build_s, "cpu_model": cpu, "isa": features}
        out.update(_native_handshake())
        print(f"[native] built {lib_dir.name} in {build_s:.1f} s on "
              f"{cpu} (cpu {features['cpu']}, build {features['build']}); "
              f"xor_native and regen_native load, xor encode/decode "
              f"bit-exact; failure codes {json.dumps(out['failure_codes'])};"
              f" hangs_native {out['hang_rc']} after {out['hang_s']:.3f} s",
              flush=True)
        out["engine"] = _native_engine_rows(seed)
        for label, row in out["engine"].items():
            print(f"[native] {label}: {FAMILY_STRIPES} x {FAMILY_STRIPE} B, "
                  f"backend=native encode {row['encode_GiBs']:.3f} GiB/s, "
                  f"decode {row['decode_GiBs']:.3f} GiB/s (erased "
                  f"{row['erased']}); backend=cpu encode "
                  f"{row['cpu_encode_GiBs']:.3f}, decode "
                  f"{row['cpu_decode_GiBs']:.3f} GiB/s; every chunk equal; "
                  f"host {cpu}; card {card}", flush=True)
        out["corpus"] = _corpus_checks(card)
        out["sweep"] = _bench_sweep(card)
        for name in sorted(registry_mod._BUILTIN):
            assert ec_info.main(["--plugin_exists", name]) == 0, name
        print(f"[ec_info] --plugin_exists 0 for "
              f"{', '.join(sorted(registry_mod._BUILTIN))}", flush=True)
        crush_out, crush_err = crush.communicate(timeout=300)
    finally:
        crush.kill()
        crush.wait()
    assert crush.returncode == 0, crush_err
    summary = crush_out.strip().splitlines()[-1]
    assert "result size == 12.00/12" in summary and \
        summary.endswith("bad mappings 0"), summary
    out["crushtool"] = summary
    print(f"[crushtool] {' '.join(CRUSHTOOL_ARGV)}: {summary!r}", flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[native] phase {out['seconds']:.1f} s; card {card}", flush=True)
    return out


def _df(path: str) -> str:
    """``df -T`` of the filesystem holding ``path``: its device, type and
    sizes."""
    line = subprocess.run(["df", "-T", path], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    return " ".join(line.split())


def _durable_cycle(label, extra_profile, kind, mons, n_objects, n_extra,
                   name, seed, root, card) -> dict:
    """One durable cycle (docstring, phase 3g a and b); with mons, the
    replicated index pool (c) on the remounted cluster's OSDs."""
    reg = registry_mod.instance()
    ref = reg.factory("jerasure", _profile(extra_profile))
    payloads = cluster_bench.make_payloads(n_objects, OBJECT, seed)
    rng = np.random.RandomState(seed + 1)
    extra = {f"new{i}": rng.bytes(OBJECT) for i in range(n_extra)}
    path = os.path.join(root, kind)
    launches = {}

    def hook(_cluster, step, when):
        if when == "start":
            cuda_gf.reset_launches()
        else:
            torch.cuda.synchronize()
            launches[step] = cuda_gf.launches[name]

    async def make():
        if mons:
            return await ECCluster.create_with_mons(
                DURABLE_OSDS, _profile(extra_profile), n_mons=DURABLE_MONS,
                plugin="cuda", objectstore=kind, data_path=path)
        return ECCluster(DURABLE_OSDS, _profile(extra_profile),
                         plugin="cuda", objectstore=kind, data_path=path)

    async def main():
        r = await durable_bench.run_durable_cycle(
            make, payloads, extra, writers=WRITERS,
            deadline_s=CLUSTER_DEADLINE_S, hook=hook, data_path=path)
        cluster = r["cluster"]
        try:
            assert type(cluster.ec).__module__ == \
                "ceph_tpu_torch.plugins.cuda", type(cluster.ec)
            t0 = time.perf_counter()
            r["check"] = _cluster_check(cluster, ref, r["final"],
                                        crc=False)
            r["check_s"] = time.perf_counter() - t0
            if mons:
                rc, st = await cluster.mon_command({"prefix": "status"})
                assert rc == 0 and st["pools"] == ["ecpool"], (rc, st)
                objs = durable_bench.index_objects(
                    INDEX_OBJECTS, INDEX_BYTES, INDEX_KEYS, seed + 2)
                r["index"] = await durable_bench.run_index_pool(
                    cluster, objs, writers=WRITERS)
        finally:
            await cluster.shutdown()
        return r

    PerfCounters.reset_all()
    t0 = time.perf_counter()
    loop = asyncio.new_event_loop()
    try:
        r = loop.run_until_complete(main())
    finally:
        loop.close()
    cycle_s = time.perf_counter() - t0
    for step in DURABLE_KERNEL_STEPS:
        assert launches.get(step, 0) > 0, \
            f"durable {label}: {name} not launched in {step}"
    head = (f"[durable] {label}: {DURABLE_OSDS} OSDs, {n_objects} x "
            f"{OBJECT} B objects, {WRITERS} client tasks, osd.{r['victim']} "
            f"down, {n_extra} written degraded")
    print(f"{head}: write {r['write_GiBs']:.4f} GiB/s, degraded read "
          f"{r['degraded_read_GiBs']:.4f} GiB/s, read after the crash "
          f"{r['remount_read_GiBs']:.4f} GiB/s, read when clean "
          f"{r['read_GiBs']:.4f} GiB/s; time to clean "
          f"{r['time_to_clean_s']:.3f} s; card {card}", flush=True)
    if mons:
        print(f"{head}: mon leader mon.{r['mon_leaders']['before']} killed, "
              f"mon.{r['mon_leaders']['after']} answered after "
              f"{r['steps_s']['mon_failover']:.3f} s; card {card}",
              flush=True)
    print(f"{head}: on disk after the writes "
          f"{json.dumps(r['disk_after_write'])}, after recovery "
          f"{json.dumps(r['disk_after_recovery'])}; {kind} on {_df(path)}",
          flush=True)
    print(f"{head}: crash remount read every one of "
          f"{len(r['final'])} objects back; {r['check']} "
          f"({r['check_s']:.1f} s); {name} launches per step "
          f"{json.dumps(launches)}; steps {json.dumps(r['steps_s'])}; "
          f"cycle {cycle_s:.1f} s; card {card}", flush=True)
    if "index" in r:
        ix = r["index"]
        print(f"[durable] replicated pool meta size={ix['size']}: "
              f"{ix['objects']} x {INDEX_BYTES} B objects with "
              f"{INDEX_KEYS} omap keys each, written in "
              f"{ix['steps_s']['write']:.3f} s, read with osd.{ix['down']} "
              f"down in {ix['steps_s']['degraded_read']:.3f} s; "
              f"{ix['copies_compared']} replica copies and every omap copy "
              f"equal; card {card}", flush=True)
    return {"kernel": name, "objectstore": kind, "mons": mons,
            "objects": n_objects, "extra": n_extra, "obj_bytes": OBJECT,
            "osds": DURABLE_OSDS, "launches": launches, "cycle_s": cycle_s,
            **{key: r[key] for key in (
                "victim", "mon_leaders", "steps_s", "write_GiBs",
                "degraded_read_GiBs", "remount_read_GiBs", "read_GiBs",
                "time_to_clean_s", "op_ms", "disk_after_write",
                "disk_after_recovery", "check_s")},
            **({"index": r["index"]} if "index" in r else {})}


def phase_durable(seed: int, card: str) -> dict:
    """The durable cluster on the card (docstring, phase 3g)."""
    t_phase = time.perf_counter()
    os.makedirs(DURABLE_ROOT, exist_ok=True)
    root = tempfile.mkdtemp(prefix="durable-", dir=DURABLE_ROOT)
    print(f"[durable] data path {root} on {_df(root)}", flush=True)
    out = {}
    try:
        for label, extra, kind, mons, n_objects, n_extra, name in \
                DURABLE_PROFILES:
            out[label] = _durable_cycle(label, extra, kind, mons, n_objects,
                                        n_extra, name, seed, root, card)
            gc.collect()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"[durable] phase {seconds:.1f} s; card {card}", flush=True)
    return {"profiles": out, "seconds": seconds}


def _mesh_devices(slots: int = MESH_SLOTS):
    """Every card the process sees when it sees ``slots`` or more, else
    ``cuda:0`` ``slots`` times (a stream each)."""
    n = torch.cuda.device_count()
    if n >= slots:
        return ([torch.device("cuda", i) for i in range(n)],
                f"{n} distinct cards")
    return ([torch.device("cuda", 0)] * slots,
            f"cuda:0 repeated {slots} times")


def _shard_bytes(cluster) -> dict:
    """Every stored shard's bytes (``(osd, name)`` -> data), the PG-meta
    objects left out, as the JAX package's mesh test compares them."""
    return {(osd.osd_id, soid): osd.store.read(soid)
            for osd in cluster.osds for soid in osd.store.list_objects()
            if soid.rpartition("@")[2] != "meta"}


def _mesh_cycle(plane_on: bool, payloads, overwrites, card) -> dict:
    """One storage cycle of ``ECCluster(16, reed_sol_van k=8 m=4,
    plugin="cuda")`` with ``osd_mesh_data_plane`` on or off (docstring,
    phase 3h a); the victim is an OSD bound to the plane, the same OSD
    in both runs."""
    cfg = get_config()
    cfg.set_val("osd_mesh_data_plane", plane_on)
    mesh_plane.reset()
    launches, mesh_before = {}, {}

    def hook(_cluster, step, when):
        ledger = residency.counters().snapshot()
        if when == "start":
            cuda_gf.reset_launches()
            mesh_before[step] = ledger
        else:
            torch.cuda.synchronize()
            launches[step] = cuda_gf.launches["gf2_matrix_w8"]
            mesh_before[step] = {
                key: ledger[key] - mesh_before[step].get(key, 0)
                for key in ledger if key.startswith("mesh_")}

    async def main():
        cluster = ECCluster(MESH_OSDS, _profile({"technique": "reed_sol_van"}),
                            plugin="cuda")
        plane = mesh_plane.current_plane()
        # the first OSD of an acting set that the plane binds (the
        # plane-off run kills the same one)
        victim = next(o for oid in payloads
                      for o in cluster.backend.acting_set(oid)
                      if o < MESH_SLOTS)
        assert plane is None or plane.covers(f"osd.{victim}"), \
            f"mesh path: osd.{victim} is not bound to the plane"
        try:
            r = await cluster_bench.run_cycle(
                cluster, payloads, overwrites, writers=WRITERS,
                deadline_s=CLUSTER_DEADLINE_S, hook=hook, victim=victim)
        finally:
            await cluster.shutdown()
        r["cluster"] = cluster
        r["plane"] = plane.status() if plane is not None else None
        return r

    PerfCounters.reset_all()
    t0 = time.perf_counter()
    loop = asyncio.new_event_loop()
    try:
        r = loop.run_until_complete(main())
    finally:
        loop.close()
    r["cycle_s"] = time.perf_counter() - t0
    r["launches"] = launches
    r["mesh_ledger"] = mesh_before
    for step in CLUSTER_KERNEL_STEPS:
        assert launches[step] > 0, \
            f"mesh path (plane {plane_on}): gf2_matrix_w8 not launched in " \
            f"{step}"
    return r


def _mesh_codec_step(seed: int, card: str) -> dict:
    """``DistributedCodec`` on the card (docstring, phase 3h b)."""
    from ceph_tpu_torch.parallel.distributed import (DistributedCodec,
                                                     make_mesh)

    rng = np.random.RandomState(seed + 7)
    matrix = reed_sol.vandermonde_coding_matrix(K, M, 8)
    data = rng.randint(0, 256, size=(MESH_STRIPES, K, STRIPE // K),
                       dtype=np.uint8)
    want = np.stack([cpu_engine.matrix_encode(matrix, d, 8) for d in data])
    F = gf(8)
    sel = [c for c in range(K + M) if c not in ERASED][:K]
    A = np.zeros((K, K), dtype=np.uint32)
    for r, c in enumerate(sel):
        if c < K:
            A[r, c] = 1
        else:
            A[r] = matrix[c - K]
    rows = F.mat_invert(A)[list(ERASED)]
    survivors = np.concatenate([data, want], axis=1)[:, sel]
    gib = data.nbytes / 2**30
    out = {}
    for grid in MESH_GRIDS:
        mesh = make_mesh(*grid, devices=parallel.local_devices())
        codec = DistributedCodec(matrix, 8, mesh)
        cuda_gf.reset_launches()
        times = {}
        for name, fn in (
                ("encode", lambda: codec.encode(data)),
                ("encode_scatter", lambda: codec.encode_scatter(data)),
                ("verify", lambda: codec.verify(data, want)),
                ("reconstruct", lambda: codec.reconstruct(rows, survivors))):
            fn()
            t0 = time.perf_counter()
            res = fn()
            times[name] = time.perf_counter() - t0
            if name.startswith("encode"):
                assert np.array_equal(res, want), \
                    f"mesh codec {grid}: {name} differs from cpu_engine"
            elif name == "verify":
                assert res.all(), f"mesh codec {grid}: verify failed"
            else:
                assert np.array_equal(res, data[:, list(ERASED)]), \
                    f"mesh codec {grid}: reconstruct differs from the data"
        bad = want.copy()
        bad[1, 0, 5] ^= 0xFF
        ok = codec.verify(data, bad)
        assert not ok[1] and ok[[0, *range(2, MESH_STRIPES)]].all(), \
            f"mesh codec {grid}: verify missed the corrupted stripe {ok}"
        owners = codec.parity_owner_slots()
        scattered = codec.encode_scatter_shards(data)
        per = M // grid[1]
        for (d, s, u), index, t in scattered:
            assert index[1] == slice(s * per, (s + 1) * per) and \
                t.device == mesh.devices[d, s, u], (grid, index, t.device)
            assert np.array_equal(t.cpu().numpy(), want[index]), \
                f"mesh codec {grid}: owner slice of cell {(d, s, u)}"
        torch.cuda.synchronize()
        launches = cuda_gf.launches["gf2_matrix_w8"]
        assert launches > 0, f"mesh codec {grid}: gf2_matrix_w8 not launched"
        out[str(grid)] = {
            "GiBs": {name: gib / t for name, t in times.items()},
            "owners": owners, "launches": launches}
        print(f"[mesh] DistributedCodec (data, shard, sub) = {grid} over "
              f"{[str(d) for d in mesh.devices.flat]}: {MESH_STRIPES} x "
              f"{STRIPE} B stripes, encode / encode_scatter / verify / "
              f"reconstruct (chunks {ERASED}) GiB/s "
              + " / ".join(f"{gib / times[n]:.4f}" for n in times)
              + f", equal to cpu_engine; parity owners {owners}; "
              f"gf2_matrix_w8 launches {launches}; card {card}", flush=True)
    return out


def _mesh_shard_pool(seed: int, card: str) -> dict:
    """A ``mesh_shard=2`` pool through the storage cycle (docstring,
    phase 3h d)."""
    ref = registry_mod.instance().factory(
        "jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"})
    payloads = cluster_bench.make_payloads(MESH_SHARD_OBJECTS, OBJECT,
                                           seed + 3)
    overwrites = cluster_bench.make_overwrites(payloads, CLUSTER_OVERWRITE,
                                               seed + 4)
    launches = {}

    def hook(_cluster, step, when):
        if when == "start":
            cuda_gf.reset_launches()
        else:
            torch.cuda.synchronize()
            launches[step] = cuda_gf.launches["gf2_matrix_w8"]

    r = cluster_bench.run_storage_cycle(
        lambda: ECCluster(MESH_SHARD_OSDS, dict(MESH_SHARD_PROFILE),
                          plugin="cuda"),
        payloads, overwrites, writers=WRITERS,
        deadline_s=CLUSTER_DEADLINE_S, hook=hook)
    assert r["cluster"].ec._mesh_codec is not None, \
        "mesh_shard pool: the grid codec never ran"
    for step in CLUSTER_KERNEL_STEPS:
        assert launches[step] > 0, \
            f"mesh_shard pool: gf2_matrix_w8 not launched in {step}"
    check = _cluster_check(r["cluster"], ref, r["final"], crc=False)
    print(f"[mesh] mesh_shard=2 pool k=4 m=2: {MESH_SHARD_OSDS} OSDs, "
          f"{MESH_SHARD_OBJECTS} x {OBJECT} B objects, osd.{r['victim']} "
          f"down: write {r['write_GiBs']:.4f} GiB/s, degraded read "
          f"{r['degraded_read_GiBs']:.4f} GiB/s, time to clean "
          f"{r['time_to_clean_s']:.3f} s; {check}; gf2_matrix_w8 launches "
          f"per step {json.dumps(launches)}; card {card}", flush=True)
    return {"launches": launches, **{key: r[key] for key in (
        "write_GiBs", "degraded_read_GiBs", "read_GiBs", "time_to_clean_s",
        "steps_s")}}


def phase_mesh_plane(seed: int, card: str) -> dict:
    """The mesh data plane on the card (docstring, phase 3h)."""
    from ceph_tpu_torch import entry

    t_phase = time.perf_counter()
    devices, layout = _mesh_devices()
    parallel.configure_devices(devices)
    cfg = get_config()
    prior = (cfg.get_val("osd_mesh_data_plane"),
             cfg.get_val("osd_mesh_scatter"))
    print(f"[mesh] plane over {len(devices)} slots: {layout}", flush=True)
    out = {"slots": len(devices), "layout": layout}
    try:
        # (a) the full-width cluster with the plane on, then off
        ref = registry_mod.instance().factory(
            "jerasure", _profile({"technique": "reed_sol_van"}))
        payloads = cluster_bench.make_payloads(MESH_OBJECTS, OBJECT, seed)
        overwrites = cluster_bench.make_overwrites(
            payloads, CLUSTER_OVERWRITE, seed + 1)
        runs = {}
        for plane_on in (True, False):
            runs[plane_on] = _mesh_cycle(plane_on, payloads, overwrites,
                                         card)
        on, off = runs[True], runs[False]
        assert on["victim"] == off["victim"]
        t0 = time.perf_counter()
        same = _shard_bytes(on["cluster"]) == _shard_bytes(off["cluster"])
        assert same, "mesh path: stored shards differ with the plane off"
        check = _cluster_check(on["cluster"], ref, on["final"], crc=False)
        check_s = time.perf_counter() - t0
        st = on["plane"]
        counters = st["counters"]
        assert counters["mesh_wire_bytes_avoided"] > 0, counters
        assert counters["mesh_claim_miss"] == 0, counters
        assert st["board"]["misses"] == 0, st["board"]
        assert counters["mesh_encode_stripes"] > 0 and \
            counters["mesh_decode_stripes"] > 0, counters
        ledger = {key: sum(step.get(key, 0)
                           for step in on["mesh_ledger"].values())
                  for key in ("mesh_pg_dispatches", "mesh_pg_bytes",
                              "mesh_shard_dispatches", "mesh_shard_bytes")}
        slot = st["members"][f"osd.{on['victim']}"]
        head = (f"[mesh] reed_sol_van k=8 m=4: {MESH_OSDS} OSDs, "
                f"{MESH_OBJECTS} x {OBJECT} B objects, {WRITERS} client "
                f"tasks, osd.{on['victim']} (slot {slot}) down")
        for label, r in (("plane on", on), ("plane off", off)):
            print(f"{head}, {label}: write {r['write_GiBs']:.4f} GiB/s, "
                  f"degraded write {r['degraded_write_GiBs']:.4f}, "
                  f"degraded read {r['degraded_read_GiBs']:.4f}, read "
                  f"{r['read_GiBs']:.4f}; time to clean "
                  f"{r['time_to_clean_s']:.3f} s; gf2_matrix_w8 launches "
                  f"per step {json.dumps(r['launches'])}; cycle "
                  f"{r['cycle_s']:.1f} s; card {card}", flush=True)
        print(f"{head}: stored shards equal with the plane on and off; "
              f"{check} ({check_s:.1f} s); mesh_wire_bytes_avoided "
              f"{counters['mesh_wire_bytes_avoided']}, mesh_claim_miss "
              f"{counters['mesh_claim_miss']}, fused dispatches "
              f"{counters['mesh_fused_dispatches']}, local dispatches "
              f"{counters['mesh_local_dispatches']}, encode / decode "
              f"stripes {counters['mesh_encode_stripes']} / "
              f"{counters['mesh_decode_stripes']}; ledger "
              f"{json.dumps(ledger)}; board {json.dumps(st['board'])}; "
              f"card {card}", flush=True)
        out["cluster"] = {
            label: {key: r[key] for key in (
                "victim", "write_GiBs", "degraded_write_GiBs",
                "degraded_read_GiBs", "read_GiBs", "time_to_clean_s",
                "launches", "cycle_s", "steps_s")}
            for label, r in (("plane_on", on), ("plane_off", off))}
        out["cluster"]["plane"] = {"counters": counters,
                                   "board": st["board"], "ledger": ledger}
        del runs, on, off
        gc.collect()
        mesh_plane.reset()
        cfg.set_val("osd_mesh_data_plane", False)

        # (b) the grid codec, the reduce-scatter forced on
        cfg.set_val("osd_mesh_scatter", "on")
        out["codec"] = _mesh_codec_step(seed, card)

        # (c) the dry run's fast half on the card
        buf = io.StringIO()
        cuda_gf.reset_launches()
        with contextlib.redirect_stdout(buf):
            entry.dryrun_multichip(MESH_SLOTS, fast=True)
        torch.cuda.synchronize()
        line = buf.getvalue().strip().splitlines()[-1]
        assert line.startswith("dryrun_multichip ok (fast)") and \
            "0 steady library builds" in line, line
        assert cuda_gf.launches["gf2_matrix_w8"] > 0
        print(f"[mesh] entry.dryrun_multichip({MESH_SLOTS}, fast=True): "
              f"{line}; gf2_matrix_w8 launches "
              f"{cuda_gf.launches['gf2_matrix_w8']}; card {card}",
              flush=True)
        out["dryrun"] = line
        cfg.set_val("osd_mesh_scatter", prior[1])

        # (d) a mesh_shard=2 pool, the plane off
        out["mesh_shard_pool"] = _mesh_shard_pool(seed, card)
    finally:
        cfg.set_val("osd_mesh_data_plane", prior[0])
        cfg.set_val("osd_mesh_scatter", prior[1])
        mesh_plane.reset()
        parallel.configure_devices(None)
        gc.collect()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[mesh] phase {out['seconds']:.1f} s; card {card}", flush=True)
    return out


def _w8_launches() -> int:
    torch.cuda.synchronize()
    return cuda_gf.launches["gf2_matrix_w8"]


def _register_smoke_class() -> None:
    """A class method that moves a whole object through the codec:
    ``ClsContext.read`` (a decode where a data shard is missing) and
    ``write_full`` of its bytes XORed with the input byte (an encode); it
    answers the object's size."""
    from ceph_tpu_torch import cls

    async def rewrite(ctx, inp):
        data = np.frombuffer(await ctx.read(), np.uint8)
        await ctx.write_full((data ^ np.uint8(inp[0])).tobytes())
        return 0, Encoder().value(await ctx.stat()).bytes()

    cls.register("smoke", "rewrite")(rewrite)


def _control_classes(seed: int, ref, card: str) -> dict:
    """Object classes through librados (docstring, phase 3i a)."""
    from ceph_tpu_torch.client import Rados

    _register_smoke_class()
    payloads = cluster_bench.make_payloads(CONTROL_OBJECTS, OBJECT, seed + 31)
    launches, steps_s, exec_s = {}, {}, []
    rados = Rados(CONTROL_OSDS)
    io = rados.pool_create(
        "rbd", dict(_profile({"technique": "reed_sol_van"}), plugin="cuda"))
    io2 = rados.open_ioctx("rbd")
    cluster = io._cluster

    def run(step, fn):
        cuda_gf.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        steps_s[step] = time.perf_counter() - t0
        launches[step] = _w8_launches()
        return out

    def ex(ioctx, oid, c, method, req=None):
        """One timed exec: ``req`` bytes as they are, a value encoded;
        the output decoded."""
        if req is None or isinstance(req, bytes):
            inp = req or b""
        else:
            inp = Encoder().value(req).bytes()
        t0 = time.perf_counter()
        rc, out = ioctx.exec(oid, c, method, inp)
        exec_s.append(time.perf_counter() - t0)
        return rc, (Decoder(out).value() if out else None)

    def write():
        for oid, data in payloads.items():
            io.write_full(oid, data)

    hdr = "rbd_header.img"

    def header():
        rcs = [ex(io, hdr, "rbd", "create",
                  {"size": 1 << 30, "order": 22, "features": ["layering"]}),
               ex(io, hdr, "rbd", "set_size", {"size": 2 << 30}),
               ex(io, hdr, "rbd", "snap_add", {"name": "s1"}),
               ex(io, hdr, "rbd", "snap_protect", {"name": "s1"}),
               ex(io, hdr, "rbd", "add_child",
                  {"snap_id": 1, "child": "clone1"}),
               ex(io, hdr, "rbd", "set_features", {"enable": ["journaling"]}),
               ex(io, hdr, "rbd", "metadata_set",
                  {"conf_rbd_cache": b"false"}),
               ex(io, hdr, "rbd", "snap_unprotect", {"name": "s1"})]
        assert [rc for rc, _ in rcs] == [0] * 7 + [-16], rcs
        rc, md = ex(io, hdr, "rbd", "get_metadata")
        assert rc == 0 and md["size"] == 2 << 30 and md["snap_seq"] == 1 \
            and md["snaps"]["s1"]["protected"] and \
            md["features"] == ["journaling", "layering"], md
        assert io.exec(hdr, "rbd", "metadata_get", Encoder().value(
            {"key": "conf_rbd_cache"}).bytes()) == (0, b"false")
        return md

    def locks():
        assert io.lock_exclusive(hdr, "lock", "client.a") == 0
        assert io2.lock_exclusive(hdr, "lock", "client.b") == -16
        rc, info = ex(io2, hdr, "lock", "get_info", {"name": "lock"})
        assert (rc, info["lockers"]) == (0, ["client.a"]), info
        assert io.unlock(hdr, "lock", "client.a") == 0
        assert io2.lock_exclusive(hdr, "lock", "client.b") == 0
        assert ex(io, hdr, "version", "inc") == (0, 1)
        assert ex(io2, hdr, "version", "inc") == (0, 2)
        assert ex(io, hdr, "version", "check", {"ver": 2})[0] == 0
        assert ex(io, hdr, "version", "check", {"ver": 1})[0] == -125

    def rewrite():
        for oid in list(payloads)[:4]:
            rc, size = ex(io, oid, "smoke", "rewrite", b"\x5a")
            assert (rc, size) == (0, OBJECT), (rc, size)
            payloads[oid] = (np.frombuffer(payloads[oid], np.uint8)
                             ^ np.uint8(0x5A)).tobytes()
            assert io.read(oid) == payloads[oid], oid

    victim = cluster.backend.acting_set(hdr)[0]

    def degraded():
        cluster.kill_osd(victim)
        rc, md = ex(io2, hdr, "rbd", "get_metadata")
        assert rc == 0 and md["size"] == 2 << 30, md
        rc, info = ex(io, hdr, "lock", "get_info", {"name": "lock"})
        assert info["lockers"] == ["client.b"], info
        assert ex(io, hdr, "version", "inc") == (0, 3)
        assert io.omap_get(hdr, ["order"]) == {
            "order": Encoder().value(22).bytes()}
        for oid, data in payloads.items():
            assert io.read(oid) == data, f"control path: degraded read " \
                f"of {oid} differs"

    try:
        run("write", write)
        run("rbd_header", header)
        run("lock_version", locks)
        run("cls_rewrite", rewrite)
        run("degraded", degraded)
        cluster.revive_osd(victim)
        t0 = time.perf_counter()
        check = _cluster_check(cluster, ref, payloads)
        check_s = time.perf_counter() - t0
    finally:
        rados.shutdown()
    assert launches["write"] > 0 and launches["cls_rewrite"] > 0 and \
        launches["degraded"] > 0, launches
    lat = sorted(exec_s)
    out = {"write_GiBs": CONTROL_OBJECTS * OBJECT / 2**30 / steps_s["write"],
           "exec_p50_ms": cluster_bench.percentile(lat, 0.50) * 1e3,
           "exec_p99_ms": cluster_bench.percentile(lat, 0.99) * 1e3,
           "execs": len(lat), "victim": victim, "steps_s": steps_s,
           "launches": launches}
    print(f"[control] (a) classes: Rados({CONTROL_OSDS}) pool rbd, "
          f"{CONTROL_OBJECTS} x {OBJECT} B by IoCtx.write_full at "
          f"{out['write_GiBs']:.4f} GiB/s; rbd header, locks between two "
          f"IoCtxs, version inc / check, smoke.rewrite of 4 objects "
          f"through ClsContext.read / write_full; osd.{victim} (the "
          f"header's primary) down: exec and omap answer, {CONTROL_OBJECTS}"
          f" degraded reads exact; exec p50 {out['exec_p50_ms']:.3f} ms, "
          f"p99 {out['exec_p99_ms']:.3f} ms over {len(lat)} execs; {check} "
          f"({check_s:.1f} s); gf2_matrix_w8 launches per step "
          f"{json.dumps(launches)}; steps {json.dumps(steps_s)}; card {card}",
          flush=True)
    return out


async def _http_get(port: int, path: str):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read()
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    return head.decode().split("\r\n")[0], body.decode()


def _misplaced(cluster) -> int:
    return sum(len(b.pg_stats.misplaced) for o in cluster.osds
               for b in o.pools.values())


def _control_mgr(seed: int, ref, card: str) -> dict:
    """The manager over a cluster cycle (docstring, phase 3i b)."""
    from ceph_tpu_torch.mgr import (ClusterState, MgrDaemon, PGMap,
                                    PyModuleRegistry, health_checks)
    from ceph_tpu_torch.mgr.report import MgrReport

    payloads = cluster_bench.make_payloads(CONTROL_OBJECTS, OBJECT, seed + 41)
    overwrites = cluster_bench.make_overwrites(payloads, CLUSTER_OVERWRITE,
                                               seed + 42)
    final = dict(payloads, **overwrites)
    launches, steps_s, scrapes = {}, {}, {}

    async def main():
        cluster = ECCluster(CONTROL_OSDS,
                            _profile({"technique": "reed_sol_van"}),
                            plugin="cuda")
        daemon = MgrDaemon(cluster)
        port = await daemon.start()
        now = [1000.0]
        pgmap = PGMap(expected=[o.name for o in cluster.osds],
                      clock=lambda: now[0])

        async def step(name, coro_fn):
            cuda_gf.reset_launches()
            t0 = time.perf_counter()
            out = await coro_fn()
            steps_s[name] = time.perf_counter() - t0
            launches[name] = _w8_launches()
            return out

        async def scrape(label, want_status, want_checks):
            before = residency.counters().snapshot()
            t0 = time.perf_counter()
            got = {path: await _http_get(port, path)
                   for path in ("/health", "/status", "/metrics")}
            ms = (time.perf_counter() - t0) * 1e3
            after = residency.counters().snapshot()
            assert before == after, (before, after)
            for path, (head, _) in got.items():
                assert head == "HTTP/1.1 200 OK", (path, head)
            health = json.loads(got["/health"][1])
            status = json.loads(got["/status"][1])
            metrics = got["/metrics"][1]
            assert health["status"] == want_status and \
                set(health["checks"]) == want_checks, (label, health)
            h2d = f'ceph_transfer_bytes_total{{direction="h2d"}} ' \
                f'{after["h2d_bytes"]}'
            assert h2d in metrics, (label, h2d)
            for family in ("ceph_library_builds_total",
                           "ceph_transfer_ops_total",
                           "ceph_trace_spans_finished",
                           "ceph_osd_tier_resident_bytes"):
                assert f"# TYPE {family} " in metrics, (label, family)
            # every OSD's report folded into the wire-fed map, whose
            # health is the in-process checks' (a virtual clock past the
            # beacon grace between scrapes: a silent daemon is down)
            now[0] += 3.0
            for osd in cluster.osds:
                if not cluster.messenger.is_down(osd.name):
                    pgmap.apply(MgrReport(osd.name, int(now[0]), 1.0,
                                          osd.mgr_report_stats(), 0.0))
            folded = pgmap.health()
            state = health_checks(ClusterState(cluster).dump())
            assert folded["status"] == state["status"] == want_status and \
                set(folded["checks"]) == set(state["checks"]), \
                (label, folded, state)
            scrapes[label] = {"ms": ms, "status": health["status"],
                              "checks": sorted(health["checks"]),
                              "h2d_bytes": after["h2d_bytes"],
                              "osds_up": status["osdmap"]["num_up_osds"],
                              "metrics_lines": len(metrics.splitlines())}

        async def write(oid, data):
            await cluster.write(oid, data)

        async def read(oid, want):
            assert await cluster.read(oid) == want, \
                f"control path: read of {oid} differs"

        async def settle(what):
            """Tick until the stores are clean, nothing is misplaced and
            the mgr's checks (fed by each primary's incremental PG stats,
            which a peering pass's epilogue clears after the stores are
            whole) say HEALTH_OK; then stop the tick loops, so the
            ledger holds still while a scrape renders it."""
            loop = asyncio.get_running_loop()
            deadline = loop.time() + CONTROL_DEADLINE_S
            while _misplaced(cluster) or await cluster.degraded_report() \
                    or health_checks(ClusterState(cluster).dump())[
                        "status"] != "HEALTH_OK":
                assert loop.time() < deadline, \
                    f"control path: not clean after {what}"
                await asyncio.sleep(0.05)
            durable_bench.stop_auto_recovery(cluster)

        try:
            await step("write", lambda: cluster_bench.client_ops(
                payloads.items(), write, WRITERS))
            await scrape("before_kill", "HEALTH_OK", set())
            victim = cluster.backend.acting_set("obj0")[0]
            cluster.kill_osd(victim)
            await step("degraded_write", lambda: cluster_bench.client_ops(
                overwrites.items(), write, WRITERS))
            await step("degraded_read", lambda: cluster_bench.client_ops(
                final.items(), read, WRITERS))
            await scrape("osd_down", "HEALTH_WARN",
                         {"OSD_DOWN", "PG_DEGRADED"})
            await step("recovery", lambda: cluster_bench.recover_until_clean(
                cluster, victim, 0.05, CONTROL_DEADLINE_S, "control path"))
            await step("settle", lambda: settle("the recovery"))
            await scrape("recovered", "HEALTH_OK", set())
            host = PyModuleRegistry(cluster, modules=["balancer"])
            rc, before, _ = host.handle_command({"prefix": "balancer eval"})
            weights0 = list(cluster.placement.weights)

            async def balance():
                rc, out, err = host.handle_command(
                    {"prefix": "balancer optimize"})
                assert rc == 0, (rc, out, err)
                # the OSDs' tick loops peer onto the new weights
                cluster.start_auto_recovery(interval=0.05)
                await settle("the balancer")
                return out

            optimized = await step("balancer", balance)
            weights = list(cluster.placement.weights)
            await step("read", lambda: cluster_bench.client_ops(
                final.items(), read, WRITERS))
            await scrape("balanced", "HEALTH_OK", set())
            rc, after, _ = host.handle_command({"prefix": "balancer eval"})
            await host.stop()
        finally:
            await daemon.stop()
            await cluster.shutdown()
        return cluster, victim, optimized, weights0, weights, before, after

    PerfCounters.reset_all()
    loop = asyncio.new_event_loop()
    try:
        cluster, victim, optimized, w0, w1, ev0, ev1 = \
            loop.run_until_complete(main())
    finally:
        loop.close()
    assert optimized.startswith("reweighted") and w1 != w0, optimized
    t0 = time.perf_counter()
    # the crcs of this path's shards are (a)'s and phase 3c's check
    check = _cluster_check(cluster, ref, final, crc=False)
    check_s = time.perf_counter() - t0
    for step in CLUSTER_KERNEL_STEPS:
        assert launches[step] > 0, \
            f"control path: gf2_matrix_w8 not launched in {step}"
    score0, score1 = (float(e.strip().splitlines()[-1].split()[-1])
                      for e in (ev0, ev1))
    gib = CONTROL_OBJECTS * OBJECT / 2**30
    out = {"victim": victim, "steps_s": steps_s, "launches": launches,
           "scrapes": scrapes, "balancer": optimized.strip(),
           "score_before": score0, "score_after": score1,
           "write_GiBs": gib / steps_s["write"],
           "degraded_write_GiBs": len(overwrites) * OBJECT / 2**30
           / steps_s["degraded_write"],
           "degraded_read_GiBs": gib / steps_s["degraded_read"],
           "time_to_clean_s": steps_s["recovery"],
           "rebalance_s": steps_s["balancer"]}
    print(f"[control] (b) mgr: ECCluster({CONTROL_OSDS}), {CONTROL_OBJECTS} "
          f"x {OBJECT} B; write {out['write_GiBs']:.4f} GiB/s, osd.{victim}"
          f" down, {len(overwrites)} overwritten at "
          f"{out['degraded_write_GiBs']:.4f} GiB/s, degraded read "
          f"{out['degraded_read_GiBs']:.4f} GiB/s, "
          f"clean in {out['time_to_clean_s']:.3f} s (the mgr's health OK "
          f"{steps_s['settle']:.3f} s later); health over HTTP "
          f"{' -> '.join(s['status'] for s in scrapes.values())}; scrape ms "
          f"(/health + /status + /metrics) "
          f"{json.dumps({k: round(v['ms'], 3) for k, v in scrapes.items()})};"
          f" every report folded into a PGMap, health equal to "
          f"health_checks; balancer {optimized.strip()!r}, score "
          f"{score0:.4f} -> {score1:.4f}, clean again in "
          f"{out['rebalance_s']:.3f} s; {check} ({check_s:.1f} s); "
          f"gf2_matrix_w8 launches per step {json.dumps(launches)}; card "
          f"{card}", flush=True)
    return out


@contextlib.contextmanager
def _shards_checked_at_shutdown(technique_profile: dict, checks: list):
    """While open, every ``ECCluster.shutdown`` first recovers the cluster
    until clean (a bench may leave a revived OSD's shards stale), stops
    its tick loops, reads every object and holds its stored shards
    against the numpy ``jerasure`` encode of what it read; the check's
    line and seconds go to ``checks``."""
    ref = registry_mod.instance().factory("jerasure", technique_profile)
    orig = ECCluster.shutdown

    async def shutdown(self):
        t0 = time.perf_counter()
        self.start_auto_recovery(interval=0.05)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + CONTROL_DEADLINE_S
        while await self.degraded_report():
            assert loop.time() < deadline, "control path: never clean"
            await asyncio.sleep(0.05)
        durable_bench.stop_auto_recovery(self)
        oids = sorted({name.rpartition("@")[0] for osd in self.osds
                       if not self.messenger.is_down(osd.name)
                       for name in osd.store.list_objects()
                       if name.rpartition("@")[2].isdigit()})
        final = {oid: await self.read(oid) for oid in oids}
        checks.append((_cluster_check(self, ref, final, crc=False),
                       time.perf_counter() - t0))
        await orig(self)

    ECCluster.shutdown = shutdown
    try:
        yield
    finally:
        ECCluster.shutdown = orig


def _control_elastic(card: str) -> dict:
    """Elastic membership (docstring, phase 3i c)."""
    from ceph_tpu_torch.osd import elastic_bench

    out = {}
    hot = {"default": 16, "4MiB": ELASTIC_4M["n_hot"]}
    for label, run in (
            ("default", lambda: elastic_bench.run_elastic_path_bench()),
            ("4MiB", lambda: _in_new_loop(elastic_bench._run(**ELASTIC_4M)))):
        PerfCounters.reset_all()
        cuda_gf.reset_launches()
        checks = []
        t0 = time.perf_counter()
        with _shards_checked_at_shutdown(
                {"technique": "reed_sol_van", "k": elastic_bench.PROFILE["k"],
                 "m": elastic_bench.PROFILE["m"]}, checks):
            r = run()
        seconds = time.perf_counter() - t0
        r["launches"] = _w8_launches()
        r["seconds"] = seconds
        (check, check_s), = checks
        assert r["bit_exact"] is True and r["steady_library_builds"] == 0 \
            and r["launches"] > 0, r
        out[label] = r
        print(f"[control] (c) elastic {label}: {r['n_osds']} OSDs + 2, "
              f"{r['n_objects']} + {hot[label]} x {r['obj_bytes']} B, "
              f"{r['n_clients']} clients: moved "
              f"ratio {r['data_moved_ratio']} (gate 1.25), time to clean "
              f"{r['time_to_clean_s']} s, client p99 "
              f"{r['client_p99_during_expansion_ms']} ms (gate 2000), "
              f"misplaced peak {r['misplaced_peak']} "
              f"({r['misplaced_upticks']} upticks), chaos rounds "
              f"{r['chaos']['target_kill']['rounds']}/"
              f"{r['chaos']['primary_rm']['rounds']}/"
              f"{r['chaos']['flap']['rounds']}, steady library builds "
              f"{r['steady_library_builds']}; {check} ({check_s:.1f} s, "
              f"recovery to clean included); gf2_matrix_w8 launches "
              f"{r['launches']}; {seconds:.1f} s; card {card}", flush=True)
    return out


def _in_new_loop(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _control_failover(card: str) -> dict:
    """Failover (docstring, phase 3i d)."""
    from ceph_tpu_torch.osd.failover_bench import (PROFILE,
                                                   run_failover_bench)

    out = {}
    for label, kw in (("default", {}), ("4MiB", FAILOVER_4M)):
        cuda_gf.reset_launches()
        checks = []
        t0 = time.perf_counter()
        with _shards_checked_at_shutdown(
                {key: PROFILE[key] for key in ("technique", "k", "m")},
                checks):
            r = run_failover_bench(**kw)
        r["launches"] = _w8_launches()
        r["seconds"] = time.perf_counter() - t0
        (check, check_s), = checks
        assert r["launches"] > 0, r
        out[label] = r
        print(f"[control] (d) failover {label} {json.dumps(kw)}: "
              f"time to first success mean {r['ttfs_mean_ms']} ms (max "
              f"{r['ttfs_max_ms']}), thrash p99 {r['thrash_p99_ms']} ms, "
              f"steady p50 / p99 {r['steady_p50_ms']} / "
              f"{r['steady_p99_ms']} ms, {r['kills']} kills, "
              f"{r['op_resend']} resends, {r['dup_op_hit']} dup hits; "
              f"{check} ({check_s:.1f} s, recovery to clean included); "
              f"gf2_matrix_w8 launches {r['launches']}; "
              f"{r['seconds']:.1f} s; card {card}", flush=True)
    return out


def phase_control_plane(seed: int, card: str) -> dict:
    """Object classes, the manager, elastic membership and failover on
    the card (docstring, phase 3i)."""
    t_phase = time.perf_counter()
    ref = registry_mod.instance().factory(
        "jerasure", _profile({"technique": "reed_sol_van"}))
    out = {"classes": _control_classes(seed, ref, card)}
    gc.collect()
    out["mgr"] = _control_mgr(seed, ref, card)
    gc.collect()
    out["elastic"] = _control_elastic(card)
    gc.collect()
    out["failover"] = _control_failover(card)
    gc.collect()
    out["launches"] = sum(
        sum(out[part]["launches"].values()) for part in ("classes", "mgr")) \
        + sum(r["launches"] for part in ("elastic", "failover")
              for r in out[part].values())
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[control] phase {out['seconds']:.1f} s; gf2_matrix_w8 launches "
          f"on the control path {out['launches']}; card {card}", flush=True)
    return out


def _wire_numpy_check(label: str, shards: dict, payloads: dict, ec,
                      ref) -> str:
    """Every stored shard of every object (``(osd, "<oid>@<s>")`` ->
    bytes) against the numpy ``jerasure`` encode of its payload in the
    pool's stripe layout, each shard present once."""
    k, km = ec.get_data_chunk_count(), ec.get_chunk_count()
    sinfo = ecutil.StripeInfo(k, k * ec.get_chunk_size(1))
    by_name = {}
    for (osd, soid), data in shards.items():
        assert soid not in by_name, f"{label}: {soid} stored twice"
        by_name[soid] = data
    assert len(by_name) == len(payloads) * km, \
        f"{label}: {len(by_name)} shards stored for {len(payloads)} objects"

    def check(item):
        oid, payload = item
        buf = np.zeros(sinfo.logical_to_next_stripe_offset(len(payload)),
                       np.uint8)
        buf[:len(payload)] = np.frombuffer(payload, np.uint8)
        want = ecutil.encode(sinfo, ref, buf, range(km))
        for s in range(km):
            assert by_name[f"{oid}@{s}"] == want[s].tobytes(), \
                f"{label}: {oid}@{s} differs from the numpy jerasure plugin"

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(check, payloads.items()))
    return f"{len(by_name)} shards bit-exact vs numpy jerasure"


def _wire_counters(c: dict) -> str:
    return (f"{c['frames_sent']} frames in {c['bursts']} bursts "
            f"({c['frames_per_burst']} a burst), {c['drains']} drains "
            f"({c['bytes_per_drain']} B a drain), acks piggybacked / "
            f"standalone / elided {c['acks_piggybacked']} / "
            f"{c['acks_standalone']} / {c['acks_elided']} (ratio "
            f"{c['ack_piggyback_ratio']}), {c['bytes_sent']} B sent, tcp / "
            f"ring conns {c['tcp_conns']} / {c['ring_conns']}")


def _wire_cluster_path(ec, ref, card: str) -> dict:
    """``run_cluster_path_bench`` at full width (docstring, phase 3j a)."""
    cuda_gf.reset_launches()
    t0 = time.perf_counter()
    r = wire_bench.run_cluster_path_bench(
        ec, n_objects=WIRE_OBJECTS, obj_bytes=OBJECT, writers=WRITERS,
        iters=1, seed=WIRE_SEED, keep_shards=True)
    launches = _w8_launches()
    seconds = time.perf_counter() - t0
    shards = r.pop("_shards")
    assert r["bit_exact"] is True and r["wire_codec"] == "python", r
    assert r["steady_library_builds"] == 0, r
    assert launches > 0, "wire path: gf2_matrix_w8 not launched in (a)"
    payloads = wire_bench.make_payloads(WIRE_OBJECTS, OBJECT, WIRE_SEED)
    t0 = time.perf_counter()
    check = _wire_numpy_check("wire path (a)", shards, payloads, ec, ref)
    check_s = time.perf_counter() - t0
    head = (f"[wire] (a) cluster-path: {r['n_osds']} OSDs on TCP, "
            f"{WIRE_OBJECTS} x {OBJECT} B objects, {WRITERS} writers")
    for mode in ("per_message", "corked"):
        m = r[mode]
        res = m["residency"]
        assert res["write"]["h2d_per_granule"] is not None and \
            res["write"]["h2d_per_granule"] <= 1, (mode, res)
        print(f"{head}, {mode}: write {m['write_MiBs'] / 1024:.4f} GiB/s "
              f"({m['wall_write_s']} s), read {m['read_MiBs'] / 1024:.4f} "
              f"GiB/s ({m['wall_read_s']} s); h2d_per_granule "
              f"{res['write']['h2d_per_granule']}, library builds "
              f"{m['steady_library_builds']}; {_wire_counters(m['counters'])}"
              f"; card {card}", flush=True)
    for mode in ("wire_per_message", "wire_corked"):
        w = r[mode]
        print(f"[wire] (a) wire stage {mode[5:]}: {w['wall_write_s']} s, "
              f"{w['msgs_per_s']} msgs/s, sub-ops of {w['sub_op_bytes']} B, "
              f"{w['inflight']} in flight; {_wire_counters(w['counters'])}; "
              f"card {card}", flush=True)
    print(f"{head}: write speedup {r['write_speedup']}, read speedup "
          f"{r['read_speedup']}, wire stage speedup "
          f"{r['wire_write_speedup']}; {check} ({check_s:.1f} s); "
          f"gf2_matrix_w8 launches {launches}; {seconds:.1f} s; card {card}",
          flush=True)
    r["launches"] = launches
    r["seconds"] = seconds
    r["_shards"] = shards
    return r


def _wire_side_cycles(ec, shards: dict, card: str) -> dict:
    """A signed cycle and a ring cycle (docstring, phase 3j b); each must
    store (a)'s shards of its objects."""
    from ceph_tpu_torch.auth import KeyRing

    payloads = wire_bench.make_payloads(WIRE_SIDE_OBJECTS, OBJECT,
                                        WIRE_SEED)
    km = ec.get_chunk_count()
    ring = KeyRing()
    for name in [f"osd.{i}" for i in range(km)] + ["client"]:
        ring.add(name)
    cfg = get_config()
    out = {}
    for label, keyring, shm in (("signed", ring, False),
                                ("shm_ring", None, True)):
        prior = cfg.get_val("osd_msgr_shm_ring")
        cfg.set_val("osd_msgr_shm_ring", shm)
        cuda_gf.reset_launches()
        t0 = time.perf_counter()
        try:
            with wire_bench.python_wire_codec():
                r = _in_new_loop(wire_bench._one_cycle(
                    ec, km, payloads, WRITERS, cork=True, keyring=keyring))
        finally:
            cfg.set_val("osd_msgr_shm_ring", prior)
        launches = _w8_launches()
        seconds = time.perf_counter() - t0
        got = r.pop("_shards")
        assert launches > 0, f"wire path (b) {label}: gf2_matrix_w8 idle"
        assert got == {key: shards[key] for key in got} and \
            len(got) == WIRE_SIDE_OBJECTS * km, \
            f"wire path (b) {label}: stored shards differ from (a)'s"
        c = r["counters"]
        if shm:
            assert c["ring_conns"] > 0, c
        print(f"[wire] (b) {label} corked cycle, {WIRE_SIDE_OBJECTS} x "
              f"{OBJECT} B: write {r['write_MiBs'] / 1024:.4f} GiB/s, read "
              f"{r['read_MiBs'] / 1024:.4f} GiB/s; {len(got)} shards equal "
              f"(a)'s; {_wire_counters(c)}; gf2_matrix_w8 launches "
              f"{launches}; {seconds:.1f} s; card {card}", flush=True)
        out[label] = {key: r[key] for key in (
            "wall_write_s", "wall_read_s", "write_MiBs", "read_MiBs",
            "counters", "steady_library_builds")}
        out[label].update(launches=launches, seconds=seconds)
    return out


def _wire_mesh_path(ec, ref, card: str) -> dict:
    """``run_mesh_path_bench`` at k=8 m=4 (docstring, phase 3j c)."""
    devices, layout = _mesh_devices(max(WIRE_MESH_SIZES))
    parallel.configure_devices(devices)
    cuda_gf.reset_launches()
    t0 = time.perf_counter()
    try:
        r = mesh_bench.run_mesh_path_bench(
            n_objects=WIRE_MESH_OBJECTS, obj_bytes=OBJECT, writers=WRITERS,
            mesh_sizes=WIRE_MESH_SIZES, iters=1, k=K, m=M,
            seed=WIRE_MESH_SEED, keep_shards=True)
    finally:
        mesh_plane.reset()
        parallel.configure_devices(None)
    launches = _w8_launches()
    seconds = time.perf_counter() - t0
    shards = r.pop("_shards")
    assert r["bit_exact"] is True and r["steady_library_builds"] == 0, r
    assert launches > 0, "wire path: gf2_matrix_w8 not launched in (c)"
    payloads = wire_bench.make_payloads(WIRE_MESH_OBJECTS, OBJECT,
                                        WIRE_MESH_SEED)
    t0 = time.perf_counter()
    check = _wire_numpy_check("wire path (c)", shards, payloads, ec, ref)
    check_s = time.perf_counter() - t0
    for name, res in r["results"].items():
        print(f"[wire] (c) mesh-path {name} ({layout}): write "
              f"{res['write_MiBs'] / 1024:.4f} GiB/s "
              f"({res['wall_write_s']} s), read {res['wall_read_s']} s, "
              f"wire bytes sent {res['wire_bytes_sent']}, avoided "
              f"{r['wire_bytes_avoided'][name]}, encode stage "
              f"{r['encode_GiBs'].get(name)} GiB/s; card {card}",
              flush=True)
    print(f"[wire] (c) mesh-path k={K} m={M}, {WIRE_MESH_OBJECTS} x {OBJECT} "
          f"B: speedup vs mesh_1 {json.dumps(r['speedup_vs_mesh1'])}, "
          f"tcp_only / mesh_max {r['tcp_only_vs_mesh_max']}; tcp_only "
          f"{check} ({check_s:.1f} s); gf2_matrix_w8 launches {launches}; "
          f"{seconds:.1f} s; card {card}", flush=True)
    r.update(launches=launches, seconds=seconds, layout=layout)
    return r


def _wire_mon_repair(card: str) -> dict:
    """A late mon reply on the card's cluster (docstring, phase 3j e)."""
    async def main():
        c = await ECCluster.create_with_mons(
            K + M, _profile({"technique": "reed_sol_van"}), n_mons=3,
            plugin="cuda")
        try:
            leader = await c.mons.wait_for_leader()
            epoch0 = leader.osdmap.epoch
            new_id = c.add_osd(update_placement=False)
            c.messenger.fault.schedule_send_hold(
                f"mon.{leader.rank}", WIRE_MON_HOLD_S,
                kind="mon_command_reply")
            t0 = time.perf_counter()
            rc, out = await c.monc.command(
                {"prefix": "osd add", "osd": new_id},
                timeout=WIRE_MON_WAIT_S)
            answer_s = time.perf_counter() - t0
            await asyncio.sleep(WIRE_MON_HOLD_S)
            maps = [mon.osdmap for mon in c.mons.mons]
            return {"rc": rc, "out": out, "osd": new_id,
                    "answer_s": answer_s,
                    "held": c.messenger.fault.send_holds,
                    "epochs": [mp.epoch - epoch0 for mp in maps],
                    "holds": [sorted(mp.up).count(new_id) for mp in maps],
                    "epoch": leader.osdmap.epoch}
        finally:
            await c.shutdown()

    r = _in_new_loop(main())
    assert r["held"] == 1 and r["rc"] == 0 and \
        r["out"] == {"epoch": r["epoch"]}, r
    assert r["holds"] == [1, 1, 1] and r["epochs"] == [1, 1, 1], r
    print(f"[wire] (e) mon repair: leader's reply to 'osd add "
          f"{r['osd']}' held {WIRE_MON_HOLD_S} s past the client's "
          f"{WIRE_MON_WAIT_S} s wait; the command answered rc {r['rc']} "
          f"{json.dumps(r['out'])} after {r['answer_s']:.3f} s; every mon's "
          f"osdmap holds osd.{r['osd']} once (epoch +1); card {card}",
          flush=True)
    return r


def phase_wire(card: str) -> dict:
    """The TCP messenger on the card (docstring, phase 3j)."""
    t_phase = time.perf_counter()
    ec = registry_mod.instance().factory(
        "cuda", _profile({"technique": "reed_sol_van"}))
    ref = registry_mod.instance().factory(
        "jerasure", _profile({"technique": "reed_sol_van"}))
    out = {}
    # every TCP path of this phase on the Python codec, as first measured
    # (phase 3k runs the native one beside it)
    with wire_bench.python_wire_codec():
        a = _wire_cluster_path(ec, ref, card)
        shards = a.pop("_shards")
        out["cluster_path"] = a
        out["side"] = _wire_side_cycles(ec, shards, card)
        del shards
        gc.collect()
        out["mesh_path"] = _wire_mesh_path(ec, ref, card)
        gc.collect()
    out["mon_repair"] = _wire_mon_repair(card)
    out["launches"] = {"cluster_path": a["launches"],
                       **{f"{label}_cycle": r["launches"]
                          for label, r in out["side"].items()},
                       "mesh_path": out["mesh_path"]["launches"]}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[wire] phase {out['seconds']:.1f} s; gf2_matrix_w8 launches "
          f"per step {json.dumps(out['launches'])}; card {card}", flush=True)
    return out


def _native_corpus(card: str) -> dict:
    """The codec corpus on the card machine's host (docstring, phase 3k
    a): the fuzzer's seeded corpus through both codecs, and bursts sealed
    in one C call against the Python codec's entry frames."""
    from ceph_tpu_torch.msg import tcp
    from ceph_tpu_torch.native import wire_codec
    from ceph_tpu_torch.tools import wire_fuzz

    t0 = time.perf_counter()
    report = wire_fuzz.run_fuzz(cases=NATIVE_CORPUS_CASES, seed=11,
                                mutations=4, leak_passes=3, ring_cases=50)
    assert report["ok"], report["divergences"][:3]
    addr = {"osd.0": ("127.0.0.1", 1)}
    nat = tcp.TCPMessenger("osd.0", addr)
    with wire_bench.python_wire_codec():
        py = tcp.TCPMessenger("osd.0", addr)
    assert nat._native is wire_codec.native() and py._native is None
    msgs = wire_fuzz.corpus(seed=12, n=NATIVE_SEAL_MESSAGES)
    sealed = 0
    for start in range(0, len(msgs), NATIVE_SEAL_BURST):
        batch = list(enumerate(msgs[start:start + NATIVE_SEAL_BURST],
                               start + 1))
        ne = [nat._msg_entry("osd.0", "osd.1", i, m) for i, m in batch]
        pe = [py._msg_entry("osd.0", "osd.1", i, m) for i, m in batch]
        ack = start + 7
        bufs, nbytes = nat._native.seal_frames(ne, ack)
        got = b"".join(bytes(b) for b in bufs)
        want = b"".join(bytes(b) for j, e in enumerate(pe)
                        for b in py._entry_frames(
                            e, None, ack if j == len(pe) - 1 else 0))
        assert got == want and nbytes == len(want), \
            f"native wire (a): sealed burst at {start} differs"
        sealed += nbytes
    seconds = time.perf_counter() - t0
    print(f"[native_wire] (a) codec corpus: {report['cases']} messages, "
          f"{report['mutants']} mutants, {report['fallbacks']} Python "
          f"fallbacks, 0 divergences (bodies byte-identical, decodes "
          f"equal), leak gate flat, {report['ring']['cases']} ring cases; "
          f"{NATIVE_SEAL_MESSAGES} messages sealed in bursts of "
          f"{NATIVE_SEAL_BURST}, {sealed} B byte-identical to the Python "
          f"codec's frames; codec {wire_codec.native().__file__}; "
          f"{seconds:.1f} s; host of card {card}", flush=True)
    return {"cases": report["cases"], "mutants": report["mutants"],
            "fallbacks": report["fallbacks"], "sealed_bytes": sealed,
            "seconds": seconds}


def _native_cluster_path(ec, ref, card: str) -> dict:
    """``run_cluster_path_bench`` on each codec (docstring, phase 3k b)."""
    out, shards = {}, {}
    for codec in ("python", "native"):
        ctx = wire_bench.python_wire_codec() if codec == "python" \
            else contextlib.nullcontext()
        cuda_gf.reset_launches()
        t0 = time.perf_counter()
        with ctx:
            r = wire_bench.run_cluster_path_bench(
                ec, n_objects=WIRE_OBJECTS, obj_bytes=OBJECT,
                writers=WRITERS, iters=1, seed=WIRE_SEED, keep_shards=True)
        launches = _w8_launches()
        r.update(launches=launches, seconds=time.perf_counter() - t0)
        shards[codec] = r.pop("_shards")
        assert r["bit_exact"] is True and r["wire_codec"] == codec, r
        assert r["steady_library_builds"] == 0 and launches > 0, r
        for mode in ("per_message", "corked"):
            res = r[mode]["residency"]["write"]
            assert res["h2d_per_granule"] is not None and \
                res["h2d_per_granule"] <= 1, (codec, mode, res)
        out[codec] = r
    assert shards["native"] == shards["python"], \
        "native wire (b): the native codec's stored shards differ from " \
        "the Python codec's"
    payloads = wire_bench.make_payloads(WIRE_OBJECTS, OBJECT, WIRE_SEED)
    check = _wire_numpy_check("native wire (b)", shards["native"], payloads,
                              ec, ref)
    head = (f"[native_wire] (b) cluster-path: {K + M} OSDs on TCP, "
            f"{WIRE_OBJECTS} x {OBJECT} B objects, {WRITERS} writers")
    for mode in ("per_message", "corked"):
        py, na = out["python"][mode], out["native"][mode]
        print(f"{head}, {mode}: write GiB/s python "
              f"{py['write_MiBs'] / 1024:.4f} / native "
              f"{na['write_MiBs'] / 1024:.4f}, read GiB/s python "
              f"{py['read_MiBs'] / 1024:.4f} / native "
              f"{na['read_MiBs'] / 1024:.4f}; h2d_per_granule "
              f"{na['residency']['write']['h2d_per_granule']}, library "
              f"builds {na['steady_library_builds']}; native "
              f"{_wire_counters(na['counters'])}; card {card}", flush=True)
    for codec in ("python", "native"):
        r = out[codec]
        print(f"{head}, {codec} codec: write speedup {r['write_speedup']}, "
              f"read speedup {r['read_speedup']}, wire stage "
              f"{r['wire_write_speedup']} "
              f"({r['wire_corked']['msgs_per_s']} msgs/s corked); "
              f"gf2_matrix_w8 launches {r['launches']}; "
              f"{r['seconds']:.1f} s; card {card}", flush=True)
    print(f"{head}: native shards == python shards; {check}; card {card}",
          flush=True)
    return out


def _native_wire_tax(card: str) -> dict:
    """``-w wire-tax`` at the JAX package's full shape (docstring, phase
    3k c)."""
    from ceph_tpu_torch.native import wire_codec
    from ceph_tpu_torch.profiling import ledger
    from ceph_tpu_torch.profiling.wire_tax_bench import run_wire_tax_bench

    print(f"[native_wire] (c) wire codec {json.dumps(wire_codec.status())}"
          f", stage markers {ledger.marker_class().__module__}."
          f"{ledger.marker_class().__name__}", flush=True)
    cuda_gf.reset_launches()
    t0 = time.perf_counter()
    r = run_wire_tax_bench(**WIRE_TAX_SHAPE, **WIRE_TAX_LIMITS)
    launches = _w8_launches()
    seconds = time.perf_counter() - t0
    assert launches > 0, "native wire (c): gf2_matrix_w8 not launched"
    assert r["wire_codec_frame_bytes_identical"] is True and \
        r["osd_exec_shard_bytes_identical"] is True and \
        r["ring_shard_bytes_identical"] is True, r
    top = ", ".join(f"{row['stage']} {row['pct']}%"
                    for row in r["wire_tax_top"])
    # each figure beside its default gate: "held" or "missed"
    figures = {"coverage_min_pct": r["wire_tax_coverage_pct"],
               "overhead_limit_pct": r["wire_tax_overhead_pct_enabled"],
               "codec_gain_min": r["wire_codec_gain"],
               "codec_share_ratio_max": r["wire_codec_share_ratio"],
               "osd_share_ratio_max": r["osd_exec_share_ratio"],
               "ring_gain_min": r["ring_gain"]}
    gates = {}
    for key, limit in WIRE_TAX_GATES.items():
        above = key.endswith("_min") or key.endswith("_min_pct")
        held = figures[key] >= limit if above else figures[key] <= limit
        gates[key] = {"figure": figures[key], "gate": limit,
                      "run_at": WIRE_TAX_LIMITS.get(key, limit),
                      "held": held}
    print(f"[native_wire] (c) gates at the JAX package's defaults: "
          + "; ".join(f"{k} {g['figure']} vs {g['gate']} "
                      f"{'held' if g['held'] else 'MISSED'} (run at "
                      f"{g['run_at']})" for k, g in gates.items())
          + f"; card {card}", flush=True)
    print(f"[native_wire] (c) wire-tax {WIRE_TAX_SHAPE['n_objects']} x "
          f"{WIRE_TAX_SHAPE['obj_bytes']} B, {WIRE_TAX_SHAPE['writers']} "
          f"writers, k=4 m=2 on cuda: {r['wire_tax_ops_per_sec']} ops/s, "
          f"coverage {r['wire_tax_coverage_pct']}% (gate "
          f"{r['coverage_min_pct']}), enabled overhead "
          f"{r['wire_tax_overhead_pct_enabled']}% (gate "
          f"{r['overhead_limit_pct']}, {r['overhead_attempts']} attempts), "
          f"off allocs {r['wire_tax_alloc_blocks_off']}; codec A/B "
          f"python {r['wire_codec_python_ops_per_sec']} -> native "
          f"{r['wire_codec_native_ops_per_sec']} ops/s (gain "
          f"{r['wire_codec_gain']}, gate 1.5), serialization share "
          f"{r['wire_codec_serialization_share_python_pct']}% -> "
          f"{r['wire_codec_serialization_share_native_pct']}% (ratio "
          f"{r['wire_codec_share_ratio']}, gate 0.5); OSD-exec share ratio "
          f"{r['osd_exec_share_ratio']} (gate 0.6), batch gain "
          f"{r['osd_batch_gain']}; ring {r['ring_ops_per_sec']} vs tcp "
          f"{r['tcp_ops_per_sec']} ops/s (gain {r['ring_gain']}, gate "
          f"0.85), frame send ns ring {r['ring_frame_send_ns']} / tcp "
          f"{r['tcp_frame_send_ns']}; speedscope profiles "
          f"{r['sampler']['speedscope_profiles']}; top: {top}; "
          f"gf2_matrix_w8 launches {launches}; {seconds:.1f} s; card "
          f"{card}", flush=True)
    r.pop("decomposition")
    r.update(launches=launches, seconds=seconds, gates=gates)
    return r


def _native_trace_path(card: str) -> dict:
    """``-w trace-path`` at the JAX package's defaults (docstring, phase
    3k d)."""
    from ceph_tpu_torch.osd.trace_bench import run_trace_overhead_bench

    ec = registry_mod.instance().factory("cuda", dict(WIRE_TAX_PROFILE))
    cuda_gf.reset_launches()
    t0 = time.perf_counter()
    r = run_trace_overhead_bench(ec, **TRACE_SHAPE,
                                 overhead_limit_pct=TRACE_LIMIT_PCT)
    launches = _w8_launches()
    seconds = time.perf_counter() - t0
    assert launches > 0, "native wire (d): gf2_matrix_w8 not launched"
    assert r["unfinished_spans"] == 0 and r["slow_ops_detected"] > 0 and \
        r["stitched"]["batch_encode_amortized_over"], r
    sampled = r["trace_overhead_pct_sampled"]
    held = sampled <= TRACE_GATE_PCT
    print(f"[native_wire] (d) gate at the JAX package's default: sampled "
          f"overhead {sampled} vs {TRACE_GATE_PCT} "
          f"{'held' if held else 'MISSED'} (run at {TRACE_LIMIT_PCT}); "
          f"card {card}", flush=True)
    modes = "; ".join(
        f"{m} storage {v['storage_MiBs']} / cluster {v['cluster_MiBs']} "
        f"MiB/s" for m, v in r["modes"].items())
    print(f"[native_wire] (d) trace-path {TRACE_SHAPE['n_objects']} x "
          f"{TRACE_SHAPE['obj_bytes']} B, {TRACE_SHAPE['writers']} "
          f"writers, k=4 m=2 on cuda: sampled overhead "
          f"{r['trace_overhead_pct_sampled']}% (gate "
          f"{r['overhead_limit_pct']}, {r['attempts']} attempts), full "
          f"{r['trace_overhead_pct_full']}%; {modes}; stitched "
          f"{r['stitched']['spans']} spans, {r['stitched']['sub_writes']} "
          f"sub-writes, batch_encode over "
          f"{r['stitched']['batch_encode_amortized_over']}, timeline "
          f"{r['stitched']['timeline_segment_sum_ms']} of "
          f"{r['stitched']['timeline_total_ms']} ms; slow ops "
          f"{r['slow_ops_detected']}; gf2_matrix_w8 launches {launches}; "
          f"{seconds:.1f} s; card {card}", flush=True)
    r.update(launches=launches, seconds=seconds, gates={
        "overhead_limit_pct": {"figure": sampled, "gate": TRACE_GATE_PCT,
                               "run_at": TRACE_LIMIT_PCT, "held": held}})
    return r


def phase_native_wire(card: str) -> dict:
    """The native wire codec on the card (docstring, phase 3k)."""
    t_phase = time.perf_counter()
    ec = registry_mod.instance().factory(
        "cuda", _profile({"technique": "reed_sol_van"}))
    ref = registry_mod.instance().factory(
        "jerasure", _profile({"technique": "reed_sol_van"}))
    out = {"corpus": _native_corpus(card)}
    out["cluster_path"] = _native_cluster_path(ec, ref, card)
    gc.collect()
    out["wire_tax"] = _native_wire_tax(card)
    gc.collect()
    out["trace_path"] = _native_trace_path(card)
    out["launches"] = {
        "cluster_path_python": out["cluster_path"]["python"]["launches"],
        "cluster_path_native": out["cluster_path"]["native"]["launches"],
        "wire_tax": out["wire_tax"]["launches"],
        "trace_path": out["trace_path"]["launches"]}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[native_wire] phase {out['seconds']:.1f} s; gf2_matrix_w8 "
          f"launches per step {json.dumps(out['launches'])}; card {card}",
          flush=True)
    return out


def _striped_objects(data: bytes, layout) -> dict:
    """Each stripe object's bytes of a file written whole from 0."""
    from ceph_tpu_torch.osdc.striper import Striper

    objs: dict = {}
    pos = 0
    for object_no, off, length in Striper(layout).map_extent(0, len(data)):
        buf = objs.setdefault(object_no, bytearray())
        if len(buf) < off + length:
            buf.extend(bytes(off + length - len(buf)))
        buf[off:off + length] = data[pos:pos + length]
        pos += length
    return {n: bytes(b) for n, b in objs.items()}


def phase_osdc(seed: int, card: str) -> dict:
    """The client libraries over the EC pool on the card (docstring,
    phase 3l); ``gf2_matrix_w8``'s launches are zeroed before and read
    after every step."""
    from ceph_tpu_torch.osdc.journaler import Journaler
    from ceph_tpu_torch.osdc.kv_store import KvStore
    from ceph_tpu_torch.osdc.object_cacher import ObjectCacher
    from ceph_tpu_torch.osdc.rados_striper import RadosStriper

    t_phase = time.perf_counter()
    ref = registry_mod.instance().factory(
        "jerasure", _profile({"technique": "reed_sol_van"}))
    rs = np.random.RandomState(seed + 22)
    data = rs.randint(0, 256, OSDC_FILE, dtype=np.uint8).tobytes()
    launches, seconds, out = {}, {}, {}

    def step(name, t0):
        launches[name] = _w8_launches()
        seconds[name] = time.perf_counter() - t0
        cuda_gf.reset_launches()
        return time.perf_counter()

    async def main():
        c = ECCluster(OSDC_OSDS, _profile({"technique": "reed_sol_van"}),
                      plugin="cuda")
        final = {}
        try:
            cuda_gf.reset_launches()
            t0 = time.perf_counter()
            striper = RadosStriper(c.backend)
            await striper.write("file", data)
            t0 = step("striper_write", t0)
            assert await striper.read("file") == data
            t0 = step("striper_read", t0)
            for off, length in OSDC_RANGES:
                assert await striper.read("file", length, off) == \
                    data[off:off + length], (off, length)
            t0 = step("striper_ranges", t0)
            objs = _striped_objects(data, striper.default_layout)
            down = [c.backend.acting_set(striper._obj("file", 0))[s]
                    for s in (1, 6)][:OSDC_DOWN]
            for osd in down:
                c.kill_osd(osd)
            assert await striper.read("file") == data
            for off, length in OSDC_RANGES:
                assert await striper.read("file", length, off) == \
                    data[off:off + length], ("degraded", off, length)
            t0 = step("striper_degraded_read", t0)
            for osd in down:
                c.revive_osd(osd)
            final.update({striper._obj("file", n): b
                          for n, b in objs.items()})
            out["striper"] = {"objects": len(objs), "stat":
                              await striper.stat("file"), "down": down}
            assert out["striper"]["stat"] == OSDC_FILE

            j = Journaler(c.backend, "mdlog",
                          object_size=OSDC_JOURNAL_OBJECT)
            await j.open()
            entries = [rs.randint(0, 256, OSDC_JOURNAL_ENTRY,
                                  dtype=np.uint8).tobytes()
                       for _ in range(OSDC_JOURNAL_ENTRIES)]
            starts = [await j.append({"n": i, "pad": e})
                      for i, e in enumerate(entries)]
            t0 = step("journal_append", t0)
            reader = Journaler(c.backend, "mdlog",
                               object_size=OSDC_JOURNAL_OBJECT)
            await reader.open()
            got = await reader.replay()
            assert [p for p, _e in got] == starts
            assert [e["pad"] for _p, e in got] == entries
            t0 = step("journal_replay", t0)
            await j.committed(starts[-1])
            trimmed = await j.trim()
            tail = await j.replay(starts[0])
            assert trimmed == starts[-1] // OSDC_JOURNAL_OBJECT >= 1 and \
                tail[-1][1]["n"] == OSDC_JOURNAL_ENTRIES - 1
            t0 = step("journal_commit_trim", t0)
            for objno in range(j.expire_pos // OSDC_JOURNAL_OBJECT,
                               (j.write_pos - 1) // OSDC_JOURNAL_OBJECT + 1):
                oid = j._data(objno)
                final[oid] = await c.backend.read(oid)
            out["journal"] = {"entries": len(entries), "trimmed": trimmed,
                              "write_pos": j.write_pos}

            oc = ObjectCacher(c.backend, max_bytes=OSDC_CACHE_BYTES,
                              write_back=True)
            per_obj = OBJECT // OSDC_CACHE_WRITE
            n_writes = OSDC_CACHE_WRITTEN // OSDC_CACHE_WRITE
            cache_data = {}
            for i in range(n_writes):
                oid = f"rbd_data.{i // per_obj:016x}"
                piece = data[i * OSDC_CACHE_WRITE:(i + 1) * OSDC_CACHE_WRITE]
                await oc.write(oid, (i % per_obj) * OSDC_CACHE_WRITE, piece)
                cache_data.setdefault(oid, []).append(piece)
            cache_data = {o: b"".join(p) for o, p in cache_data.items()}
            assert oc.cached_bytes <= OSDC_CACHE_BYTES
            t0 = step("cacher_write_back", t0)
            await oc.flush()
            t0 = step("cacher_flush", t0)
            await oc.invalidate()
            for oid, want in cache_data.items():
                assert await oc.read(oid, 0, OBJECT) == want, oid
            assert oc.misses == len(cache_data)
            t0 = step("cacher_read_through", t0)
            final.update(cache_data)
            out["cacher"] = {"objects": len(cache_data), "hits": oc.hits,
                             "misses": oc.misses}

            kv = KvStore(c.backend, "kv")
            keys = [f"key{i:08d}" for i in rs.permutation(OSDC_KV_KEYS)]
            values = {k: rs.randint(0, 256, 24, dtype=np.uint8).tobytes()
                      for k in keys}
            for k in keys:
                await kv.set(k, values[k])
            t0 = step("kv_set", t0)
            items = await kv.items()
            assert items == sorted(values.items())
            for k in keys[:256]:
                assert await kv.get(k) == values[k]
            out["kv"] = await kv.stats()
            del out["kv"]["per_bucket"]
            assert out["kv"]["entries"] == OSDC_KV_KEYS
            t0 = step("kv_scan_get", t0)
            check = _cluster_check(c, ref, final, crc=False)
            step("check", t0)
            return check
        finally:
            await c.shutdown()

    check = _in_new_loop(main())
    for name in ("striper_write", "striper_degraded_read", "journal_append",
                 "cacher_write_back", "cacher_flush"):
        assert launches[name] > 0, f"osdc: gf2_matrix_w8 idle in {name}"
    out.update(launches=launches, step_seconds=seconds, check=check)
    out["seconds"] = time.perf_counter() - t_phase
    gib = OSDC_FILE / 2**30
    print(f"[osdc] RadosStriper ({out['striper']['objects']} objects of "
          f"4 MiB, stripe unit 512 KiB, count 4): {OSDC_FILE} B file write "
          f"{gib / seconds['striper_write']:.4f} GiB/s, read "
          f"{gib / seconds['striper_read']:.4f} GiB/s, {len(OSDC_RANGES)} "
          f"ranges {seconds['striper_ranges']:.2f} s, whole and ranges "
          f"with osd {out['striper']['down']} down "
          f"{seconds['striper_degraded_read']:.2f} s; card {card}",
          flush=True)
    print(f"[osdc] Journaler: {OSDC_JOURNAL_ENTRIES} entries of "
          f"{OSDC_JOURNAL_ENTRY} B appended in "
          f"{seconds['journal_append']:.2f} s, replayed in "
          f"{seconds['journal_replay']:.2f} s, committed and "
          f"{out['journal']['trimmed']} object(s) trimmed; ObjectCacher "
          f"write-back ({OSDC_CACHE_BYTES} B budget): {OSDC_CACHE_WRITTEN} "
          f"B of {OSDC_CACHE_WRITE} B writes in "
          f"{seconds['cacher_write_back']:.2f} s, flush "
          f"{seconds['cacher_flush']:.2f} s, read-through "
          f"{seconds['cacher_read_through']:.2f} s; KvStore "
          f"{OSDC_KV_KEYS} keys in {seconds['kv_set']:.2f} s "
          f"({out['kv']['buckets']} buckets), scan + 256 gets "
          f"{seconds['kv_scan_get']:.2f} s; card {card}", flush=True)
    print(f"[osdc] {check} ({seconds['check']:.1f} s); gf2_matrix_w8 "
          f"launches per step {json.dumps(launches)}; phase "
          f"{out['seconds']:.1f} s; card {card}", flush=True)
    return out


class _Steps:
    """Seconds and ``gf2_matrix_w8`` launches per step of phase 3m: the
    counts are zeroed when a step starts and read when it ends."""

    def __init__(self):
        self.seconds, self.launches = {}, {}
        self._t0 = 0.0

    def start(self) -> None:
        cuda_gf.reset_launches()
        self._t0 = time.perf_counter()

    def end(self, name: str) -> float:
        self.launches[name] = _w8_launches()
        self.seconds[name] = time.perf_counter() - self._t0
        return self.seconds[name]

    def rose(self, label: str, names) -> None:
        for name in names:
            assert self.launches[name] > 0, \
                f"services {label}: gf2_matrix_w8 idle in {name}"


def _svc_cluster(n_osds: int, profile: dict) -> ECCluster:
    return ECCluster(n_osds, dict(profile, technique="reed_sol_van"),
                     plugin="cuda")


def _svc_ref(profile: dict):
    return registry_mod.instance().factory(
        "jerasure", dict(profile, technique="reed_sol_van"))


def _svc_down(cluster, oid: str) -> list:
    """The OSDs of data shards ``SVC_DOWN`` of ``oid``'s acting set."""
    acting = cluster.backend.acting_set(oid)
    return [acting[s] for s in SVC_DOWN]


def _rate(n_bytes: int, seconds: float) -> str:
    return f"{n_bytes / 2**30 / seconds:.4f} GiB/s"


def _ops(n: int, seconds: float) -> str:
    return f"{n / seconds:.1f} ops/s"


def _objects_of(model: bytes, prefix: str, object_size: int,
                numbers) -> dict:
    """Data objects ``<prefix><n:016x>`` of an image model."""
    return {f"{prefix}{n:016x}": bytes(
        model[n * object_size:(n + 1) * object_size]) for n in numbers}


async def _read_image(img, size: int) -> bytes:
    """An image read whole in 4 MiB requests."""
    return b"".join([await img.read(off, OBJECT)
                     for off in range(0, size, OBJECT)])


def _svc_rbd(seed: int, card: str) -> dict:
    """(a) RBD: fill, 4 KiB random writes, snapshot, clone and copy-up,
    whole reads against a numpy model, fast-diff, degraded read."""
    from ceph_tpu_torch.rbd import (FEATURE_FAST_DIFF, FEATURE_OBJECT_MAP,
                                    RBD, Image)
    from ceph_tpu_torch.rbd.objectmap import (OBJECT_EXISTS,
                                              OBJECT_EXISTS_CLEAN, map_oid)

    rs = np.random.RandomState(seed + 30)
    steps = _Steps()
    n_objects = SVC_IMAGE // OBJECT
    filled = SVC_FILLED // OBJECT
    out = {}

    def random_writes(n):
        offs = rs.randint(0, SVC_FILLED // SVC_IO, n) * SVC_IO
        return [(int(o), rs.randint(0, 256, SVC_IO, dtype=np.uint8)
                 .tobytes()) for o in offs]

    async def main():
        c = _svc_cluster(SVC_OSDS, _profile({}))
        try:
            await RBD(c.backend).create(
                "vol", SVC_IMAGE, order=SVC_ORDER,
                features=[FEATURE_OBJECT_MAP, FEATURE_FAST_DIFF])
            img = await Image.open(c.backend, "vol")
            model = bytearray(SVC_IMAGE)
            fill = rs.randint(0, 256, SVC_FILLED, dtype=np.uint8).tobytes()
            steps.start()
            for off in range(0, SVC_FILLED, OBJECT):
                await img.write(off, fill[off:off + OBJECT])
            steps.end("fill")
            model[:SVC_FILLED] = fill
            writes = random_writes(SVC_RANDOM_WRITES)
            steps.start()
            for off, piece in writes:
                await img.write(off, piece)
            steps.end("random_4k")
            for off, piece in writes:
                model[off:off + SVC_IO] = piece
            await img.snap_create("s1")
            snap_model = bytes(model)
            after = random_writes(SVC_SNAP_WRITES)
            steps.start()
            for off, piece in after:
                await img.write(off, piece)
            steps.end("post_snap_4k")
            for off, piece in after:
                model[off:off + SVC_IO] = piece
            touched = sorted({off // OBJECT for off, _p in after})
            await img.snap_protect("s1")
            await RBD(c.backend).clone("vol", "s1", "child")
            child = await Image.open(c.backend, "child")
            child_model = bytearray(snap_model)
            blocks = rs.permutation(filled)[:SVC_CHILD_WRITES]
            child_writes = [(int(b) * OBJECT + int(rs.randint(
                0, OBJECT // SVC_IO)) * SVC_IO, rs.randint(
                    0, 256, SVC_IO, dtype=np.uint8).tobytes())
                for b in blocks]
            steps.start()
            for off, piece in child_writes:
                await child.write(off, piece)
            steps.end("child_copyup_4k")
            for off, piece in child_writes:
                child_model[off:off + SVC_IO] = piece
            steps.start()
            assert await _read_image(img, SVC_IMAGE) == model, "rbd: head"
            steps.end("read_head")
            snap = await Image.open(c.backend, "vol", snap="s1")
            steps.start()
            assert await _read_image(snap, SVC_IMAGE) == snap_model, \
                "rbd: s1"
            steps.end("read_s1")
            steps.start()
            assert await _read_image(child, SVC_IMAGE) == child_model, \
                "rbd: child"
            steps.end("read_child")
            diff = await img.diff("s1")
            assert [(off // OBJECT, length, ex) for off, length, ex
                    in diff] == [(o, OBJECT, True) for o in touched], \
                "rbd: fast_diff(s1 -> head) is not the model's objects"
            head_map = bytearray(n_objects)
            head_map[:filled] = bytes([OBJECT_EXISTS_CLEAN]) * filled
            for o in touched:
                head_map[o] = OBJECT_EXISTS
            assert img.object_map_states() == bytes(head_map)
            snap_map = bytes([OBJECT_EXISTS]) * filled + \
                bytes(n_objects - filled)
            down = _svc_down(c, "rbd_data.vol.0000000000000000")
            for osd in down:
                c.kill_osd(osd)
            steps.start()
            assert await _read_image(img, SVC_FILLED) == \
                model[:SVC_FILLED], "rbd: degraded head"
            steps.end("degraded_read")
            for osd in down:
                c.revive_osd(osd)
            final = _objects_of(model, "rbd_data.vol.", OBJECT,
                                range(filled))
            final.update(_objects_of(child_model, "rbd_data.child.", OBJECT,
                                     sorted(int(b) for b in blocks)))
            final[map_oid("vol")] = bytes(head_map)
            final[map_oid("vol", snap.read_snap_id)] = snap_map
            t0 = time.perf_counter()
            out["check"] = _cluster_check(c, _svc_ref(_profile({})), final,
                                          crc=False)
            out["check_s"] = time.perf_counter() - t0
            out.update(diff_objects=len(touched), down=down,
                       child_blocks=len(blocks))
        finally:
            await c.shutdown()

    _in_new_loop(main())
    steps.rose("rbd", ("fill", "random_4k", "post_snap_4k",
                       "child_copyup_4k", "degraded_read"))
    s = steps.seconds
    print(f"[services] (a) RBD {SVC_IMAGE >> 20} MiB image, order "
          f"{SVC_ORDER}, object-map + fast-diff: fill {SVC_FILLED >> 20} MiB "
          f"in 4 MiB writes {_rate(SVC_FILLED, s['fill'])}; "
          f"{SVC_RANDOM_WRITES} x 4 KiB random writes "
          f"{_ops(SVC_RANDOM_WRITES, s['random_4k'])}; {SVC_SNAP_WRITES} "
          f"after s1 {_ops(SVC_SNAP_WRITES, s['post_snap_4k'])}; "
          f"{SVC_CHILD_WRITES} child copy-ups "
          f"{_ops(SVC_CHILD_WRITES, s['child_copyup_4k'])}; whole reads "
          f"head {_rate(SVC_IMAGE, s['read_head'])}, s1 "
          f"{_rate(SVC_IMAGE, s['read_s1'])}, child "
          f"{_rate(SVC_IMAGE, s['read_child'])}; fast_diff "
          f"{out['diff_objects']} objects == model; degraded head read "
          f"(osd {out['down']} down) "
          f"{_rate(SVC_FILLED, s['degraded_read'])} over the written "
          f"{SVC_FILLED >> 20} MiB"
          f"; {out['check']} ({out['check_s']:.1f} s); launches "
          f"{json.dumps(steps.launches)}; card {card}", flush=True)
    out.update(seconds=s, launches=steps.launches)
    return out


def _svc_mirror(seed: int, card: str) -> dict:
    """(b) A journaled image mirrored into a k=4 m=2 cluster, then
    failed over and mirrored back."""
    from ceph_tpu_torch.rbd import (FEATURE_JOURNALING, RBD, Image,
                                    MirrorDaemon, mirror_demote,
                                    mirror_enable, mirror_promote)

    rs = np.random.RandomState(seed + 31)
    steps = _Steps()
    n_objects = SVC_JOURNAL_IMAGE // OBJECT
    out = {}

    def small_writes(n):
        offs = rs.randint(0, SVC_JOURNAL_IMAGE // SVC_IO, n) * SVC_IO
        return [(int(o), rs.randint(0, 256, SVC_IO, dtype=np.uint8)
                 .tobytes()) for o in offs]

    async def main():
        a = _svc_cluster(SVC_OSDS, _profile({}))
        try:
            b = _svc_cluster(SVC_PEER_OSDS, SVC_PEER_PROFILE)
            try:
                await RBD(a.backend).create("jvol", SVC_JOURNAL_IMAGE,
                                            order=SVC_ORDER,
                                            features=[FEATURE_JOURNALING])
                img = await Image.open(a.backend, "jvol")
                model = bytearray(rs.randint(0, 256, SVC_JOURNAL_IMAGE,
                                             dtype=np.uint8).tobytes())
                steps.start()
                for off in range(0, SVC_JOURNAL_IMAGE, OBJECT):
                    await img.write(off, bytes(model[off:off + OBJECT]))
                steps.end("journaled_fill")
                writes = small_writes(SVC_JOURNAL_WRITES)
                steps.start()
                for off, piece in writes:
                    await img.write(off, piece)
                steps.end("journaled_4k")
                for off, piece in writes:
                    model[off:off + SVC_IO] = piece
                await mirror_enable(a.backend, "jvol")
                daemon = MirrorDaemon(a.backend, b.backend)
                steps.start()
                out["bootstrap"] = await daemon.run_once()
                steps.end("bootstrap")
                more = small_writes(SVC_JOURNAL_WRITES)
                for off, piece in more:
                    await img.write(off, piece)
                    model[off:off + SVC_IO] = piece
                steps.start()
                out["replayed"] = await daemon.run_once()
                steps.end("replay")
                assert out["replayed"] == {"jvol": SVC_JOURNAL_WRITES}, out
                status = await daemon.status()
                assert status["jvol"] == {"state": "up+replaying",
                                          "entries_behind": 0}, status
                dst = await Image.open(b.backend, "jvol")
                assert await _read_image(dst, SVC_JOURNAL_IMAGE) == model, \
                    "mirror: destination head"
                await mirror_demote(a.backend, "jvol")
                await mirror_promote(b.backend, "jvol")
                dst = await Image.open(b.backend, "jvol")
                await dst.update_features(enable=[FEATURE_JOURNALING])
                dst = await Image.open(b.backend, "jvol")
                back = small_writes(SVC_FAILBACK_WRITES)
                steps.start()
                for off, piece in back:
                    await dst.write(off, piece)
                steps.end("failback_4k")
                for off, piece in back:
                    model[off:off + SVC_IO] = piece
                steps.start()
                out["mirrored_back"] = await MirrorDaemon(
                    b.backend, a.backend).run_once()
                steps.end("mirror_back")
                src = await Image.open(a.backend, "jvol")
                assert src._primary is False
                assert await _read_image(src, SVC_JOURNAL_IMAGE) == model, \
                    "mirror: failed-back source"
                final = _objects_of(model, "rbd_data.jvol.", OBJECT,
                                    range(n_objects))
                t0 = time.perf_counter()
                out["check"] = [
                    _cluster_check(a, _svc_ref(_profile({})), final,
                                   crc=False),
                    _cluster_check(b, _svc_ref(SVC_PEER_PROFILE), final,
                                   crc=False)]
                out["check_s"] = time.perf_counter() - t0
            finally:
                await b.shutdown()
        finally:
            await a.shutdown()

    _in_new_loop(main())
    steps.rose("mirror", ("journaled_fill", "journaled_4k", "bootstrap",
                          "replay", "failback_4k", "mirror_back"))
    s = steps.seconds
    print(f"[services] (b) journaled {SVC_JOURNAL_IMAGE >> 20} MiB image: "
          f"fill {_rate(SVC_JOURNAL_IMAGE, s['journaled_fill'])} (256 KiB "
          f"journal events); {SVC_JOURNAL_WRITES} x 4 KiB "
          f"{_ops(SVC_JOURNAL_WRITES, s['journaled_4k'])}; MirrorDaemon to "
          f"{SVC_PEER_OSDS} OSDs k=4 m=2: bootstrap {s['bootstrap']:.2f} s, "
          f"replay of {SVC_JOURNAL_WRITES} events {s['replay']:.2f} s; "
          f"failover, {SVC_FAILBACK_WRITES} x 4 KiB on the promoted copy, "
          f"mirrored back in {s['mirror_back']:.2f} s; {out['check']} "
          f"({out['check_s']:.1f} s); launches {json.dumps(steps.launches)}"
          f"; card {card}", flush=True)
    out.update(seconds=s, launches=steps.launches)
    return out


async def _nbd_client(port: int, export: str, model: bytearray,
                      rs) -> dict:
    """A fixed-newstyle NBD client: handshake, writes and reads of the
    whole image (``model``'s size) in ``SVC_NBD_REQUEST`` requests, FLUSH,
    TRIM, DISC;
    every reply must carry error 0.  Returns the seconds of each part."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    magic, opt_magic, flags = struct.unpack(">QQH",
                                            await reader.readexactly(18))
    assert (magic, opt_magic) == (0x4E42444D41474943,
                                  0x49484156454F5054) and flags & 1
    writer.write(struct.pack(">I", 2))  # NO_ZEROES
    writer.write(struct.pack(">QII", 0x49484156454F5054, 1, len(export))
                 + export.encode())
    await writer.drain()
    size, tflags = struct.unpack(">QH", await reader.readexactly(10))
    assert size == len(model) and tflags & (1 | 4 | 32) == 1 | 4 | 32
    handle = 0

    async def command(ctype, offset, length, payload=b""):
        nonlocal handle
        handle += 1
        writer.write(struct.pack(">IHHQQI", 0x25609513, 0, ctype, handle,
                                 offset, length) + payload)
        await writer.drain()
        if ctype == 2:
            return b""
        rmagic, err, got = struct.unpack(">IIQ",
                                         await reader.readexactly(16))
        assert (rmagic, err, got) == (0x67446698, 0, handle), \
            f"nbd: command {ctype} at {offset} answered error {err}"
        return await reader.readexactly(length) if ctype == 0 else b""

    seconds = {}
    t0 = time.perf_counter()
    for off in range(0, size, SVC_NBD_REQUEST):
        piece = rs.randint(0, 256, SVC_NBD_REQUEST, dtype=np.uint8).tobytes()
        await command(1, off, SVC_NBD_REQUEST, piece)
        model[off:off + SVC_NBD_REQUEST] = piece
    seconds["write"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for off in range(0, size, SVC_NBD_REQUEST):
        assert await command(0, off, SVC_NBD_REQUEST) == \
            model[off:off + SVC_NBD_REQUEST], f"nbd: read at {off}"
    seconds["read"] = time.perf_counter() - t0
    await command(3, 0, 0)
    trim = (size // 2 + 12345, 3 * SVC_NBD_REQUEST)
    t0 = time.perf_counter()
    await command(4, *trim)
    seconds["trim"] = time.perf_counter() - t0
    model[trim[0]:trim[0] + trim[1]] = bytes(trim[1])
    await command(2, 0, 0)
    assert await reader.read() == b"", "nbd: data after DISC"
    writer.close()
    return seconds


def _svc_nbd(seed: int, card: str) -> dict:
    """(c) NBDServer on a localhost socket, driven by ``_nbd_client``."""
    from ceph_tpu_torch.rbd import RBD, Image
    from ceph_tpu_torch.rbd.nbd import NBDServer

    rs = np.random.RandomState(seed + 32)
    steps = _Steps()
    out = {}

    async def main():
        c = _svc_cluster(SVC_OSDS, _profile({}))
        try:
            await RBD(c.backend).create("nbd0", SVC_NBD_BYTES,
                                        order=SVC_ORDER)
            srv = NBDServer(c.backend)
            port = await srv.start()
            try:
                model = bytearray(SVC_NBD_BYTES)
                steps.start()
                out["client_s"] = await _nbd_client(port, "nbd0", model, rs)
                steps.end("nbd")
                assert srv.stats == {
                    "write": SVC_NBD_BYTES // SVC_NBD_REQUEST,
                    "read": SVC_NBD_BYTES // SVC_NBD_REQUEST, "flush": 1,
                    "trim": 1, "disc": 1}, srv.stats
                img = await Image.open(c.backend, "nbd0")
                got = await _read_image(img, SVC_NBD_BYTES)
                assert got == model, "nbd: image bytes differ from the client"
                t0 = time.perf_counter()
                out["check"] = _cluster_check(
                    c, _svc_ref(_profile({})),
                    _objects_of(model, "rbd_data.nbd0.", OBJECT,
                                range(SVC_NBD_BYTES // OBJECT)), crc=False)
                out["check_s"] = time.perf_counter() - t0
            finally:
                await srv.stop()
        finally:
            await c.shutdown()

    _in_new_loop(main())
    steps.rose("nbd", ("nbd",))
    cs = out["client_s"]
    n = SVC_NBD_BYTES // SVC_NBD_REQUEST
    print(f"[services] (c) NBD export of {SVC_NBD_BYTES >> 20} MiB: {n} "
          f"writes of {SVC_NBD_REQUEST >> 10} KiB "
          f"{_rate(SVC_NBD_BYTES, cs['write'])}"
          f" ({_ops(n, cs['write'])}), {n} reads "
          f"{_rate(SVC_NBD_BYTES, cs['read'])}, TRIM {cs['trim']:.3f} s, "
          f"FLUSH, DISC; {out['check']} ({out['check_s']:.1f} s); launches "
          f"{json.dumps(steps.launches)}; card {card}", flush=True)
    out.update(seconds=steps.seconds, launches=steps.launches)
    return out


class _S3:
    """A SigV4 S3 client over one localhost HTTP/1.1 request a
    connection, signing with the current UTC time; every answer's status
    is checked."""

    def __init__(self, port: int):
        self.port = port
        self.requests = 0

    async def __call__(self, method, target, body=b"", want=200,
                       secret=SVC_RGW_SECRET):
        from ceph_tpu_torch.rgw import sign_v4

        path, _, query = target.partition("?")
        params = dict(kv.partition("=")[::2] for kv in query.split("&")
                      if kv)
        amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        payload_hash = hashlib.sha256(body).hexdigest()
        headers = {"host": "localhost", "x-amz-date": amz_date,
                   "x-amz-content-sha256": payload_hash}
        signed = ";".join(sorted(headers))
        sig = sign_v4(secret, method, path, params, headers, signed,
                      payload_hash, amz_date)
        cred = f"{SVC_RGW_ACCESS}/{amz_date[:8]}/default/s3/aws4_request"
        lines = [f"{method} {target} HTTP/1.1", "Host: localhost",
                 f"Content-Length: {len(body)}", f"x-amz-date: {amz_date}",
                 f"x-amz-content-sha256: {payload_hash}",
                 "Authorization: AWS4-HMAC-SHA256 Credential="
                 f"{cred}, SignedHeaders={signed}, Signature={sig}"]
        reader, writer = await asyncio.open_connection("127.0.0.1",
                                                       self.port)
        try:
            writer.write("\r\n".join(lines).encode() + b"\r\n\r\n" + body)
            await writer.drain()
            raw = await reader.read()
        finally:
            writer.close()
        head, _, payload = raw.partition(b"\r\n\r\n")
        status = int(head.split(b"\r\n", 1)[0].split()[1])
        hdrs = {}
        for line in head.decode().split("\r\n")[1:]:
            k, _, v = line.partition(":")
            hdrs[k.strip().lower()] = v.strip()
        self.requests += 1
        assert status == want, \
            f"rgw: {method} {target} answered {status}, not {want}: " \
            f"{payload[:300]!r}"
        return hdrs, payload


def _s3_error(payload: bytes, code: str) -> None:
    """An S3 error envelope (``<Error><Code>``) with ``code``."""
    assert payload.startswith(b'<?xml version="1.0" encoding="UTF-8"?>'
                              b"<Error><Code>" + code.encode()
                              + b"</Code><Message>"), payload[:200]


def _svc_rgw(seed: int, card: str) -> dict:
    """(e) RGWGateway with one SigV4 user: PUTs, GET / HEAD / listing /
    DELETE, a multipart upload, versions, error envelopes, degraded GETs
    and a sync into a second zone."""
    from ceph_tpu_torch.rgw import RGWGateway, RGWSyncAgent
    from ceph_tpu_torch.rgw.gateway import obj_oid, ver_obj_oid

    rs = np.random.RandomState(seed + 33)
    steps = _Steps()
    out = {}
    gone = "obj000"  # deleted after the listing

    async def zone(c, user):
        index = c.add_pool("rgw.index", pool_type="replicated", size=3)
        gw = RGWGateway(c.backend, index_backend=index)
        if user:
            await gw.create_user(SVC_RGW_ACCESS, SVC_RGW_SECRET, "smoke")
        return index, gw

    async def serve(a, a_index, gwa, b, b_index, gwb):
        s3a, s3b = _S3(await gwa.start()), _S3(await gwb.start())
        final = {}
        await s3a("PUT", "/bulk")
        bodies = {f"obj{i:03d}": rs.randint(
            0, 256, OBJECT, dtype=np.uint8).tobytes()
            for i in range(SVC_RGW_OBJECTS)}
        etags = {k: f'"{hashlib.md5(v).hexdigest()}"'
                 for k, v in bodies.items()}
        steps.start()
        for key, body in bodies.items():
            hdrs, _ = await s3a("PUT", f"/bulk/{key}", body)
            assert hdrs["etag"] == etags[key], key
        steps.end("put")
        steps.start()
        for key, body in bodies.items():
            hdrs, got = await s3a("GET", f"/bulk/{key}")
            assert got == body and hdrs["etag"] == etags[key], key
        steps.end("get")
        hdrs, got = await s3a("HEAD", "/bulk/obj001")
        assert got == b"" and hdrs["etag"] == etags["obj001"] and \
            int(hdrs["x-object-size"]) == OBJECT, hdrs
        _, listing = await s3a("GET", "/bulk?prefix=obj00")
        want = sorted(k for k in bodies if k.startswith("obj00"))
        assert re.findall(rb"<Key>([^<]*)</Key>", listing) == \
            [k.encode() for k in want], listing[:300]
        await s3a("DELETE", f"/bulk/{gone}", want=204)
        _s3_error((await s3a("GET", f"/bulk/{gone}", want=404))[1],
                  "NoSuchKey")
        _s3_error((await s3a("GET", "/nobucket/x", want=404))[1],
                  "NoSuchBucket")
        _s3_error((await s3a("GET", "/bulk/obj001", want=403,
                             secret="wrong"))[1], "SignatureDoesNotMatch")
        _s3_error((await s3a("DELETE", "/bulk", want=409))[1],
                  "BucketNotEmpty")
        del bodies[gone]
        final.update({obj_oid("bulk", k): v for k, v in bodies.items()})
        big = rs.randint(0, 256, SVC_RGW_MULTIPART, dtype=np.uint8).tobytes()
        n_parts = SVC_RGW_MULTIPART // SVC_RGW_PART
        steps.start()
        _, body = await s3a("POST", "/bulk/big.bin?uploads")
        upload = body.split(b"<UploadId>")[1].split(b"</UploadId>")[0] \
            .decode()
        md5s = b""
        for n in range(1, n_parts + 1):
            part = big[(n - 1) * SVC_RGW_PART:n * SVC_RGW_PART]
            hdrs, _ = await s3a(
                "PUT", f"/bulk/big.bin?partNumber={n}&uploadId={upload}",
                part)
            assert hdrs["etag"] == f'"{hashlib.md5(part).hexdigest()}"'
            md5s += hashlib.md5(part).digest()
        plist = "".join(f"<Part><PartNumber>{n}</PartNumber></Part>"
                        for n in range(1, n_parts + 1))
        _, body = await s3a(
            "POST", f"/bulk/big.bin?uploadId={upload}",
            f"<CompleteMultipartUpload>{plist}"
            f"</CompleteMultipartUpload>".encode())
        steps.end("multipart")
        etag = f"{hashlib.md5(md5s).hexdigest()}-{n_parts}"
        assert f'<ETag>"{etag}"</ETag>'.encode() in body, body
        hdrs, got = await s3a("GET", "/bulk/big.bin")
        assert got == big and hdrs["etag"] == f'"{etag}"'
        final[obj_oid("bulk", "big.bin")] = big
        await s3a("PUT", "/ver")
        await s3a("PUT", "/ver?versioning", b"<Status>Enabled</Status>")
        versions = {}
        for _ in range(SVC_RGW_VERSIONS):
            body = rs.randint(0, 256, SVC_IO, dtype=np.uint8).tobytes()
            hdrs, _ = await s3a("PUT", "/ver/doc", body)
            versions[hdrs["x-amz-version-id"]] = body
        _, listing = await s3a("GET", "/ver?versions")
        assert listing.count(b"<Version>") == SVC_RGW_VERSIONS
        for vid, body in versions.items():
            assert (await s3a("GET", f"/ver/doc?versionId={vid}"))[1] \
                == body
            final[ver_obj_oid("ver", "doc", vid)] = body
        down = _svc_down(a, obj_oid("bulk", "obj001"))
        for osd in down:
            a.kill_osd(osd)
        degraded = list(bodies)[:SVC_RGW_DEGRADED]
        steps.start()
        for key in degraded:
            assert (await s3a("GET", f"/bulk/{key}"))[1] == bodies[key]
        steps.end("degraded_get")
        for osd in down:
            a.revive_osd(osd)
        agent = RGWSyncAgent((a.backend, a_index), (b.backend, b_index))
        steps.start()
        out["sync"] = await agent.sync_once()
        steps.end("sync")
        again = await agent.sync_once()
        assert again["objects_copied"] == 0 == again["objects_deleted"]
        for target in ("/", "/bulk", "/ver?versions", "/ver"):
            assert (await s3a("GET", target))[1] == \
                (await s3b("GET", target))[1], target
        for key, body in bodies.items():
            assert (await s3b("GET", f"/bulk/{key}"))[1] == body
        _s3_error((await s3b("GET", f"/bulk/{gone}", want=404))[1],
                  "NoSuchKey")
        assert (await s3b("GET", "/bulk/big.bin"))[1] == big
        for vid, body in versions.items():
            assert (await s3b("GET", f"/ver/doc?versionId={vid}"))[1] \
                == body
        t0 = time.perf_counter()
        out["check"] = [
            _cluster_check(a, _svc_ref(_profile({})), final, crc=False),
            _cluster_check(b, _svc_ref(SVC_PEER_PROFILE), final,
                           crc=False)]
        out["check_s"] = time.perf_counter() - t0
        out.update(requests=s3a.requests + s3b.requests, down=down,
                   degraded=degraded)

    async def main():
        a = _svc_cluster(SVC_OSDS, _profile({}))
        try:
            b = _svc_cluster(SVC_PEER_OSDS, SVC_PEER_PROFILE)
            try:
                a_index, gwa = await zone(a, True)
                b_index, gwb = await zone(b, False)
                try:
                    await serve(a, a_index, gwa, b, b_index, gwb)
                finally:
                    await gwa.stop()
                    await gwb.stop()
            finally:
                await b.shutdown()
        finally:
            await a.shutdown()

    _in_new_loop(main())
    steps.rose("rgw", ("put", "multipart", "degraded_get", "sync"))
    s = steps.seconds
    moved = SVC_RGW_OBJECTS * OBJECT
    print(f"[services] (e) RGW, SigV4: {SVC_RGW_OBJECTS} PUTs of 4 MiB "
          f"{_rate(moved, s['put'])}, GETs {_rate(moved, s['get'])} "
          f"(read-only: no decode, launches {steps.launches['get']}); "
          f"HEAD, prefix listing, DELETE, 4 error envelopes; "
          f"{SVC_RGW_MULTIPART >> 20} MiB multipart in "
          f"{SVC_RGW_PART >> 20} MiB parts "
          f"{_rate(SVC_RGW_MULTIPART, s['multipart'])} (a "
          f"-{SVC_RGW_MULTIPART // SVC_RGW_PART} ETag); "
          f"{SVC_RGW_VERSIONS} versions listed; {SVC_RGW_DEGRADED} degraded "
          f"GETs (osd {out['down']} down) "
          f"{_rate(SVC_RGW_DEGRADED * OBJECT, s['degraded_get'])}; sync to "
          f"{SVC_PEER_OSDS} OSDs k=4 m=2 {s['sync']:.2f} s "
          f"({out['sync']['objects_copied']} objects, "
          f"{out['sync']['versions_copied']} versions); {out['requests']} "
          f"requests, every status as expected; {out['check']} "
          f"({out['check_s']:.1f} s); launches {json.dumps(steps.launches)};"
          f" card {card}", flush=True)
    out.update(seconds=s, launches=steps.launches)
    return out


def _fs_tree() -> tuple:
    """The CephFS step's tree: ``SVC_FS_DIRS`` directories nested
    ``SVC_FS_DEPTH`` deep under ``/t`` and files spread over them,
    ``SVC_FS_DENTRIES`` dentries in all; every ``SVC_FS_DATA_EVERY``-th file gets 4 KiB."""
    dirs = []
    for top in range(SVC_FS_DIRS // SVC_FS_DEPTH):
        path = f"/t/d{top:02d}"
        for level in range(SVC_FS_DEPTH):
            dirs.append(path)
            path += f"/e{level}"
    n_files = SVC_FS_DENTRIES - len(dirs) - 1  # /t itself
    files = [f"{dirs[i % len(dirs)]}/f{i:04d}" for i in range(n_files)]
    return dirs, files


async def _fs_walk(mds, path: str = "/") -> dict:
    """The namespace under ``path``: path -> (type, size)."""
    out = {}
    for name, d in sorted((await mds.readdir(path)).items()):
        child = f"{path.rstrip('/')}/{name}"
        out[child] = (d["type"], d["size"])
        if d["type"] == "d":
            out.update(await _fs_walk(mds, child))
    return out


def _svc_cephfs(seed: int, card: str) -> dict:
    """(d) CephFS: a tree of 500 dentries, a file at the documented
    default layout, a crash and a fresh MDS's journal replay, and two MDS
    ranks with an exported subtree."""
    from ceph_tpu_torch.mds import MDS, CephFS, MultiMDS
    from ceph_tpu_torch.mds.mds import _enc, data_oid

    rs = np.random.RandomState(seed + 34)
    steps = _Steps()
    out = {}
    dirs, files = _fs_tree()

    async def forge(c, mds, ev):
        """Journal ``ev`` without applying it: the MDS died after the
        append."""
        mds._journal_seq += 1
        await c.backend.omap_set(mds.journal_oid, {
            f"{mds._journal_seq:016d}": _enc(ev)})

    async def main():
        c = _svc_cluster(SVC_OSDS, _profile({}))
        final = {}
        try:
            fs = await CephFS.mount(c.backend)
            model = {"/t": ("d", 0)}  # the namespace: path -> (type, size)
            data = {}
            steps.start()
            await fs.mkdir("/t")
            for path in dirs:
                await fs.mkdir(path)
                model[path] = ("d", 0)
            for i, path in enumerate(files):
                if i % SVC_FS_DATA_EVERY:
                    await fs.mds.create(path)
                    model[path] = ("f", 0)
                else:
                    data[path] = rs.randint(0, 256, SVC_IO,
                                            dtype=np.uint8).tobytes()
                    await fs.write_file(path, data[path])
                    model[path] = ("f", SVC_IO)
            steps.end("tree")
            assert len(model) == SVC_FS_DENTRIES
            big = bytearray(rs.randint(0, 256, SVC_FS_BIG,
                                       dtype=np.uint8).tobytes())
            await fs.mds.create("/big", layout=SVC_FS_LAYOUT)
            model["/big"] = ("f", SVC_FS_BIG)
            steps.start()
            for off in range(0, SVC_FS_BIG, SVC_FS_WRITE):
                await fs.write_file(
                    "/big", bytes(big[off:off + SVC_FS_WRITE]), offset=off)
            steps.end("big_write")
            dentry = await fs.stat("/big")
            assert dentry["layout"] == list(SVC_FS_LAYOUT) and \
                dentry["size"] == SVC_FS_BIG
            steps.start()
            assert await fs.read_file("/big") == big, "cephfs: /big"
            steps.end("big_read")
            mds = fs.mds
            ghost = await mds._alloc_ino()
            parent = dirs[-1]
            await forge(c, mds, {
                "op": "link", "dir": (await mds.stat(parent))["ino"],
                "name": "ghost", "dentry": mds._mkdentry(ghost, "f")})
            model[f"{parent}/ghost"] = ("f", 0)
            steps.start()
            standby = await CephFS.mount(c.backend)
            steps.end("crash_replay")
            assert standby.mds.replayed == 1
            assert await _fs_walk(standby.mds) == model, \
                "cephfs: namespace after the replay"
            steps.start()
            for path, body in data.items():
                assert await standby.read_file(path) == body, path
            assert await standby.read_file("/big") == big
            steps.end("reads")
            multi = MultiMDS(c.backend, n_ranks=2)
            await multi.start()
            await multi.mkdir("/mm")
            await multi.export_subtree("/mm", 1)
            assert multi.rank_of("/mm/x") == 1 and multi.rank_of("/x") == 0
            for f in range(8):
                await multi.create(f"/mm/f{f}")
            rank1 = multi.ranks[1]
            await forge(c, rank1, {
                "op": "link", "dir": await rank1._resolve_dir("/mm"),
                "name": "late", "dentry": rank1._mkdentry(
                    await rank1._alloc_ino(), "f")})
            standby1, standby0 = MDS(c.backend, rank=1), MDS(c.backend,
                                                              rank=0)
            await standby1.start()
            await standby0.start()
            assert (standby1.replayed, standby0.replayed) == (1, 0)
            assert sorted(await standby1.readdir("/mm")) == sorted(
                [f"f{f}" for f in range(8)] + ["late"])
            for path, body in data.items():
                final[data_oid((await standby.stat(path))["ino"], 0)] = body
            ino = (await standby.stat("/big"))["ino"]
            for n in range(SVC_FS_BIG // OBJECT):
                final[data_oid(ino, n)] = bytes(big[n * OBJECT:
                                                    (n + 1) * OBJECT])
            t0 = time.perf_counter()
            out["check"] = _cluster_check(c, _svc_ref(_profile({})), final,
                                          crc=False)
            out["check_s"] = time.perf_counter() - t0
            out.update(dentries=len(model), data_files=len(data))
        finally:
            await c.shutdown()

    _in_new_loop(main())
    steps.rose("cephfs", ("tree", "big_write"))
    s = steps.seconds
    print(f"[services] (d) CephFS: {SVC_FS_DENTRIES} dentries ({len(dirs)} "
          f"directories {SVC_FS_DEPTH} deep, {out['data_files']} of the "
          f"files with 4 KiB) {_ops(SVC_FS_DENTRIES, s['tree'])}; "
          f"{SVC_FS_BIG >> 20} MiB file at layout {list(SVC_FS_LAYOUT)} in "
          f"4 MiB writes {_rate(SVC_FS_BIG, s['big_write'])}, read "
          f"{_rate(SVC_FS_BIG, s['big_read'])} (read-only: no decode, "
          f"launches {steps.launches['big_read']}); crash: a fresh MDS "
          f"replayed 1 event in {s['crash_replay']:.3f} s, namespace of "
          f"{out['dentries']} dentries == model, file bytes read back "
          f"{s['reads']:.2f} s; 2 ranks, /mm exported, rank 1 replayed "
          f"alone; {out['check']} ({out['check_s']:.1f} s); launches "
          f"{json.dumps(steps.launches)}; card {card}", flush=True)
    out.update(seconds=s, launches=steps.launches)
    return out


def _svc_cli(seed: int, card: str) -> dict:
    """(f) ``tools/rbd_cli.py`` on the card's pool: import, snap create,
    ls, info, export of a 64 MiB file, each command a run of its own over
    the same data path."""
    from ceph_tpu_torch.tools import rbd_cli

    steps = _Steps()
    out = {}
    os.makedirs(DURABLE_ROOT, exist_ok=True)
    root = tempfile.mkdtemp(prefix="rbd-cli-", dir=DURABLE_ROOT)
    try:
        src, dst = os.path.join(root, "src.img"), os.path.join(root,
                                                               "dst.img")
        body = np.random.RandomState(seed + 35).randint(
            0, 256, SVC_CLI_BYTES, dtype=np.uint8).tobytes()
        with open(src, "wb") as f:
            f.write(body)
        base = ["--data-path", os.path.join(root, "data"), "--objectstore",
                SVC_CLI_STORE, "--osds", str(SVC_OSDS), "--k", str(K),
                "--m", str(M)]
        printed = {}
        for name, argv in (("import", ["import", src, "vol"]),
                           ("snap_create", ["snap", "create", "vol@s1"]),
                           ("ls", ["ls"]), ("info", ["info", "vol"]),
                           ("export", ["export", "vol", dst])):
            buf = io.StringIO()
            steps.start()
            with contextlib.redirect_stdout(buf):
                rc = rbd_cli.main(argv + base)
            steps.end(name)
            assert rc == 0, f"rbd_cli {name} exited {rc}: {buf.getvalue()}"
            printed[name] = buf.getvalue()
        assert printed["ls"].split() == ["vol"], printed["ls"]
        assert f"size {SVC_CLI_BYTES} bytes" in printed["info"] and \
            "snapshots: s1" in printed["info"], printed["info"]
        with open(dst, "rb") as f:
            assert f.read() == body, "rbd_cli: export differs from the source"

        async def check():
            c = ECCluster(SVC_OSDS, _profile({}), plugin="cuda",
                          objectstore=SVC_CLI_STORE,
                          data_path=os.path.join(root, "data"))
            try:
                return _cluster_check(
                    c, _svc_ref(_profile({})),
                    _objects_of(body, "rbd_data.vol.", OBJECT,
                                range(SVC_CLI_BYTES // OBJECT)), crc=False)
            finally:
                await c.shutdown()

        t0 = time.perf_counter()
        out["check"] = _in_new_loop(check())
        out["check_s"] = time.perf_counter() - t0
        out["disk"] = _df(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    steps.rose("cli", ("import",))
    s = steps.seconds
    print(f"[services] (f) rbd_cli on {SVC_OSDS} OSDs k={K} m={M} "
          f"({SVC_CLI_STORE} on {out['disk']}): import of "
          f"{SVC_CLI_BYTES >> 20} MiB {_rate(SVC_CLI_BYTES, s['import'])}, "
          f"snap create {s['snap_create']:.2f} s, ls {s['ls']:.2f} s, info "
          f"{s['info']:.2f} s, export {_rate(SVC_CLI_BYTES, s['export'])} "
          f"(read-only: no decode), byte-equal to the source; "
          f"{out['check']} ({out['check_s']:.1f} s); launches "
          f"{json.dumps(steps.launches)}; card {card}", flush=True)
    out.update(seconds=s, launches=steps.launches)
    return out


def phase_services(seed: int, card: str) -> dict:
    """The services on RADOS on the card (docstring, phase 3m)."""
    t_phase = time.perf_counter()
    out = {}
    for name, step in (("rbd", _svc_rbd), ("mirror", _svc_mirror),
                       ("nbd", _svc_nbd), ("cephfs", _svc_cephfs),
                       ("rgw", _svc_rgw), ("cli", _svc_cli)):
        t0 = time.perf_counter()
        out[name] = step(seed, card)
        out[name]["step_s"] = time.perf_counter() - t0
        gc.collect()
    steps = {name: round(step["step_s"], 1) for name, step in out.items()}
    out["launches"] = {name: sum(step["launches"].values())
                       for name, step in out.items()}
    out["seconds"] = time.perf_counter() - t_phase
    held = "held" if out["seconds"] <= SVC_BUDGET_S else "MISSED"
    print(f"[services] phase {out['seconds']:.1f} s (budget "
          f"{SVC_BUDGET_S:.0f} s {held}; steps {json.dumps(steps)}); "
          f"gf2_matrix_w8 launches "
          f"{json.dumps(out['launches'])}, {sum(out['launches'].values())} "
          f"in all; card {card}", flush=True)
    return out


@contextlib.contextmanager
def _environ(values: dict):
    """``values`` in this process's environment for the block (the
    daemons spawned in it inherit them)."""
    prior = {key: os.environ.get(key) for key in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, val in prior.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val


async def _asok(run_dir: str, who: str, prefix: str, **fields):
    from ceph_tpu_torch.utils.admin_socket import admin_command

    return await admin_command(
        os.path.join(run_dir, "data", f"{who}.asok"), prefix, **fields)


async def _residency_by_osd(run_dir: str, osds) -> dict:
    """Each OSD daemon's transfer ledger, read over its admin socket."""
    return {i: (await _asok(run_dir, f"osd.{i}", "residency status"))[
        "counters"] for i in osds}


def _transfers(before: dict, after: dict, label: str, leaders=()) -> dict:
    """The H2D and D2H ops each OSD daemon issued between two ledger
    reads: their sums must rise, and so must each ``leaders`` OSD's."""
    delta = {i: {key: after[i][key] - before[i][key]
                 for key in ("h2d_ops", "d2h_ops", "h2d_bytes")}
             for i in after}
    for key in ("h2d_ops", "d2h_ops"):
        assert sum(d[key] for d in delta.values()) > 0, \
            f"daemons {label}: no {key} on the card in any OSD daemon"
    idle = sorted(i for i in leaders
                  if delta[i]["h2d_ops"] <= 0 or delta[i]["d2h_ops"] <= 0)
    assert not idle, f"daemons {label}: osd(s) {idle} led a written " \
        f"object's placement group and moved nothing through the card"
    return delta


def _daemon_memory(pids: dict) -> dict:
    """Each daemon's card memory from ``nvidia-smi --query-compute-apps``
    (information only: a PID namespace may hide the daemons)."""
    rows = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    used = {}
    for row in rows.splitlines():
        pid, _, mem = row.partition(",")
        if pid.strip().isdigit():
            used[int(pid)] = mem.strip()
    return {who: used.get(pid, "not listed") for who, pid in pids.items()}


def _daemon_pids(run_dir: str) -> dict:
    pids = {}
    for name, prefix in (("pids", "osd"), ("mon_pids", "mon"),
                         ("mgr_pids", "mgr")):
        with open(os.path.join(run_dir, name)) as f:
            pids.update({f"{prefix}.{k}": v for k, v in json.load(f).items()})
    return pids


def _mounted_shards(run_dir: str, final: dict) -> dict:
    """Every OSD's store mounted in this process after a clean stop: the
    stored shards of the objects of ``final`` ((osd, "<oid>@<s>") ->
    bytes)."""
    from ceph_tpu_torch import objectstore

    shards = {}
    for i in range(DAEMON_OSDS):
        store = objectstore.create(
            DAEMON_STORE, os.path.join(run_dir, "data", f"osd.{i}"))
        try:
            for soid in store.list_objects():
                base, _, tag = soid.rpartition("@")
                if base in final and tag.isdigit():
                    shards[(i, soid)] = store.read(soid)
        finally:
            store.umount()
    return shards


def _health_series(series: list) -> tuple:
    """(peak, upticks after the peak) of a degraded-count series."""
    peak = max(series)
    at = series.index(peak)
    return peak, sum(1 for a, b in zip(series[at:], series[at + 1:])
                     if b > a)


def _daemons_cluster(seed: int, card: str) -> dict:
    """(a) A cluster of processes on the card (docstring, phase 3n)."""
    from ceph_tpu_torch.daemon.client import RemoteClient
    from ceph_tpu_torch.rbd import RBD, Image
    from ceph_tpu_torch.tools import vstart

    rs = np.random.RandomState(seed + 2500)
    payloads = {f"d{i}": rs.randint(0, 256, OBJECT, np.uint8).tobytes()
                for i in range(DAEMON_OBJECTS)}
    run_dir = tempfile.mkdtemp(prefix="ct-3n-")
    addr_map = os.path.join(run_dir, "addr_map.json")
    seconds, out = {}, {}
    model = bytearray(DAEMON_NBD_BYTES)
    tools = {"seconds": {}}

    async def sampler(series, stop):
        """The mgr's ``pg stat`` degraded count and health, every 0.2 s."""
        while not stop.is_set():
            stat = await _asok(run_dir, "mgr.0", "pg stat")
            health = await _asok(run_dir, "mgr.0", "health")
            series.append((int(stat["degraded"]), health["status"]))
            await asyncio.sleep(0.2)

    async def drive():
        c = await RemoteClient.connect(addr_map, DAEMON_PROFILE)
        osds = range(DAEMON_OSDS)
        before = await _residency_by_osd(run_dir, osds)
        t0 = time.perf_counter()
        sem = asyncio.Semaphore(DAEMON_WRITERS)

        async def put(oid, data):
            async with sem:
                await c.write(oid, data)

        async def get(oid):
            async with sem:
                return oid, await c.read(oid)

        await asyncio.gather(*(put(o, d) for o, d in payloads.items()))
        seconds["write"] = time.perf_counter() - t0
        leaders = {int(c.backend.primary_of(oid).split(".")[1])
                   for oid in payloads}
        out["d0_acting"] = c.backend.acting_set("d0")
        out["write_transfers"] = _transfers(
            before, await _residency_by_osd(run_dir, osds), "write",
            leaders)
        t0 = time.perf_counter()
        got = dict(await asyncio.gather(*(get(o) for o in payloads)))
        seconds["read"] = time.perf_counter() - t0
        assert got == payloads, "daemons: a read differs from its write"
        # SIGKILL one OSD: the mon marks it down from peer heartbeats
        victim = c.backend.acting_set("d0")[0]
        out["victim"] = victim
        series, stop = [], asyncio.Event()
        watch = asyncio.get_running_loop().create_task(
            sampler(series, stop))
        assert vstart.kill_osd(run_dir, victim)
        t0 = time.perf_counter()
        while True:
            rc, st = await c.monc.command({"prefix": "status"}, timeout=5.0)
            if rc == 0 and victim not in st["up_osds"]:
                break
            assert time.perf_counter() - t0 < DAEMON_DEADLINE_S, \
                f"daemons: the mon never marked osd.{victim} down: {st}"
            await asyncio.sleep(0.25)
        seconds["mark_down"] = time.perf_counter() - t0
        live = [i for i in osds if i != victim]
        before = await _residency_by_osd(run_dir, live)
        t0 = time.perf_counter()
        got = dict(await asyncio.gather(*(get(o) for o in payloads)))
        seconds["degraded_read"] = time.perf_counter() - t0
        assert got == payloads, "daemons: a degraded read differs"
        out["degraded_read_transfers"] = _transfers(
            before, await _residency_by_osd(run_dir, live), "degraded read")
        # revive through ceph_volume (phase 3o (c)): the degraded count
        # drains to HEALTH_OK
        t0 = time.perf_counter()
        tools["activated"] = await asyncio.get_running_loop(
        ).run_in_executor(None, _tools_activate, run_dir, victim)
        seconds["revive"] = tools["seconds"]["(c) activate"] = \
            time.perf_counter() - t0
        t0 = time.perf_counter()
        while True:
            await asyncio.sleep(0.2)
            if series and series[-1] == (0, "HEALTH_OK") and \
                    max(d for d, _ in series) > 0:
                break
            assert time.perf_counter() - t0 < DAEMON_DEADLINE_S, \
                f"daemons: never HEALTH_OK: {series[-10:]}"
        seconds["drain"] = time.perf_counter() - t0
        stop.set()
        await watch
        degraded = [d for d, _ in series]
        peak, upticks = _health_series(degraded)
        assert peak > 0 and upticks <= 1, \
            f"daemons: degraded {degraded} (peak {peak}, upticks {upticks})"
        out["degraded_series"] = degraded
        out["health"] = sorted({h for _, h in series})
        await RBD(c.backend).create(DAEMON_IMAGE, DAEMON_NBD_BYTES,
                                    order=SVC_ORDER)
        await c.close()

    async def image_bytes():
        c = await RemoteClient.connect(addr_map, DAEMON_PROFILE)
        try:
            img = await Image.open(c.backend, DAEMON_IMAGE)
            return await _read_image(img, DAEMON_NBD_BYTES)
        finally:
            await c.close()

    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    stopped = False
    t_boot = time.perf_counter()
    try:
        with _environ(DAEMON_ENV):
            vstart.start_cluster(run_dir, DAEMON_OSDS, DAEMON_PROFILE,
                                 objectstore=DAEMON_STORE,
                                 wait=DAEMON_WAIT_S, n_mons=DAEMON_MONS,
                                 n_mgrs=1)
            seconds["boot"] = time.perf_counter() - t_boot
            out["card_memory"] = _daemon_memory(_daemon_pids(run_dir))
            _in_new_loop(drive())
        # the admin-socket tool, a process against one OSD
        asok = os.path.join(run_dir, "data", f"osd.{out['victim']}.asok")
        t0 = time.perf_counter()
        for words in DAEMON_CEPH_DAEMON:
            proc = subprocess.run(
                [sys.executable, "-m", "ceph_tpu_torch.tools.ceph_daemon",
                 asok, *words], env=env, capture_output=True, text=True,
                timeout=120)
            assert proc.returncode == 0, (words, proc.stderr)
            reply = json.loads(proc.stdout)
            assert "error" not in reply, (words, reply)
        assert reply["status"] == "stopped" and reply["report"]
        seconds["ceph_daemon"] = time.perf_counter() - t0
        # rados_cli, every subcommand (phase 3o (b))
        t0 = time.perf_counter()
        tools["cli"] = _tools_cli(run_dir, env, seed)
        tools["seconds"]["(b) rados_cli"] = time.perf_counter() - t0
        # rbd_nbd, a process exporting the image over NBD
        t0 = time.perf_counter()
        nbd = subprocess.Popen(
            [sys.executable, "-m", "ceph_tpu_torch.tools.rbd_nbd", "--dir",
             run_dir], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            line = nbd.stdout.readline()
            assert line.startswith("nbd server up on 127.0.0.1:"), \
                (line, nbd.stderr.read() if nbd.poll() is not None else "")
            out["nbd_s"] = _in_new_loop(_nbd_client(
                int(line.rsplit(":", 1)[1]), DAEMON_IMAGE, model, rs))
        finally:
            nbd.terminate()
            rc = nbd.wait(timeout=60)
        assert rc == 0, f"rbd_nbd exited {rc}: {nbd.stderr.read()}"
        seconds["rbd_nbd"] = time.perf_counter() - t0
        assert _in_new_loop(image_bytes()) == model, \
            "daemons: the image differs from the NBD client's model"
        t0 = time.perf_counter()
        vstart.stop_cluster(run_dir)
        stopped = True
        seconds["stop"] = time.perf_counter() - t0
        # every stored shard, each store mounted here after the clean stop
        t0 = time.perf_counter()
        image_object = 1 << SVC_ORDER
        final = dict(payloads, **tools["cli"]["objects"], **_objects_of(
            model, f"rbd_data.{DAEMON_IMAGE}.", image_object,
            range(DAEMON_NBD_BYTES // image_object)))
        profile = {key: val for key, val in DAEMON_PROFILE.items()
                   if key != "plugin"}
        out["check"] = _wire_numpy_check(
            "daemons", _mounted_shards(run_dir, final), final,
            registry_mod.instance().factory("cuda", profile),
            registry_mod.instance().factory("jerasure", profile))
        seconds["check"] = time.perf_counter() - t0
        # the offline tools on the stopped cluster's stores (phase 3o (d))
        # and ceph_volume on a fresh run directory (3o (c))
        t0 = time.perf_counter()
        tools["offline"] = _tools_offline(run_dir, seed, out["d0_acting"],
                                          out["victim"])
        tools["volume"] = _tools_volume_fresh()
        tools["seconds"]["(c, d) offline"] = time.perf_counter() - t0
    finally:
        if not stopped:
            vstart.stop_cluster(run_dir)
        shutil.rmtree(run_dir, ignore_errors=True)
    out.update(seconds=seconds, tools=tools)
    wt = out["write_transfers"]
    print(f"[daemons] (a) {DAEMON_MONS} mons, 1 mgr, {DAEMON_OSDS} OSD "
          f"processes on {DAEMON_STORE}, reed_sol_van k=4 m=2 w=8 on cuda: "
          f"boot {seconds['boot']:.1f} s; {DAEMON_OBJECTS} x "
          f"{OBJECT >> 20} MiB written "
          f"{_rate(DAEMON_OBJECTS * OBJECT, seconds['write'])}, read "
          f"{_rate(DAEMON_OBJECTS * OBJECT, seconds['read'])}; residency "
          f"h2d/d2h ops per OSD in the write "
          f"{json.dumps({i: [d['h2d_ops'], d['d2h_ops']] for i, d in wt.items()})}"
          f"; card {card}", flush=True)
    dt = out["degraded_read_transfers"]
    print(f"[daemons] (a) osd.{out['victim']} SIGKILLed, marked down by "
          f"the mon in {seconds['mark_down']:.1f} s; degraded read "
          f"{_rate(DAEMON_OBJECTS * OBJECT, seconds['degraded_read'])}, "
          f"bit-exact, residency h2d/d2h ops per OSD "
          f"{json.dumps({i: [d['h2d_ops'], d['d2h_ops']] for i, d in dt.items()})}"
          f"; revived through ceph_volume activate (phase 3o (c)) in "
          f"{seconds['revive']:.1f} s, degraded series "
          f"{out['degraded_series']} -> HEALTH_OK in "
          f"{seconds['drain']:.1f} s (health seen {out['health']}); "
          f"card {card}", flush=True)
    ns = out["nbd_s"]
    print(f"[daemons] (a) ceph_daemon {len(DAEMON_CEPH_DAEMON)} commands "
          f"in {seconds['ceph_daemon']:.1f} s; rbd_nbd process: "
          f"{DAEMON_NBD_BYTES >> 20} MiB in {SVC_NBD_REQUEST >> 10} KiB "
          f"requests written {_rate(DAEMON_NBD_BYTES, ns['write'])}, read "
          f"{_rate(DAEMON_NBD_BYTES, ns['read'])}, image == model; clean "
          f"stop {seconds['stop']:.1f} s; {out['check']} "
          f"({seconds['check']:.1f} s, stores mounted here); card memory "
          f"{json.dumps(out['card_memory'])}; card {card}", flush=True)
    return out


def _held(ok: bool) -> str:
    return "held" if ok else "MISSED"


def _daemons_telemetry(card: str) -> dict:
    """(b) Telemetry on the card (docstring, phase 3n)."""
    from ceph_tpu_torch.mgr import telemetry_bench

    out, launches, seconds = {}, {}, {}
    for name, call in (
            ("telemetry_bench", lambda: telemetry_bench.run_telemetry_bench(
                overhead_limit_pct=TELEMETRY_OVERHEAD_LIMIT_PCT)),
            ("vstart_smoke", lambda: telemetry_bench.run_vstart_smoke(
                wait=DAEMON_WAIT_S))):
        cuda_gf.reset_launches()
        t0 = time.perf_counter()
        out[name] = call()
        seconds[name] = time.perf_counter() - t0
        launches[name] = _w8_launches()
    assert launches["telemetry_bench"] > 0, \
        "daemons (b): gf2_matrix_w8 idle in the telemetry bench"
    tel, vs = out["telemetry_bench"], out["vstart_smoke"]
    pct = tel["telemetry_overhead_pct"]
    print(f"[daemons] (b) run_telemetry_bench (6 OSDs, k=2 m=1 on cuda, "
          f"{tel['n_objects']} x {tel['obj_bytes'] >> 10} KiB): report-loop "
          f"overhead {pct}% (gate {TELEMETRY_OVERHEAD_GATE_PCT}% "
          f"{_held(pct <= TELEMETRY_OVERHEAD_GATE_PCT)}; run at "
          f"{TELEMETRY_OVERHEAD_LIMIT_PCT}%), reports off / on "
          f"{tel['reports_off_GiBs']} / {tel['reports_on_GiBs']} GiB/s, "
          f"{tel['reports_folded']} reports folded, scrape "
          f"{tel['scrape']['series_parsed']} series, chaos "
          f"{tel['chaos']['clients']} clients degraded peak "
          f"{tel['chaos']['degraded_max']} -> "
          f"{tel['chaos']['health_final']} "
          f"({seconds['telemetry_bench']:.1f} s); run_vstart_smoke (4 OSD "
          f"processes, k=2 m=1 on cuda): degraded {vs['degraded_series']} "
          f"-> {vs['health_final']} ({seconds['vstart_smoke']:.1f} s); "
          f"gf2_matrix_w8 launches {json.dumps(launches)}; card {card}",
          flush=True)
    out.update(launches=launches, seconds=seconds)
    return out


def _daemons_qos(card: str) -> dict:
    """(c) QoS at scale on the card (docstring, phase 3n)."""
    from ceph_tpu_torch.osd import qos_bench

    out, launches, seconds = {}, {}, {}
    stages = (
        ("overload", lambda: qos_bench._overload_stage(
            False, reservation_ratio_min=None)),
        ("chaos", lambda: qos_bench._chaos_stage(False)),
        ("scale", lambda: qos_bench._scale_stage(
            False, starved_divisor=None)),
        ("scale10x", lambda: qos_bench._scale10x_stage(
            QOS_SCALE10X_SMOKE, out["scale"], starved_divisor=None,
            p99_vs_1k_max=None)))
    for name, stage in stages:
        cuda_gf.reset_launches()
        t0 = time.perf_counter()
        out[name] = _in_new_loop(stage())
        seconds[name] = time.perf_counter() - t0
        launches[name] = _w8_launches()
        assert launches[name] > 0, \
            f"daemons (c): gf2_matrix_w8 idle in the {name} stage"
    over, chaos = out["overload"], out["chaos"]
    ratio = over["reservation_ratio"]
    gates = [f"reservation ratio {ratio} (gate >= {QOS_RESERVATION_GATE} "
             f"{_held(ratio >= QOS_RESERVATION_GATE)})"]
    for name in ("scale", "scale10x"):
        starved, closed = qos_bench._starved(out[name])
        bound = max(2, closed // QOS_STARVED_DIVISOR)
        gates.append(f"{name} closed-loop clients at zero ops {starved}/"
                     f"{closed} (gate <= {bound} "
                     f"{_held(starved <= bound)})")
    p99, ref = out["scale10x"]["p99_ms"], out["scale"]["p99_ms"]
    gates.append(f"scale10x p99 {p99} ms vs the 1k stage's {ref} ms (gate "
                 f"<= {QOS_P99_VS_1K_GATE}x "
                 f"{_held(p99 <= ref * QOS_P99_VS_1K_GATE)})")
    print(f"[daemons] (c) run_qos_path_bench stages on cuda: overload "
          f"{over['gold_clients']} gold + {over['bulk_clients']} bulk, "
          f"throttle waits {over['throttle_waits']}, bulk ops "
          f"{over['bulk_ops']}; chaos {chaos['n_clients']} clients, kills "
          f"{chaos['kills']}, wipes {chaos['wipes']}, ops {chaos['ops']}, "
          f"cas exact {chaos['cas_exact']}; scale "
          f"{out['scale']['n_clients']} clients {out['scale']['ops_per_s']} "
          f"ops/s p99 {ref} ms; scale10x {out['scale10x']['n_clients']} "
          f"clients {out['scale10x']['ops_per_s']} ops/s, cas exact "
          f"{out['scale10x']['cas_exact']}; host-timing gates run open: "
          f"{'; '.join(gates)}; seconds "
          f"{json.dumps({k: round(v, 1) for k, v in seconds.items()})}; "
          f"gf2_matrix_w8 launches {json.dumps(launches)}; card {card}",
          flush=True)
    return {"launches": launches, "seconds": seconds, "gates": gates,
            **{name: {key: out[name].get(key) for key in (
                "n_clients", "ops", "errors", "ops_per_s", "p50_ms",
                "p99_ms", "cas_exact", "kills", "wipes",
                "reservation_ratio", "throttle_waits", "bulk_ops")
                if key in out[name]} for name, _ in stages}}


def phase_daemons(seed: int, card: str) -> dict:
    """Daemons in processes of their own and the load generator on the
    card (docstring, phase 3n)."""
    t_phase = time.perf_counter()
    out = {"cluster": _daemons_cluster(seed, card)}
    gc.collect()
    out["telemetry"] = _daemons_telemetry(card)
    gc.collect()
    out["qos"] = _daemons_qos(card)
    gc.collect()
    out["launches"] = dict(out["telemetry"]["launches"],
                           **out["qos"]["launches"])
    embedded = sum(out["cluster"]["tools"]["seconds"].values())
    out["seconds"] = time.perf_counter() - t_phase - embedded
    held = "held" if out["seconds"] <= DAEMON_BUDGET_S else "MISSED"
    print(f"[daemons] phase {out['seconds']:.1f} s without phase 3o's "
          f"{embedded:.1f} s inside (a) (budget "
          f"{DAEMON_BUDGET_S:.0f} s {held}); gf2_matrix_w8 launches in "
          f"this process {json.dumps(out['launches'])}, "
          f"{sum(out['launches'].values())} in all; card {card}",
          flush=True)
    return out


def _tools_activate(run_dir: str, osd: int) -> str:
    """3o (c): ``ceph_volume prepare`` and ``activate`` of 3n (a)'s
    SIGKILLed OSD, on its blockstore: an OSD process that builds its codec
    on the card before it listens (docstring, phase 3o)."""
    from ceph_tpu_torch.tools import ceph_volume, vstart

    argv = ["--run-dir", run_dir, "--id", str(osd)]
    out = _tool(ceph_volume, ["prepare", *argv, "--objectstore",
                              DAEMON_STORE])
    assert out.startswith(f"prepared osd.{osd} ({DAEMON_STORE}) at "), out
    line = _tool(ceph_volume, ["activate", *argv])
    assert re.fullmatch(rf"activated osd\.{osd} pid=\d+\n", line), line
    assert vstart._load_pids(run_dir)[osd] == int(line.rsplit("=", 1)[1])
    return line.strip()


def _tools_volume_fresh() -> dict:
    """3o (c): ``ceph_volume prepare`` and ``list`` on a fresh run
    directory; a second prepare and an activate without a cluster are
    refused."""
    from ceph_tpu_torch.tools import ceph_volume

    run_dir = tempfile.mkdtemp(prefix="ct-3o-")
    try:
        argv = ["--run-dir", run_dir, "--id", "0"]
        _tool(ceph_volume, ["prepare", *argv, "--objectstore", DAEMON_STORE])
        with contextlib.redirect_stderr(io.StringIO()):
            _tool(ceph_volume, ["prepare", *argv], rc=1)
            _tool(ceph_volume, ["activate", *argv], rc=1)
        meta = json.loads(_tool(ceph_volume, ["list", "--run-dir",
                                              run_dir]))["osd.0"]
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    assert meta["objectstore"] == DAEMON_STORE and meta["whoami"] == 0 \
        and meta["prepared"] is True and len(meta["fsid"]) == 36, meta
    return meta


def _tools_cli(run_dir: str, env: dict, seed: int) -> dict:
    """3o (b): every ``rados_cli`` subcommand against 3n (a)'s cluster
    (docstring, phase 3o); returns the objects it leaves stored and the
    OSDs' H2D / D2H ops during its puts."""
    from ceph_tpu_torch.tools import rados_cli

    rs = np.random.RandomState(seed + 2600)
    objs = {f"t{i}": rs.randint(0, 256, OBJECT, np.uint8).tobytes()
            for i in range(TOOLS_CLI_OBJECTS)}
    files = {oid: os.path.join(run_dir, f"{oid}.in") for oid in objs}
    for oid, data in objs.items():
        with open(files[oid], "wb") as f:
            f.write(data)
    base, oids, calls = ["--dir", run_dir], list(objs), []

    def cli(*argv) -> str:
        calls.append(argv[0])
        return _tool(rados_cli, [*base, *argv])

    def process(*argv) -> bytes:
        calls.append(argv[0])
        proc = subprocess.run(
            [sys.executable, "-m", "ceph_tpu_torch.tools.rados_cli", *base,
             *argv], env=env, capture_output=True, timeout=300)
        assert proc.returncode == 0, (argv, proc.stderr.decode()[-2000:])
        return proc.stdout

    def per_osd(text: str) -> list:
        rows = [line for line in text.splitlines()
                if line.startswith("osd.")]
        assert len(rows) == DAEMON_OSDS, text
        return rows

    osds = range(DAEMON_OSDS)
    before = _in_new_loop(_residency_by_osd(run_dir, osds))
    assert process("put", oids[0], files[oids[0]]) == \
        f"wrote {OBJECT} bytes to {oids[0]}\n".encode()
    for oid in oids[1:]:
        assert cli("put", oid, files[oid]) == \
            f"wrote {OBJECT} bytes to {oid}\n"
    transfers = _transfers(before, _in_new_loop(
        _residency_by_osd(run_dir, osds)), "rados_cli put")
    assert process("get", oids[1], "-") == objs[oids[1]], "rados_cli get -"
    got = os.path.join(run_dir, "t.out")
    assert cli("get", oids[0], got) == f"read {OBJECT} bytes from {oids[0]}\n"
    with open(got, "rb") as f:
        assert f.read() == objs[oids[0]], "rados_cli get"
    assert cli("stat", oids[0]) == f"{oids[0]} size {OBJECT}\n"
    assert cli("setomapval", oids[0], "owner", "smoke") == "set\n"
    assert cli("listomapvals", oids[0]) == "owner\tb'smoke'\n"
    gone = oids.pop()
    assert cli("rm", gone) == f"removed {gone}\n"
    listed = cli("ls").split()
    assert set(oids) <= set(listed) and gone not in listed, listed
    df = cli("df").splitlines()
    assert len(df) == DAEMON_OSDS + 1 and df[-1].startswith("total\t"), df
    health = cli("health", "detail").splitlines()
    assert health[0] in ("HEALTH_OK", "HEALTH_WARN", "HEALTH_ERR"), health
    assert cli("health").strip() in ("HEALTH_OK", "HEALTH_WARN",
                                     "HEALTH_ERR")
    assert " pg slices: " in cli("pg", "stat")
    assert "  cluster:\n    health: HEALTH_" in cli("status")
    log = cli("log", "last", "5").splitlines()
    assert all(re.fullmatch(r"\d+\.\d{3} [A-Z]+ \S.*", line)
               for line in log), log
    per_osd(cli("tier", "status"))
    per_osd(cli("recovery", "status"))
    for view in ("in-flight", "historic", "slow"):
        per_osd(cli("ops", view))
    per_osd(cli("trace", "status"))
    spans = _in_new_loop(_asok(run_dir, "osd.0", "trace dump"))
    trace_id = spans[0]["trace_id"] if spans else 1
    trace = cli("trace", str(trace_id)).splitlines()
    assert len(trace) >= (1 if spans else 0), trace
    per_osd(cli("profile", "status"))
    per_osd(cli("profile", "dump"))
    assert cli("profile", "reset").count("\treset") == DAEMON_OSDS
    assert all("\th2d " in row for row in per_osd(cli("residency",
                                                      "status")))
    missing = {"status", "health", "pg", "put", "get", "rm", "stat", "ls",
               "df", "tier", "recovery", "ops", "trace", "profile", "log",
               "residency", "setomapval", "listomapvals"} - set(calls)
    assert not missing, f"rados_cli: {missing} not run"
    return {"objects": {oid: objs[oid] for oid in oids},
            "commands": len(calls),
            "put_transfers": transfers, "health": health[0],
            "trace_spans": len(trace),
            "log_lines": len(log)}


def _tools_offline(run_dir: str, seed: int, d0_acting: list,
                   victim: int) -> dict:
    """3o (d): ``monstore_tool`` on 3n (a)'s stopped ``mon.0``,
    ``osdmaptool`` on the map it rebuilds, ``objectstore_tool`` on a
    filestore and a kstore of 4 MiB objects, ``ceph_cli`` with a ``cuda``
    profile (docstring, phase 3o)."""
    from ceph_tpu_torch import objectstore
    from ceph_tpu_torch.osd.types import Transaction
    from ceph_tpu_torch.tools import (ceph_cli, monstore_tool,
                                      objectstore_tool, osdmaptool)

    out = {}
    mon0 = os.path.join(run_dir, "mon", "0")
    versions = json.loads(_tool(monstore_tool, [mon0, "show-versions"]))
    assert versions["last_committed"] > 0 and versions["stored_versions"] \
        > 0 and versions["uncommitted_v"] is None, versions
    paxos = _tool(monstore_tool, [mon0, "dump-paxos"]).splitlines()
    assert len(paxos) == versions["stored_versions"]
    assert [json.loads(line)["v"] for line in paxos] == sorted(
        json.loads(line)["v"] for line in paxos)
    keys = _tool(monstore_tool, [mon0, "dump-keys"]).splitlines()
    assert len(keys) > versions["stored_versions"], keys
    text = _tool(monstore_tool, [mon0, "get-osdmap"])
    osdmap = json.loads(text)
    pool = osdmap["pools"]["ecpool"]
    width = int(DAEMON_PROFILE["k"]) + int(DAEMON_PROFILE["m"])
    assert osdmap["max_osd"] == DAEMON_OSDS and \
        pool["k"] + pool["m"] == width, osdmap
    out["monstore"] = dict(versions, epoch=osdmap["epoch"])
    path = os.path.join(run_dir, "osdmap.json")
    with open(path, "w") as f:
        f.write(text)
    assert json.loads(_tool(osdmaptool, [path, "--print"])) == osdmap

    def table() -> dict:
        lines = _tool(osdmaptool, [path, "--test-map-pgs", "--pool",
                                   "ecpool"]).splitlines()
        assert lines[0] == f"pool ecpool pg_num {pool['pg_num']} size " \
            f"{width}" and lines[-1].endswith(" holes 0"), lines
        rows = {row.split("\t")[0]: int(row.split("\t")[1])
                for row in lines[2:-1]}
        assert len(rows) == DAEMON_OSDS and \
            sum(rows.values()) == pool["pg_num"] * width, rows
        return rows

    out["pgs_per_osd"] = table()
    line = _tool(osdmaptool, [path, "--test-map-object", "d0", "--pool",
                              "ecpool"])
    assert line.endswith(f" -> {d0_acting}\n"), (line, d0_acting)
    assert _tool(osdmaptool, [path, "--mark-out", str(victim)]).startswith(
        f"osdmaptool: osd_out osd.{victim}, epoch now ")
    assert table()[f"osd.{victim}"] == 0
    rs = np.random.RandomState(seed + 2700)
    out["objectstore"] = {}
    for kind in ("filestore", "kstore"):
        src = os.path.join(run_dir, "tools", kind)
        store = objectstore.create(kind, src)
        objs = {}
        for i in range(TOOLS_STORE_OBJECTS):
            oid = f"{kind}{i}@{i}"
            objs[oid] = rs.randint(0, 256, OBJECT, np.uint8).tobytes()
            store.queue_transaction(
                Transaction().write(oid, 0, objs[oid])
                .setattr(oid, "_size", OBJECT).setattr(oid, "_version", i + 1))
        store.umount()
        base = ["--data-path", src, "--type", kind, "--op"]
        assert sorted(_tool(objectstore_tool, [*base, "list"]).split()) == \
            sorted(objs)
        first = next(iter(objs))
        assert _tool(objectstore_tool, [*base, "info", "--oid", first]) == (
            f"oid: {first}\nsize: {OBJECT}\nattr _size: {OBJECT}\n"
            f"attr _version: 1\n")
        dump = src + ".dump"
        assert _tool(objectstore_tool, [*base, "export", "--file", dump]) \
            == f"exported {len(objs)} object(s) to {dump}\n"
        dst = src + "-imported"
        assert _tool(objectstore_tool, [
            "--data-path", dst, "--type", kind, "--op", "import", "--file",
            dump]) == f"imported {len(objs)} object(s) from {dump}\n"
        store = objectstore.create(kind, dst)
        try:
            assert sorted(store.list_objects()) == sorted(objs)
            for i, (oid, data) in enumerate(objs.items()):
                assert store.read(oid) == data and \
                    store.getattr(oid, "_version") == i + 1, \
                    f"tools: {kind} import of {oid} differs from its export"
        finally:
            store.umount()
        assert _tool(objectstore_tool, [*base, "remove", "--oid", first]) \
            == f"removed {first}\n"
        assert first not in _tool(objectstore_tool, [*base, "list"]).split()
        out["objectstore"][kind] = {"objects": len(objs),
                                    "dump_bytes": os.path.getsize(dump)}
    profile = TOOLS_PROFILE.split()
    with _environ({ceph_cli.STATE_ENV: os.path.join(run_dir, "cli.json")}):
        made = json.loads(_tool(ceph_cli, [
            "osd", "erasure-code-profile", "set", "flagship", *profile]))
        assert made == {"profile": "flagship", "chunk_count": 12,
                        "data_chunk_count": 8}, made
        made = json.loads(_tool(ceph_cli, [
            "osd", "pool", "create", "cardpool", "erasure", "flagship"]))
        assert made == {"pool": "cardpool", "profile": "flagship",
                        "chunk_count": 12, "data_chunk_count": 8}, made
        assert json.loads(_tool(ceph_cli, [
            "osd", "erasure-code-profile", "get", "flagship"])) == dict(
                kv.split("=", 1) for kv in profile)
        assert json.loads(_tool(ceph_cli, [
            "osd", "erasure-code-profile", "ls"])) == ["default", "flagship"]
        assert json.loads(_tool(ceph_cli, ["osd", "pool", "ls"])) == {
            "cardpool": {"pool_type": "erasure", "profile": "flagship",
                         "chunk_count": 12, "data_chunk_count": 8}}
        with contextlib.redirect_stderr(io.StringIO()):
            _tool(ceph_cli, ["osd", "erasure-code-profile", "rm",
                             "flagship"], rc=1)
        assert json.loads(_tool(ceph_cli, ["status"])) == {
            "health": "HEALTH_OK", "pools": 1, "profiles": 2}
        assert "zlib" in json.loads(_tool(ceph_cli, ["compression", "ls"]))
    return out


def _tools_bench(card: str) -> dict:
    """3o (a): ``rados_bench`` at its defaults (docstring, phase 3o)."""
    from ceph_tpu_torch.tools import rados_bench

    ref = registry_mod.instance().factory("jerasure", {
        key: val for key, val in rados_bench.parse_profile(
            TOOLS_PROFILE).items() if key != "plugin"})
    shape = (rados_bench.OSDS, rados_bench.OBJECTS, rados_bench.SIZE)

    async def run():
        cluster, payloads, results = await rados_bench.bench(
            *shape, rados_bench.parse_profile(TOOLS_PROFILE))
        try:
            launches = _w8_launches()
            check = _cluster_check(cluster, ref, payloads)
        finally:
            await cluster.shutdown()
        return results, launches, check

    cuda_gf.reset_launches()
    t0 = time.perf_counter()
    results, launches, check = _in_new_loop(run())
    seconds = {"cuda": time.perf_counter() - t0}
    assert launches > 0, "tools (a): gf2_matrix_w8 idle in rados_bench"
    rates = {row["phase"]: row["mb_s"] for row in results}
    assert [(row["objects"], row["size"]) for row in results] == \
        [shape[1:]] * 2, results
    print(f"[tools] (a) rados_bench --profile \"{TOOLS_PROFILE}\" at its "
          f"defaults ({shape[0]} OSDs, in-process ECCluster, {shape[1]} x "
          f"{shape[2] >> 20} MiB): {json.dumps(results[0])} "
          f"{json.dumps(results[1])}; gf2_matrix_w8 launches {launches}; "
          f"{check} ({seconds['cuda']:.1f} s); card {card}", flush=True)
    cuda_gf.reset_launches()
    t0 = time.perf_counter()
    lrc = [json.loads(line) for line in _tool(rados_bench, []).splitlines()]
    seconds["lrc"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    host = sum(cuda_gf.launches.values())
    assert host == 0 and [(row["phase"], row["objects"], row["size"])
                          for row in lrc] == [
        ("write", *shape[1:]), ("read", *shape[1:])], (host, lrc)
    print(f"[tools] (a) rados_bench with no arguments (its default "
          f"\"{rados_bench.PROFILE}\", whose generated layers are "
          f"jerasure's: the host, {host} kernel launches): "
          f"{json.dumps(lrc[0])} {json.dumps(lrc[1])} "
          f"({seconds['lrc']:.1f} s); card {card}", flush=True)
    return {"cuda": rates, "launches": launches, "check": check,
            "lrc": {row["phase"]: row["mb_s"] for row in lrc},
            "seconds": seconds}


def phase_tools(card: str, embedded: dict) -> dict:
    """The operator's command-line tools on the card (docstring, phase
    3o): (a) here, (b)-(d) inside 3n (a), whose results ``embedded``
    holds."""
    t_phase = time.perf_counter()
    out = {"bench": _tools_bench(card)}
    seconds = dict(embedded["seconds"], **{
        "(a) rados_bench": time.perf_counter() - t_phase})
    cli, off = embedded["cli"], embedded["offline"]
    pt = cli["put_transfers"]
    print(f"[tools] (b) rados_cli against 3n (a)'s {DAEMON_OSDS} OSD "
          f"processes, {cli['commands']} commands (one put and one get each "
          f"a process), {TOOLS_CLI_OBJECTS} x {OBJECT >> 20} MiB put, one "
          f"removed, the others in 3n (a)'s shard check; health "
          f"{cli['health']}, {cli['log_lines']} log lines, "
          f"{cli['trace_spans']} spans of one trace; residency h2d/d2h ops "
          f"per OSD in the puts "
          f"{json.dumps({i: [d['h2d_ops'], d['d2h_ops']] for i, d in pt.items()})}"
          f" ({seconds['(b) rados_cli']:.1f} s); card {card}", flush=True)
    print(f"[tools] (c) ceph_volume: {embedded['activated']} (3n (a)'s "
          f"SIGKILLed OSD prepared and activated on its {DAEMON_STORE}, "
          f"its codec built on the card before it listened, "
          f"{seconds['(c) activate']:.1f} s); prepare, a refused second "
          f"prepare, an activate without a cluster and list on a fresh run "
          f"directory; card {card}", flush=True)
    ms, st = off["monstore"], off["objectstore"]
    print(f"[tools] (d) monstore_tool on mon.0's store: last_committed "
          f"{ms['last_committed']}, {ms['stored_versions']} versions, "
          f"get-osdmap epoch {ms['epoch']}; osdmaptool on that map: "
          f"--test-map-pgs {json.dumps(off['pgs_per_osd'])}, "
          f"--test-map-object d0 == the client's acting set, --mark-out; "
          f"objectstore_tool list / info / export / import / remove on "
          f"{json.dumps(st)} ({TOOLS_STORE_OBJECTS} x {OBJECT >> 20} MiB "
          f"each, imported == exported); ceph_cli with \"{TOOLS_PROFILE}\" "
          f"(chunk_count 12) ({seconds['(c, d) offline']:.1f} s); card "
          f"{card}", flush=True)
    out.update(seconds=seconds, cli={key: val for key, val in cli.items()
                                     if key != "objects"},
               activated=embedded["activated"], offline=off,
               volume=embedded["volume"])
    total = sum(seconds.values())
    print(f"[tools] phase {total:.1f} s ((a) here, (b)-(d) inside 3n (a): "
          f"{json.dumps({k: round(v, 1) for k, v in seconds.items()})}; "
          f"budget {TOOLS_BUDGET_S:.0f} s "
          f"{_held(total <= TOOLS_BUDGET_S)}); gf2_matrix_w8 launches in "
          f"rados_bench {out['bench']['launches']}; card {card}", flush=True)
    out["total_seconds"] = total
    return out


def phase_ec_benchmark(card: str) -> None:
    argv = ["-p", "cuda", "-s", str(STRIPE), "-i", "3", "-b", "8",
            "-w", "decode", "--erased", "1", "--erased", "6",
            "-P", f"k={K}", "-P", f"m={M}"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ec_benchmark.main(argv)
    out = buf.getvalue().strip().splitlines()
    assert rc == 0, f"ec_benchmark exited {rc}: {out}"
    seconds, kib = out[-1].split("\t")
    gibs = int(kib) / 2**20 / float(seconds)
    print(f"[ec_benchmark] {' '.join(argv)} -> {out[-1]!r} "
          f"({gibs:.3f} GiB/s decode; card {card})", flush=True)
    argv = ["-p", "cuda", "-w", "storage-path", "--objects", "32", "-s",
            str(OBJECT), "--writers", str(WRITERS), "--profile",
            "-P", f"k={K}", "-P", f"m={M}"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ec_benchmark.main(argv)
    out = buf.getvalue().strip().splitlines()
    assert rc == 0, f"ec_benchmark exited {rc}: {out}"
    prof = json.loads(out[-1])
    assert prof["bit_exact"] is True and \
        prof["steady_library_builds"] == {"per_op": 0, "coalesced": 0}, prof
    print(f"[ec_benchmark] {' '.join(argv)} -> {out[-1]}; card {card}",
          flush=True)
    # the recovery and repair paths: ``-w recovery-path`` and ``-w
    # repair-path``'s benches called directly, at the tool's shapes, with
    # their host-timing gates at the JAX package's test limits (each
    # figure printed beside its default gate)
    from ceph_tpu_torch.osd.recovery_bench import run_recovery_path_bench
    from ceph_tpu_torch.osd.repair_bench import run_repair_path_bench

    rec = run_recovery_path_bench(n_objects=32, obj_bytes=OBJECT,
                                  client_p99_bound_ms=RECOVERY_P99_LIMIT_MS)
    assert rec["bit_exact"] is True and \
        rec["batched"]["counters"]["recovery_ops_batched"] > 0, rec
    p99 = rec["batched"]["client_p99_ms"]
    print(f"[ec_benchmark] recovery-path 32 x {OBJECT} B -> "
          f"{json.dumps(rec)}; client p99 {p99} ms vs the default gate "
          f"{RECOVERY_P99_GATE_MS} "
          f"{'held' if p99 <= RECOVERY_P99_GATE_MS else 'MISSED'} (run at "
          f"{RECOVERY_P99_LIMIT_MS}); card {card}", flush=True)
    cfg = get_config()
    prior = cfg.get_val("osd_recovery_batch_bytes")
    cfg.apply_changes({"osd_recovery_batch_bytes": REPAIR_BATCH_BYTES})
    try:
        rep = run_repair_path_bench(n_objects=REPAIR_OBJECTS,
                                    obj_bytes=OBJECT,
                                    time_ratio_bound=REPAIR_TIME_RATIO_LIMIT)
    finally:
        cfg.apply_changes({"osd_recovery_batch_bytes": prior})
    assert rep["bit_exact"] is True and rep["repair_bytes_ratio"] <= 0.75, \
        rep
    assert rep["fractional"]["rebuild_launches"]["gf2_matrix_w8"] > 0, \
        f"repair-path: gf2_matrix_w8 not launched in the fractional " \
        f"rebuild {rep['fractional']['rebuild_launches']}"
    ratio = rep["time_to_clean_ratio"]
    print(f"[repair] time-to-clean ratio {ratio} vs the default gate "
          f"{REPAIR_TIME_RATIO_GATE} "
          f"{'held' if ratio <= REPAIR_TIME_RATIO_GATE else 'MISSED'} (run "
          f"at {REPAIR_TIME_RATIO_LIMIT}); gather ratio "
          f"{rep['repair_bytes_ratio']} (gate 0.75); card {card}",
          flush=True)
    for mode in ("classic", "fractional"):
        r = rep[mode]
        print(f"[repair] {mode}: gather {r['gather_bytes']} B (ratio "
              f"{rep['repair_bytes_ratio']} fractional / classic), time to "
              f"clean {r['time_to_clean_s']} s (ratio "
              f"{rep['time_to_clean_ratio']}), helper symbols served "
              f"{r['counters']['regen_helpers_served']}, rebuilt "
              f"{r['rebuilt_bytes']} B, drain {r['drain']}, rebuild "
              f"launches {json.dumps(r['rebuild_launches'])}; card {card}",
              flush=True)
    print(f"[ec_benchmark] repair-path {REPAIR_OBJECTS} x {OBJECT} B -> "
          f"{json.dumps(rep)}; card {card}", flush=True)
    argv = ["-w", "tier-path", "--objects", "8", "-s", str(OBJECT),
            "-i", "2", "-e", "2", "-P", f"k={K}", "-P", f"m={M}"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ec_benchmark.main(argv)
    out = buf.getvalue().strip().splitlines()
    assert rc == 0, f"ec_benchmark exited {rc}: {out}"
    tier = json.loads(out[-1])
    assert tier["bit_exact"] is True and tier["resident_bytes"] == \
        8 * (K + M) * OBJECT // K, tier
    assert set(tier) == {"n_objects", "obj_bytes", "k", "m", "erasures",
                         "bit_exact", "resident_bytes", "tier_hits",
                         "hot_read_GiBs", "cold_read_GiBs",
                         "read_speedup"}, tier
    print(f"[ec_benchmark] {' '.join(argv)} -> {out[-1]}; card {card}",
          flush=True)
    # the wire workloads through the tool: the JAX tool's keys, with the
    # port's wire_codec and library-build keys beside them
    for argv, keys in (
        (["-w", "cluster-path", "--objects", "8", "-s", str(OBJECT),
          "-P", f"k={K}", "-P", f"m={M}"],
         {"n_objects", "obj_bytes", "writers", "n_osds", "k", "m",
          "bit_exact", "per_message", "corked", "write_speedup",
          "read_speedup", "wire_per_message", "wire_corked",
          "wire_write_speedup", "steady_library_builds", "wire_codec"}),
        (["-w", "mesh-path", "--objects", "8", "-s", str(OBJECT),
          "-P", f"k={K}", "-P", f"m={M}", "--mesh-sizes", "1,2"],
         {"n_objects", "obj_bytes", "writers", "k", "m", "mesh_sizes",
          "bit_exact", "results", "wire_bytes_avoided", "wire_bytes_sent",
          "encode_GiBs", "write_MiBs", "speedup_vs_mesh1", "speedup_4x",
          "speedup_max", "tcp_only_vs_mesh_max", "steady_library_builds",
          "wire_codec"})):
        buf = io.StringIO()
        cuda_gf.reset_launches()
        with contextlib.redirect_stdout(buf):
            rc = ec_benchmark.main(argv)
        launches = _w8_launches()
        out = buf.getvalue().strip().splitlines()
        assert rc == 0, f"ec_benchmark exited {rc}: {out}"
        got = json.loads(out[-1])
        assert set(got) == keys and got["bit_exact"] is True and \
            got["wire_codec"] == "native" and launches > 0, got
        print(f"[ec_benchmark] {' '.join(argv)} -> {out[-1]}; "
              f"gf2_matrix_w8 launches {launches}; card {card}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    # the XOR network: one library per bitmatrix (the sweep's, phase 5's
    # second and those of its edge shapes)
    networks = {sweep_gf.make_xornet(bits, k, m).generated: None
                for bits, k, m in (
                    (_sweep_bits(), K, M), (_code_bits("cauchy_good", K, M),
                                            K, M),
                    *((c[1], c[2], c[3]) for c in _xornet_edge_cases()))}
    builds = ((cuda_gf.SOURCE.name, None), (sweep_gf.SOURCE, None),
              *((sweep_gf.XORNET_SOURCE, gen) for gen in networks))
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = list(pool.map(lambda b: cuda_gf.build(*b), builds))
    print(f"[build] {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc "
          f"{' '.join(cuda_gf.NVCC_FLAGS)})", flush=True)
    for lib in libs:
        print(cuda_gf.build_logs.get(lib.name, "").strip(), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi

    print(f"[phase] 1 build {time.perf_counter() - t0:.1f} s", flush=True)

    def timed(name, phase, *phase_args):
        t_phase = time.perf_counter()
        out = phase(*phase_args)
        print(f"[phase] {name} {time.perf_counter() - t_phase:.1f} s",
              flush=True)
        return out

    reg = registry_mod.instance()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    kernels = timed("2 kernels", phase_kernels, reg, dev, gen, flush)
    timed("2 codec_edges", phase_codec_edges, dev, gen)
    kernels.update(timed("2 sweep_kernels", phase_sweep_kernels, dev, gen,
                         flush))
    timed("2 sweep_edges", phase_sweep_edges, dev, gen)
    del flush
    per_profile = timed("3 main_path", phase_main_path, reg,
                        np.random.RandomState(args.seed), card)
    launched = dict(cuda_gf.launches)
    storage = timed("3b storage_path", phase_storage_path, reg, args.seed,
                    card)
    cluster = timed("3c cluster_path", phase_cluster_path, args.seed, card)
    tier = timed("3d tier_path", phase_tier_path, reg, args.seed, card)
    family = timed("3e plugin_family", phase_plugin_family, reg, args.seed,
                   card)
    native = timed("3f native_tools", phase_native_tools, args.seed, card)
    durable = timed("3g durable", phase_durable, args.seed, card)
    mesh = timed("3h mesh_plane", phase_mesh_plane, args.seed, card)
    control = timed("3i control_plane", phase_control_plane, args.seed,
                    card)
    wire = timed("3j wire", phase_wire, card)
    native_wire = timed("3k native_wire", phase_native_wire, card)
    osdc = timed("3l osdc", phase_osdc, args.seed, card)
    services = timed("3m services", phase_services, args.seed, card)
    daemons = timed("3n daemons", phase_daemons, args.seed, card)
    tools = timed("3o tools", phase_tools, card,
                  daemons["cluster"].pop("tools"))
    timed("4 ec_benchmark", phase_ec_benchmark, card)
    launched.update(timed("5 sweep", phase_sweep, card))
    launched.update(timed("6 probes", phase_probes, card))

    for name, row in kernels.items():
        row["launches"] = launched[name]
        assert row["launches"] > 0, f"{name} never launched on its path"
    print(json.dumps({"main_path": per_profile}))
    print(json.dumps({"storage_path": storage}))
    print(json.dumps({"cluster_path": cluster}))
    print(json.dumps({"tier_path": tier}))
    print(json.dumps({"plugin_family": family}))
    print(json.dumps({"native_tools": {
        key: val for key, val in native.items() if key != "sweep"}}))
    print(json.dumps({"durable_path": durable}))
    print(json.dumps({"mesh_path": mesh}))
    print(json.dumps({"control_path": control}, default=str))
    print(json.dumps({"wire_path": wire}, default=str))
    print(json.dumps({"native_wire_path": native_wire}, default=str))
    print(json.dumps({"osdc_path": osdc}, default=str))
    print(json.dumps({"services_path": services}, default=str))
    print(json.dumps({"daemons_path": daemons}, default=str))
    print(json.dumps({"tools_path": tools}, default=str))
    print(smi)
    print(json.dumps({"kernels": [
        {key: row[key] for key in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for row in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
