#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``metrics_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs a CUDA device and ``nvcc`` (``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``)
and exits non-zero, printing no result, without them. Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels K1–K9 from ``metrics_tpu_torch/ops/kernels/csrc``
   (one ``nvcc`` per source, all started together);
3. hold K1–K3 against their plain PyTorch versions on the card: at the shapes
   the main path gives them, on edge cases, and through their
   ``torch.func.vmap`` rules at a 1024-row bucket; then time kernel, plain
   version and (where one PyTorch call computes the same function) that call
   at each shape the main path launches: K1 at the masked step's leaves over
   a 1024-row bucket (1000 f32, 100, 10 and 1 int32 columns), K2 at the
   vmapped confusion matrix's (B, 1) int64 indices into 100 bins and at the
   one-shot (16 384,) batch, with the whole call's time, host µs and device
   launches beside the kernel's, K3 at the one-shot (16 384, 10) batch and at
   the vmapped (1, B*10) row, each against 100 thresholds; B is 64, 256 and
   1024, the engines' buckets;
4. the main path: the flagship collection (Accuracy, macro F1, binned AP over
   100 thresholds, confusion matrix; 10 classes) updated over 65 536 rows in
   batches, then computed; held against the same collection on the CPU and
   against numpy oracles for every count;
5. the masked bucket step: the same rows as ragged 1024-row buckets padded
   with garbage through ``update_state_masked``; its state must equal phase 4's;
6. hold K4–K7 (segment reduce, megastep fold, megastep segment and its q8
   decode) against their plain versions on edge cases and, exactly, at the
   engine's shapes, and time them there: K5 at the flagship arena's two
   buffers (3000 f32 and 146 int32 columns) over 1024- and 256-row buckets;
   K4, K6 and K7 once with random ids
   and once as the one-stream step the engines send (every unmasked row in
   one segment; K4 at a 1000- and a 10-column leaf), each also held exactly
   against ``index_add`` and K7 bit-identical to K6 on a host-decoded state;
7. ``StreamingEngine`` under ``kernel_backend="megastep"`` over the same rows
   as ragged 16–1024-row batches: bit-equal to phase 4, two K5 launches per
   step (one per arena dtype) and no K1;
8. the unsharded ``MultiStreamEngine``: 64 streams, Zipf(1.05) stream ids,
   the same rows in 16–1024-row batches; every stream bit-equal to a numpy
   oracle over its rows; K4 on every step;
9. the paged ``MultiStreamEngine``: 10 000 streams, Zipf(1.05), 128 resident
   slots, 8–64-row batches, so rows spill and page back in; (a) exact under
   ``"megastep"``, bit-equal to the per-stream oracle, coalescing queued
   batches across streams, and once more with ``coalesce=1`` for the step
   count without coalescing; (b) binned AP quantized ``q8_block`` with
   ``compress_payloads=True``: K7 decodes staged slots, int states exact;
   (c) (b)'s twin that decodes on the host instead: bit-identical to (b).
   (b) and (c) keep ``coalesce=1``: grouping follows timing, and a q8 spill
   taken at another step quantizes differently. Phases 8 and 9a end with one
   batched ``results()`` (every stream's value from one vmapped compute),
   held against ``result()`` of each of 64 (8) or 200 sampled (9a: resident,
   spilled and never-touched) streams and timed against that loop;
10. the classification dashboard (macro Precision, Recall and Specificity,
   HammingDistance, JaccardIndex, CohenKappa, MatthewsCorrCoef, HingeLoss)
   on the same rows, its launch counts set to 0 before it: (a) eager in
   4 batches, with ``CalibrationError(n_bins=15)`` in all three norms (K2's
   weighted form, one launch per ``compute``), ``KLDivergence`` against a
   second seeded distribution and ``dice_score``; counts equal to numpy's and
   to the CPU port's, the hinge measure, KL and calibration errors within
   the reassociation bounds of float64 oracles, other values within 1e-6
   relative; then through the per-leaf masked bucket step (K1); (b) the
   captured megastep ``StreamingEngine`` of phase 7 (two K5 and three K2
   launches a step); (c) the captured paged ``MultiStreamEngine`` of phase 9a
   (two K6 and three K2 launches a step), its 200 sampled streams against
   numpy, then one ``results()``; (d) the times of (a)-(c) and of that
   ``results()`` beside the per-stream loop;
11. the exact curves on the same rows, their launch counts set to 0 before
   them: (a) eager in 4 batches, AUROC macro and weighted (its class support
   one K2 launch), the binary AUROC of class 0 up to fpr 0.3, AP macro, ROC,
   the PR curve, AUC of class 0's ROC, ``BinnedRecallAtFixedPrecision`` (K3)
   and the aggregators, with ``AUROC``/``AveragePrecision(capacity=65 536)``;
   each value within its stated f32 bound of a float64 oracle
   (Mann-Whitney AUROC from ``scipy.stats.rankdata``, step AP), curves and
   counts bit-equal to the CPU port's; (b) the flagship collection plus
   ``AUROC`` and ``AveragePrecision(num_classes=10, capacity=65 536)``
   through phase 7's captured megastep ``StreamingEngine``: the scan members
   demote every arena dtype (the JAX package's fallback reasons, no K5),
   their buffers bit-equal to the CPU port's eager capacity update, the
   flagship's states to phase 4's, with capture seconds, host ms per step
   and one 1024-row bucket's device µs and launches; an uncaptured twin on a
   prefix of the batches, bit-equal too; (c) both forms of
   ``MultiStreamEngine`` refuse the scan members with the JAX package's
   reason;
12. wrappers and composition on the same rows, their launch counts set to 0
   before them: (a) eager in 4 batches, each against a numpy oracle:
   ``MinMaxMetric`` over macro F1 (the prefix extremes, and with
   ``fold_on_compute``), ``MultioutputWrapper`` over two heads with NaN rows
   removed, ``BootStrapper`` (10 replicas, poisson from the same seeded
   numpy draws, multinomial from a generator in the same state: replica
   counts exact, mean, std, median and raw within 1e-6), the composition
   ``2 * P * R / (P + R)`` of macro Precision and Recall (its harmonic mean;
   per class against ``F1Score(average="none")``), a scalar operand, a
   comparison, an index, and ``MetricTracker`` over the flagship collection
   for 3 epochs with ``best_metric(return_step=True)``; (b) the flagship plus
   that composition and a multinomial ``BootStrapper`` through phase 7's
   captured megastep ``StreamingEngine`` (three K5 launches a step: f32,
   int32 and the uint32 draw counter), with its uncaptured twin, a warm twin
   that captures nothing and a profile of a 1024-row bucket, and through
   phase 9a's captured paged ``MultiStreamEngine`` (an uncaptured twin on its
   first 230 batches; its sums over streams and 23 streams against numpy);
   ``MultioutputWrapper(remove_nans=False)`` through the megastep engine on
   two-head rows; every integer state, children included, bit-equal to the
   twins and to numpy (each occurrence of a shared operand counts every row
   twice; each replica sees each row once; ``draw_count`` counts the rows);
   (c) both engines refuse ``MinMaxMetric`` with the JAX package's reason,
   and a masked update of ``MultioutputWrapper(remove_nans=True)`` raises;
13. regression and pairwise on 65 536 seeded rows (gamma(2, 1) targets, the
   targets times log-normal noise as predictions), their launch counts set
   to 0 before them: (a) each of the 11 regression metrics over 4 batches
   and each functional over every row, Tweedie at powers 0, 1, 1.5, 2 and
   3, against float64 numpy: every f32 sum within 2^-24 (2 n Σ|term| +
   8 Σ parts) of the exact one, counts exact, each value within 1e-6
   relative plus the move its sums' bounds allow; Pearson (also as Chan's
   fold of 4 hand-stacked shards), Spearman and the cosine similarity within
   1e-5 of scipy and numpy; the eight served members through the masked
   bucket step (K1), padded with rows outside every domain; (b) the eight
   members whose value is served (MSE, RMSE, MAE, MSLE, MAPE, SMAPE,
   ExplainedVariance, Tweedie at 1.5) and R2Score alone through phase 7's
   captured megastep engine (two K5 a step), phase 8's unsharded engine (K4
   per leaf) and phase 9a's paged one (two K6 a step), one batch a step,
   each first over an uncaptured twin's prefix (bit-equal), every stream's
   states within their bounds of the per-stream oracle, the values of
   ``result()`` and of one timed ``results()`` against the oracle's, and
   R2Score's served ``result()``/``results()`` raising; a profile of one
   1024-row bucket; (c) the engines refuse Pearson, Spearman and
   CosineSimilarity with the JAX package's reasons; (d) the pairwise
   cosine, linear and euclidean at (8192, 512) x (8192, 512) and manhatten
   at (1024, 512) x (1024, 512) against float64 numpy on sampled rows.
14. Cross-process sync on ``torch.distributed``: (a) NCCL at world 1 on the
   card: the flagship collection plus capacity AUROC and AP over phase 4's
   rows, and phase 13's eight served members plus Pearson and a
   ``MinMaxMetric`` of an MSE (the min/max bucket) with the MSE's sum on the
   q8 carrier, over phase 13's rows, update on the card (K2, K3); each
   metric's eager ``sync()`` (forced at world 1) and one fused
   ``sync_states`` bundle per collection, whose collectives are counted
   against ``fused_sync_plan``; every value equals the unsynced one bit for
   bit (the flagship's states equal phase 4's), the q8 leaf its one-rank
   round trip; (b) two spawned processes on the same card, world 2 over
   gloo with the CUDA tensors themselves (gloo takes every dtype the bundle
   sends), each updating on half the rows: the merged states equal (a)'s,
   integers, buffers and min/max bit for bit, f32 sums within the
   reassociation bound, the q8 sum within ``q8_sum_error_bound``, and every
   rank's eager ``compute()`` gives (a)'s values. NCCL at world > 1 is not
   run: one card takes one NCCL rank. The phase line holds the collectives
   per sync, the payload bytes exact and with q8, host ms per sync (median
   of 20) at world 1 and 2, and the K2/K3 launches.
15. The compiled forward (``Metric.forward``, ``MetricCollection.forward``:
   one CUDA graph per input signature, ``engine/aot.py``'s
   ``CapturedForward``), each owner against an eager twin (the same metric
   with the compiled path off) over the same batches: (a) the flagship
   collection through ``coll(preds, target)`` over phase 4's rows as 64
   forwards of 1024 rows: the first runs eagerly, the second captures one
   fused graph, which serves 63 of the 64; every batch value bit-equal to
   the twin's, the final states bit-equal to phase 4's, ``compute()`` equal
   to phase 4's values, K2 and K3 launches credited per replay; (b)
   ``BinnedAveragePrecision`` alone over the same batches (the single
   metric's step, K3); (c) phase 13's eight members plus ``R2Score`` as a
   collection over phase 13's rows: the fused step fails (R2Score's compute
   reads ``n_obs`` on the host), each member takes its own graph, R2Score
   stays eager-only, the entry kinds equal to the JAX package's; (d) the
   deferred checks: a ``ConfusionMatrix`` batch with ``target ==
   num_classes`` and a Tweedie (power 1.5) batch with a negative target on
   the captured path: ``forward`` returns, every ``compute()`` raises the
   JAX package's message until ``reset()``; (e) a metric whose update reads
   the device on the host is refused in the warm-up, before any capture, and
   one that reads only while a capture runs gets past the warm-up and breaks
   its capture: each ends eager-only, its state equal to the twin's; a graph
   that draws random numbers, captured before, still follows
   ``manual_seed`` and draws apart from eager draws; (a)'s graph still
   replays right, and the ``compute()`` result kept from (a) (the confusion
   matrix's state tensor itself) keeps its values. The phase line holds captures, replays, eager-only
   signatures and capture seconds, host ms per forward (median over the
   replays, the device drained after each call) against the twin's, the
   device launches and µs of one forward captured and eager (profiler), the
   memory the capture kept, and the K2/K3 launches.
16. Snapshots and the restore matrix (``engine/snapshot.py``), through the
   captured engines: (a) phase 7's megastep engine and traffic with
   ``snapshot_every=16``, killed after batch 80, a fresh engine sharing its
   ``AotCache`` restored (the cursor 80, every state buffer at its address)
   and replayed: states bit-equal to phase 4's (counts), values within 1e-6,
   no capture; (b) phase 9's q8-staged tenancy (``coalesce=1``) snapshotted
   halfway with rows spilled and 8 spilled streams staged as int8 codes,
   served to the end, the snapshot restored into 128 slots, into 256 and
   merged into an unsharded engine, each replaying the second half: every
   staged row as it was before staging, integer states bit-equal to the
   uninterrupted run's, the q8-policy counts within the codec's bound
   (``snapshot_paged``), count-derived values of every 7th stream equal;
   (c) ``corrupt_snapshot`` on (a)'s LATEST: the restore falls back one
   generation (cursor 64) and the replay is bit-equal; (d) host ms and bytes
   on disk of one ``snapshot()`` and one ``restore()`` for (a) (into a fresh
   and into the live captured engine, which keeps its buffers and captures
   nothing) and (b) (each target), and phase 7's host ms per captured step
   with the cadence against without, warm, in turns. Snapshots are written
   under the gitignored ``build/phase16/``, removed after the phase.
17. The chaos sweep (``engine/faults.py`` wired through the engines), at
   full width: (a) phase 7's megastep engine and traffic, plus a 2-row NaN
   batch at cursor 2, with ``coalesce=8``, NaN quarantine and
   ``snapshot_every=16`` under the JAX package's chaos plan
   (``metrics_tpu/engine/chaos_smoke.py:127-225``: ``coalesce`` at rate 1,
   ``ingest``, ``compile``, ``step``, ``watchdog``, ``snapshot_write`` and
   ``snapshot_corrupt`` on the last good save, with ``kernel`` moved from
   occurrence 0 to 8 so that K5 launches before the demotion): states
   bit-equal to phase 4's, one ``megastep -> auto`` demotion (K5 before it,
   K1 after it), the recovery counters as JAX's smoke checks them, one
   quarantine record at cursor 2 with 2 rows, every state buffer at its
   address; then killed and restored past the corrupt LATEST with a
   transient ``snapshot_read`` (cursor 96) and replayed, bit-equal; (b)
   phase 9's q8 tenancy (``coalesce=1``) under ``page_out``, ``page_in``,
   ``quant_encode``, ``quant_decode`` and a ``kernel`` fault at the first
   step past the middle whose slots hold staged rows: every stream bit-equal
   to its fault-free twin, K6 and K7 before the demotion and K4 after it;
   (c) a device sleep of 0.15 s on the idle engine's stream ahead of one
   batch, the watchdog at 0.1 s: one expiry, one rollback, one retry,
   bit-equal to the twin; (d) a fatal ``dispatcher_kill`` on the first
   group: ``submit(timeout=0.5)`` raises ``EngineDispatchError``,
   ``reset()`` re-arms, phase 7's traffic gives phase 4's states; (e) host
   ms a warm captured step for phase 7's traffic plain, transactional (an
   empty-plan injector), drained (the watchdog site armed, no deadline) and
   with ``step_timeout_s=1.0``, in turns, and the device µs of one shadow
   copy of the flagship arena and of the paged 128-slot arena. Snapshots
   under the gitignored ``build/phase17/``, removed after the phase.
18. Observability and overload (``engine/trace.py``, ``engine/stats.py``,
   ``engine/admission.py``): (a) phase 7's engine and traffic with a
   ``TraceRecorder`` on the card (its histogram folds launch K2 on a stream of
   their own): the exported Chrome trace passes ``tools/trace_export.py``'s
   ``validate_chrome_trace`` and ``validate_links`` (each submit absorbed
   once, at least one real megabatch), ``metrics_text()`` passes
   ``parse_openmetrics`` with the step histogram's bucket sum, its count and
   the engine's steps equal, the telemetry document renders through
   ``tools/engine_report.py --json``, states bit-equal to phase 4's; host ms
   a warm captured step with the recorder off and on, in turns, and the
   scrape's K2 launches; (b) the chaos plans of phase 17 (its 14 ported
   sites: 17(a)'s on phase 7's engine with the restore past the corrupt
   LATEST, 17(b)'s on the first 320 batches of phase 9's q8 tenancy with the
   ``kernel`` fault at step 260, 17(d)'s kill read back by ``flush()``) run
   twice, each into a fresh recorder and capture cache: identical
   ``canonical_sequence()``, bit-identical states, every firing a ``fault``
   event; (c) phase 9's paged tenancy (exact, ``coalesce=1``, a flush after
   each submit so the ladder ticks once a batch) on the port's
   ``zipf_stream_ids`` with the hot set rotated by S // 2 at the middle
   batch, an ``AdmissionPolicy`` whose shed class is every 16th stream, a
   ``DegradationLadder`` on ``widen_coalesce``, ``defer_cold_reads`` and
   ``shed`` (up after 8 overloaded ticks, down after 4) with an
   ``OverloadDetector`` armed on the spill rate only: the ladder reaches
   ``shed`` after the shift, a shed-class submit raises ``AdmissionRejected``
   with ``shed`` set, a cold stream's repeated ``result()`` is served from
   the cache, a 24-batch recovery tail over resident streams walks the
   ladder down and the class admits again; every one of the 10 000 streams
   bit-equal to numpy over exactly the admitted batches; ``page_in`` and
   ``page_out`` spans present. Then K2 at the recorder fold's shape is held
   against its plain version and ``torch.bincount`` and timed (outside the
   phase's counts).
19. Windows and drift (``engine/windows.py``, ``engine/tracker.py``), every
   engine on the card against engines on the card: phase 7's cumulative
   megastep engine first captures its two steps into a shared cache, which
   every engine of (a), (b), (e) and the timing then replays, capturing
   nothing: a ring's step is that graph, handed the current pane's row.
   (a) phase 7's traffic under ``tumbling(16 batches, 3 panes)``: at each
   pane's close the ring's row of that pane bit-equal to a fresh engine's
   state over the pane's batches (the ring wraps, so rows are cleared and
   reused), the open pane's ``result()`` to a fresh engine's; (b) the same
   under ``sliding(3 panes)``: ``result()`` in the middle of every pane
   bit-equal to a fresh engine over the live panes' batches; (c) zero
   captures across (a)'s 7 rotations; (d) phase 9's q8 tenancy (10 000
   streams, 128 slots, ``coalesce=1``) on its first 800 batches under
   ``sliding(2 panes of 300 batches)``: each (stream, pane) its own pager
   row, pane rows spilled and paged back in as int8 codes (K7), 200 sampled
   streams' two pane rows against numpy over each pane's rows (integer
   states exact), 20 streams seen only before the window all-zero; (e)
   (b)'s engine with ``snapshot_every=24`` killed after batch 90, a fresh
   engine restoring cursor 72 (half a pane into the ring) and replaying:
   ring and value bit-equal to (b)'s, no capture; (f) the JAX package's
   seeded label-drift traffic (``zipf_traffic(4, 72, drift_at=36)``)
   through a tumbling megastep engine with a ``DriftDetector``: at least one
   raise, two card runs and one CPU run with the same histories and alarms,
   one evaluation per rotation; (g) a mean and a sum of phase 7's class-0
   scores (rounded to 1/64) under ``ewma(alpha=0.5, 8 batches)`` against the
   hand-decayed float64 accumulation within (folds + decays) * 2^-24
   relative, one decay per rotation. Then host ms per warm captured step of
   phase 7's traffic, a cumulative engine and its sliding twin in turns.
   Snapshots under the gitignored ``build/phase19/``, removed after the
   phase.
20. Retrieval and ragged serving (``retrieval/``, ``engine/ragged.py``) at
   the scale of ``metrics_tpu/engine/ragged_bench.py``: (a) its Zipf
   traffic (``zipf_traffic(512, 240, alpha=1.05, seed=23)``, capacity the
   power of two at or above the hottest group) through
   ``RaggedEngine(RetrievalMAP())`` with buckets (8, 24) and captured steps,
   and through a CPU twin (plain versions): states bit-equal, every
   group's ``results()`` value within 1e-6 of the CPU functional and the
   twin, the device ``aggregate()`` within 1e-6 relative of its oracle and
   of the eager metric on the card and on the CPU, four K1 launches an
   aggregate; ``reset()`` and a replay that captures nothing; ingest rows/s,
   host ms a warm captured step, aggregate and oracle ms; (b) the same with
   ``RetrievalNormalizedDCG(k=10)`` on graded targets; (c) the device
   aggregate against the oracle at G = 512, 10^4 and 10^5 groups of two
   rows, capacity 16; (d) 10^6 groups, 200 000 Zipf(1.2) rows clipped to
   capacity 16 at the source (seed 37), ``group_shard`` with 8192 resident
   and buckets (256, 1024): the sweep's K4 blocks are one per 1024 touched
   groups, its value the eager segment path's; (e) tumbling and sliding
   rings, unsharded and ``group_shard``, against the oracle and the eager
   window; a kill after batch 120 and a resume bit-equal to the straight
   run; a non-ragged snapshot and a capacity mismatch refused. Then K1 at
   ``()`` <- ``(G,)`` for G in {512, 10^5, 10^6} and K4 at ``(10^6, 3)`` <-
   1024 rows are timed against their plain versions and ``torch.sum``/
   ``index_add``. Snapshots under the gitignored ``build/phase20/``.
21. The text domain (``text/``, ``functional/text/``) on a seeded MT corpus
   at a WMT newstest set's size: 2 000 pairs of 5-60 words from a Zipf(1.1)
   vocabulary of 5 000 words, about 15 % of the hypothesis words edited.
   (a) one ``MetricCollection`` on the card (WER, CER, MER, WIL, WIP, BLEU
   n=4, SacreBLEU ``13a``, chrF++, ROUGE 1/2/L/Lsum, stemmed only where
   nltk imports) in 64-pair updates, SQuAD on 2 000 QA pairs drawn from the
   corpus and TER on its first 200 pairs, against CPU twins over the first
   500 pairs (TER: its 200): every state bit-equal, values within 1e-6;
   host ms per update of each metric. (b) the edit-distance library built
   by the port from ``metrics_tpu_torch/native/levenshtein.cpp`` with g++
   into ``build/kernels/``: its batch and beam distances over the 2 000
   pairs equal to the plain Python DPs; pairs/s of each. (c) BERTScore
   through ``bert_score`` with a BERT-base-width encoder written here in
   plain torch (the published ``bert-base-uncased`` config: vocab 30 522,
   hidden 768, 12 layers, 12 heads, FFN 3 072, GELU, post-LN, eps 1e-12),
   its seeded numpy weights in the Flax layout carried in through
   ``bert_state_dict_from_flax``, at ``max_length=128``, ``batch_size=64``,
   with and without idf: tokenize, encoder and matching ms and encoder
   batches; the first 8 pairs against the same weights on the CPU within
   1e-4 (TF32 off); the card's embeddings of the whole corpus matched on
   the card and on the CPU within 1e-5. The text path launches none of
   K1-K7 (JAX's runs no Pallas kernel there): its counts must stay 0.
22. Audio and the signal-level image metrics (``audio/``, ``image/``,
   ``functional/audio``, ``functional/image``). (a) Speech separation at
   WSJ0-2mix's evaluation form: 512 seeded two-speaker mixtures of 4 s at
   8 kHz, ``(512, 2, 32 000)`` f32 (formant-shaped noise under a 3-6 Hz
   syllable envelope, a fifth silent; estimates with 10-20 % leakage of
   the other speaker and white noise at 5-25 dB; speaker order swapped in
   half), 32 updates of 16 into one ``MetricCollection`` on the card (SNR,
   SI-SNR, SI-SDR, SDR with ``filter_length=512``, PIT over SI-SNR and over
   that SDR, STOI, ESTOI): host and device ms per update of each; its CPU
   twin over the first 64 mixtures (totals bit-equal and int32), per-signal
   scores card vs CPU (SNR family 1e-3 dB, SDR 1e-2 dB, STOI 1e-4, PIT's
   permutations identical), PIT finding the swapped half; three forwards
   of the collection on the compiled path and three eager, and each
   member's forward entry kind, every one ``compiled``, and the
   collection's fused step ``compiled`` (SDR's solve is K8's Levinson
   kernel, which a graph captures); K8's launches over the phase, and its
   ``kernels`` entry at one update's 32 systems of 512: against its plain
   version, with PyTorch's LU of the full matrices on its own pick of
   backend (MAGMA's batched LU, ``library_ms``) and on cuSOLVER's. (b) Image
   restoration at DIV2K's validation size: 50 of its 100 images, 3 x 1356
   x 2040 (seeded smooth fields plus texture; a copy blurred with noise of
   sigma 0.02-0.10), 5 updates of 10 into PSNR (range 1, inferred, per
   image), SSIM and MS-SSIM; host and device ms and peak device memory of
   each compute; the first 2 images against the CPU (1e-5 relative, SSIM
   1e-4 and each within 5e-5 of float64; ``image_gradients`` bit-equal).
   (c) STOI (also declared at 20 kHz, its decimation path), ESTOI and SSIM
   (RGB and one channel) with cuDNN TF32 on and matmuls at "medium", then
   both strict: bit-equal, the settings restored; the same two runs with
   the pin taken out, how far each score moves (recorded). (d) ``PESQ``
   and ``pesq`` raise
   ``ModuleNotFoundError`` (no ``pesq`` package on the card's machine).
   (e) SDR at ``filter_length=8192`` over 4 mixtures on the card against
   the CPU port (1e-2 dB, aggregate and per signal): K8's global-scratch
   form, past the 6144 whose vectors fit in shared memory; K8's ``kernels``
   entry at those (8, 8192) systems against its plain version (float64),
   with PyTorch's LU of the full matrices.
   K1-K7 launch none (JAX's path has no Pallas kernel): their counts must
   stay 0.
23. The embedded-model image metrics (``image/fid.py``, ``kid.py``,
   ``inception.py``, ``lpip_similarity.py``, ``models/``,
   ``engine/model_host.py``), the weights seeded and fan-in scaled through
   the port's ``random_inception_params`` (no download). (a) 2 048 seeded
   "real" and 2 048 "fake" uint8 images of 3 x 299 x 299 in updates of 64
   (the one cut: FID's protocol takes 50 000 a side) through FID (2048 tap,
   streaming float-float pairs), KID (``subsets=100``,
   ``subset_size=1000``) and IS (1 008 logits, 10 splits, list and
   streaming), each on its own full-width InceptionV3 in strict f32: images/s,
   host and device ms per update, each compute's ms and peak memory; FID
   against scipy's ``sqrtm`` in float64 (1e-5 relative), KID against float64
   numpy on the same subsets (1e-4), list IS against float64 numpy on the
   same permutation (1e-4), all from the card's features; streaming IS's
   split counts equal to a CPU twin's; the first 8 images a side on the CPU
   (taps within 1e-4 of their scale); the features bit-equal under TF32 on
   and off, and how far they move with the pin taken out. (b) FID and KID
   with ``model_host=True`` on one resident host (``shared_by`` 2): one
   capture per bucket cold, none warm; f32 features bit-equal to the direct
   forward at the same shape; bf16 within 5e-2, int8 within the q8 bound;
   images/s hosted and direct. (c) LPIPS with VGG16 and AlexNet (seeded
   backbones and heads) on 1 000 seeded 64 x 64 pairs in batches of 50 and
   8 pairs at 256 x 256; the first 8 pairs against the CPU (1e-4); pairs/s.
   K1-K7 launch none (JAX's path has no Pallas kernel): their counts must
   stay 0.
24. Detection at COCO val2017's size (``detection/map.py``, K9
   ``ops/kernels/csrc/match.cu``, the ragged engine's corpus aggregate):
   5 000 seeded 640 x 480 images, 80 Zipf(1.0) classes, Poisson(7.3) ground
   truths an image (~36 800) at COCO's 41 / 34 / 24 % small / medium / large
   shares, 100 detections an image (``maxDets``): 75 % of the ground truths
   copied with jittered corners, a tenth of those with another class, the
   rest false positives; scores rounded to 1/1000, so ties occur. (a)
   ``MAP(class_metrics=True)`` on the card in 100 updates of 50 images:
   ``compute()`` ms whole and split (host packing, upload, device IoU + K9 +
   pack between CUDA events, the copy, the host finish), the packed
   ``(P, D, G)``, K9's launches (one), the peak device memory; the staged
   split's values equal ``compute()``'s; K9's ``dm``/``mi`` at the full
   packed shape equal its plain version on the card; the first 500 images
   on the card equal ``device="cpu"``, key for key. (b) ``matching="host"``
   on the first 100 images equals the device path on them. (c)
   ``RaggedEngine(MAP(class_metrics=True), num_groups=64, capacity=256)``
   over the first 64 images, each in two rounds: ``aggregate_path()`` is
   ``"device"``, one K9 launch an aggregate, equal to ``aggregate(oracle=True)``
   and to the eager metric key for key; aggregate and oracle ms, the
   aggregate split (plan, device, copy, host finish). (d) K9's ``kernels``
   entries at (a)'s packed shape and (c)'s corpus shape, each held
   against its plain version there. (e) Crowds, past the warp path's 1 024
   ground truths: an eager ``MAP`` over 8 images whose first holds 1 025
   ground truths of one class (K9's block path at the packed G = 1 032),
   and ``RaggedEngine(MAP(), capacity=2048)`` over 8 images whose first
   holds 1 100, in two rounds (the aggregate's K9 call at G = 2 048); each
   on the card against the CPU port's eager ``MAP``, key for key, with a
   ``kernels`` entry at each shape. K1-K8 launch none; K9 launches in no
   earlier phase.
25. Serving on a mesh and 26. the mesh forms: see their functions.
27. The fleet (``engine/fleet/``): two host processes on the card machine,
   each a ``FleetEngine`` with its own representative device, ``cuda:0``
   and ``cuda:1`` over NCCL when there are two cards, else both on
   ``cuda:0`` over gloo (the runtime's pick for hosts sharing a card); the
   phase line names the layout and the transport. (a) Phase 7's megastep
   engine and traffic, batches homed by plan position, cuts every 16 plan
   batches; host 1 is killed (``os._exit``) after batch 72, past cut 3;
   both hosts restore from the last consistent cut and replay: each host's
   folded state bit-equal (sha256 of every leaf) to the single-process
   engine's on the card, values within 1e-6. (b) Phase 9's tenancy (10 000
   streams, Zipf 1.05, 128 resident slots a host, buckets 64/256, q8 off)
   stream-sharded under a tumbling window of 200 plan batches and 3 panes,
   cuts every 100, over the first 800 batches: at batch 440 both hosts'
   folded states bit-equal to the single-process paged engine's, through
   spills (a host's live rows outgrow its slots from batch 366 / 417); host 1
   killed after 450; ``restore_fleet_into`` of the pieces into one
   unsharded engine on the card equals the single-process state at the cut
   (400); both hosts restore, replay past spills and equal the engine at
   800. Per host: fold ms (p50, the fleet's own timer), barrier ms, cut
   ms, per-fold bytes by leg, K2/K5/K6 launches (each non-zero),
   ``collective_counts()`` over steady steps between cuts (0) and over a
   fold (>= 1), host ms a plan batch over a window between two cuts, with
   the engine steps and the captures made in it, beside the single-process
   engine's over the same plan batches (a host and one process coalesce
   different batches into a step, so steps do not compare). The first
   cut's ms includes waiting for the other host to reach it.

The engines run in their production form: ``submit`` enqueues, a dispatcher
thread coalesces queued batches and replays each (bucket, signature) step as
a CUDA graph captured once (``engine/aot.py``). Phases 7, 8 and 9a run once
more through the uncaptured step (the engine's private ``_capture = False``)
in the same call: the states must be bit-equal and the phase line prints
both host s/step. Each engine's ``aot_cache`` makes at most ``len(buckets)``
misses per payload signature, and phase 7 runs a warm twin engine over an
equal collection sharing the cache: it captures nothing. A capture runs the
step once on a copy of the state first (a warm-up), so each launch check
counts ``steps + warmup_steps``.

Every kernel's launch count is set to 0 before phase 4 and read after phase 9,
and set to 0 again before each of phases 10 to 27 and read after it;
each must be non-zero (phase 10: K1, K2, K5 and K6; phase 11: K1, K2 and
K3; phase 12: K2, K3, K5 and K6; phase 13: K1, K4, K5 and K6; phases 14
and 15: K2 and K3; phase 16: K2–K7; phases 17 and 18: K1–K7; phase 19: K2,
K3, K5, K6 and K7; phase 20: K1 and K4; in phases 21, 22, 23 and 24 each must stay 0; K8 is set to 0 at the
start of 22(a) and read before its timing, and must be non-zero, and again before phase 24, where it must stay
0; K9 is set to 0 before phase 4, must still read 0 before phase 24, and must launch once in 24(a)'s
``compute()``, once in each of 24(c)'s device aggregates and once in each of 24(e)'s computes; K8 once more
in 22(e); phases 25 and 26 as their lines say; phase 27: K2, K5 and K6 in the single-process references and
in each host process, which counts its own), and K2 must launch once per batch and per step
for each confusion matrix. A
``torch.profiler`` trace of one megastep bucket (``submit`` + ``flush``,
captured and uncaptured) and one per-leaf masked bucket
(``update_state_masked``) gives the device's busy share and device launches.
The line before the last is the ``kernels`` JSON object: K1, K2, K3 and K5
have one entry per shape above (K2 also at phase 10's calibration shape:
65 536 int64 indices into 15 bins, ``(65 536, 3)`` f32 weights, with
``index_add_`` into a zeroed ``(15, 3)`` output as its library call, and at
phase 11's AUROC support shape: 65 536 int64 labels into 10 bins, with
``torch.bincount`` as its library call, and at the recorder fold's shape of
phase 18, its launches the scrape's, and at phase 20's ragged aggregate folds,
its launches phase 20's; K8 one at 22(a)'s solve, its bound the larger of
its bytes and its float64 operations over 34 TFLOP/s, its library call
PyTorch's batched LU; K9 one at 24(a)'s packed shape and one at 24(c)'s
corpus shape, their launches 24(a)'s compute and 24(c)'s first aggregate,
each bound the larger of its bytes and
the compares this data needs over 67 T/s, no library call), K4, K6 and K7 one per ``traffic`` (random ids
and one stream; K4 also at phase 20's paged sweep block), each with ``device_us``, the device time of each CUDA kernel
the call launches. In it
``max_abs_err`` is the largest kernel-vs-plain difference over the f32 and
int32 cases, ``max_abs_err_bf16`` over the bf16 cases (null where there are
none), and ``bound_ms`` counts the bytes this run's data needs (unmasked rows
only; K7's codes and scales of the flagged slots only). The last line is
``{"ok": true, "device": {...}}``.
"""
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from metrics_tpu_torch.engine.traffic import zipf_stream_ids  # noqa: E402  (the seeded Zipf ids of every phase)

SEED = 0
N_ROWS = 65536
BATCH = 16384
NUM_CLASSES = 10
THRESHOLDS = 100
BUCKET = 1024
TIMED_RUNS = 25
# the engine phases: 64 streams unsharded; the paged tenancy configuration of
# metrics_tpu/engine/stream_bench.py (10 000 streams, Zipf 1.05, 128 resident)
ALPHA = 1.05
MS_STREAMS = 64
PAGED_STREAMS = 10_000
RESIDENT = 128
PAGED_BUCKETS = (64, 256)

# bounds: NVIDIA's H100 SXM data sheet (HBM3 bandwidth; f32 rate outside the
# tensor cores, also taken as the rate of the int32 compares and adds here)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def max_abs_err(got, want):
    """Largest |got - want| in float64; positions where both agree exactly
    (equal infinities, both NaN) count 0."""
    g = got.detach().double().cpu()
    w = want.detach().double().cpu()
    check(g.shape == w.shape, f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    diff = torch.where(same, torch.zeros_like(g), (g - w).abs())
    return float(diff.max()) if diff.numel() else 0.0


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def gpu_ms(fn, runs=TIMED_RUNS):
    """Median device time of ``fn`` in ms. Each run is bracketed by CUDA events
    behind a short device sleep, so the host's launch overhead is hidden and
    the events see only the device work."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_trace(fn, runs=20):
    """Per CUDA kernel name (memsets and copies too), the mean device µs and
    the launches of one call of ``fn``, from a ``torch.profiler`` trace of
    ``runs`` calls. A kernel launched early (programmatic dependent launch)
    counts its wait for the one before."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without some device events: take another
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                name = re.search(r"::(\w+)\s*[<(]", e.key)  # "void at::native::foo<...>(...)" -> foo
                name = name.group(1) if name else e.key[:40]
                us, count = out.get(name, (0.0, 0.0))  # kernels of one name (templates) add up
                out[name] = (us + e.self_device_time_total / runs, count + e.count / runs)
        if out and all(float(count).is_integer() for _, count in out.values()):
            break
    return out


def device_us(fn, runs=20):
    """Mean device µs per call of each CUDA kernel ``fn`` launches, by name."""
    return {k: us for k, (us, _) in device_trace(fn, runs).items()}


def host_us(fn, calls=200):
    """Host µs per call of ``fn`` over ``calls`` calls in a row, with one
    synchronise at the end: what a caller's thread spends to issue it."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


# --------------------------------------------------------------------------- kernels

def fold_phase(dev, rng):
    from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda, fold_rows_plain

    i32 = torch.iinfo(torch.int32)
    err = {False: 0.0, True: 0.0}  # the f32/int32 cases, the bf16 cases
    cases = []
    for f in (1000, 100, 10, 1):  # the masked step's leaves: binned AP, confmat, macro counts, scalars
        cases += [("float32", "sum", BUCKET, f, "ragged"), ("int32", "sum", BUCKET, f, "ragged")]
    for dt in ("float32", "int32", "bfloat16"):
        for fx in ("sum", "min", "max"):
            cases += [(dt, fx, 1037, 33, "random"), (dt, fx, BUCKET, 100, "none"),
                      (dt, fx, 0, 7, "all"), (dt, fx, 5, 1000, "first")]
    cases += [("int32", fx, BUCKET, 64, "limits") for fx in ("sum", "min", "max")]
    cases += [("float32", fx, 300, 17, "nan") for fx in ("sum", "min", "max")]
    for dt, fx, n, f, pattern in cases:
        dtype = getattr(torch, dt)
        if dt == "int32":
            rows = torch.from_numpy(rng.randint(-1000, 1000, (n, f)).astype(np.int32))
            state = torch.from_numpy(rng.randint(-1000, 1000, (f,)).astype(np.int32))
            if pattern == "limits":
                rows[::3] = i32.max
                rows[1::3] = i32.min
                state[:] = i32.max if fx == "sum" else 0
        else:
            rows = torch.from_numpy(rng.randn(n, f).astype(np.float32)).to(dtype)
            state = torch.from_numpy(rng.randn(f).astype(np.float32)).to(dtype)
            if pattern == "nan":
                rows[7, :5] = float("nan")
                rows[9, 3:9] = float("-inf")
        if pattern in ("ragged", "random", "limits", "nan"):
            mask = rng.rand(n) > 0.3
        else:
            mask = np.zeros(n, bool) if pattern == "none" else np.ones(n, bool)
            if pattern == "first" and n:
                mask[:] = False
                mask[0] = True
        m = torch.from_numpy(mask.astype(np.int32))
        got = fold_rows_cuda(state.to(dev), rows.to(dev), m.to(dev), fx)
        want = fold_rows_plain(state.to(dev), rows.to(dev), m.to(dev), fx)
        e = _check_close(got, want, f"fold {dt}/{fx}/{n}x{f}/{pattern}", fx == "sum", _row_sums(rows, m, None, 1),
                         _reassociation_bound(rows, m, state))
        err[dt == "bfloat16"] = max(err[dt == "bfloat16"], e)

    # timed at the masked step's leaves over a 1024-row bucket: binned AP's (10, 100) f32
    # counts, the confusion matrix, F1's per-class counts, accuracy's scalars (int32)
    head = {"name": "fold_rows", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/fold.cu",
            "replaces": "metrics_tpu/ops/kernels/pallas_fold.py:48",
            "max_abs_err": err[False], "max_abs_err_bf16": err[True]}
    return [_timed_fold(head, lambda s, r, m: fold_rows_cuda(s, r, m, "sum"),
                        lambda s, r, m: fold_rows_plain(s, r, m, "sum"), dtype, BUCKET, f, rng, dev)
            for f, dtype in ((NUM_CLASSES * THRESHOLDS, torch.float32), (NUM_CLASSES * NUM_CLASSES, torch.int32),
                             (NUM_CLASSES, torch.int32), (1, torch.int32))]


def _timed_fold(head, kernel, plain, dtype, n, f, rng, dev):
    """One ``kernels`` entry of a masked sum fold (K1 or K5) of ``(n, f)``
    rows: 0/1 rows, about 10 % masked, so kernel, plain version and
    ``torch.addmv`` agree exactly; then each is timed. ``kernel`` and ``plain``
    take (state, rows, mask). An int32 fold's ``addmv`` runs on float copies,
    made before the timing: only the call is timed."""
    rows = torch.from_numpy(rng.randint(0, 2, (n, f)).astype(np.int32)).to(dev, dtype)
    state = torch.zeros(f, dtype=dtype, device=dev)
    m = torch.from_numpy((rng.rand(n) > 0.1).astype(np.int32)).to(dev)
    rows_f, state_f, mf = rows.float(), state.float(), m.float()
    got = kernel(state, rows, m)
    what = f"{head['name']} ({n}, {f}) {dtype}"
    check(max_abs_err(got, plain(state, rows, m)) == 0.0, f"{what}: kernel disagrees with its plain version")
    check(max_abs_err(got.float(), torch.addmv(state_f, rows_f.t(), mf)) == 0.0, f"{what}: kernel disagrees with addmv")
    entry = dict(head, shape=f"rows ({n}, {f}) {str(dtype).replace('torch.', '')}, sum")
    entry.update({
        "ms": gpu_ms(lambda: kernel(state, rows, m)),
        "plain_ms": gpu_ms(lambda: plain(state, rows, m)),
        "library_ms": gpu_ms(lambda: torch.addmv(state_f, rows_f.t(), mf)),
        "device_us": device_us(lambda: kernel(state, rows, m)),
    })
    # unmasked rows and the mask read once, the state read and written once (a
    # uniform op row is not read)
    live = int(m.sum())
    entry["bound_ms"], entry["bound_by"] = bound_ms(4 * live * f + 4 * n + 2 * 4 * f, live * f)
    return entry


def _hist_indices(rng, b, n, length):
    """int64 (B, N) indices in [-3, L + 3), every fifth past int32 on either
    side (2**32 + 1 would land in bin 1 if it wrapped)."""
    idx = rng.randint(-3, length + 3, (b, n)).astype(np.int64)
    big = np.array([2**31, 2**32 + 1, 2**33 + length - 1, -(2**31) - 1, -(2**40)], np.int64)
    idx.flat[::5] = rng.choice(big, idx.flat[::5].shape)
    return torch.from_numpy(idx)


def _hist_oracle(idx, length, mask=None, weights=None):
    """numpy's bincount of each row (weights summed in float64 or int64)."""
    idx = idx.cpu().numpy()
    v = np.clip(idx, 0, None)
    keep = v < length
    if mask is not None:
        keep &= mask.cpu().numpy() != 0
    rows = np.broadcast_to(np.arange(idx.shape[0])[:, None], idx.shape)
    if weights is None:
        out = np.zeros((idx.shape[0], length), np.int64)
        np.add.at(out, (rows[keep], v[keep]), 1)
        return out
    w = weights.cpu().double().numpy() if weights.dtype.is_floating_point else weights.cpu().numpy().astype(np.int64)
    out = np.zeros((idx.shape[0], length, w.shape[2]), w.dtype)
    np.add.at(out, (rows[keep], v[keep]), w[keep])
    return out


_HIST_OUT_EPS = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}


def hist_phase(dev, rng):
    """K2 against its plain version and numpy: both forms, masks batched and
    expanded with stride 0, every weight dtype, the vmap rule's one launch;
    then :func:`hist_timing`."""
    from metrics_tpu_torch.ops.kernels import histogram_accumulate
    from metrics_tpu_torch.ops.kernels.hist_cuda import WEIGHT_DTYPES, histogram_cuda, histogram_plain

    # counts: the main path's shapes, both forms, bin tiles past 48 KB, no indices
    for b, n, length in ((1, BATCH, 100), (64, 1, 100), (BUCKET, 1, 100), (256, 3, 12289), (1, 1037, 1),
                         (1, 4099, 12289), (8, BATCH, 102400), (64, 1, 102400), (3, 0, 5), (1, 1, 3)):
        idx = _hist_indices(rng, b, n, length).to(dev)
        mask = torch.from_numpy(rng.rand(b, n) > 0.3).to(dev)
        row_mask = mask[:1].to(torch.int32).expand(b, n)  # one row's int32 mask, stride 0
        for i, m in ((idx, None), (idx, mask), (idx[:1].expand(b, n), row_mask), (idx.to(torch.int32), mask)):
            got = histogram_cuda(i, length, m)
            want = histogram_plain(i, length, m)
            torch.cuda.synchronize()
            what = f"hist counts ({b}, {n}) L={length} {i.dtype} mask={None if m is None else m.dtype}"
            check(got.dtype == torch.int32 and torch.equal(got, want), f"{what}: kernel != plain")
            check(np.array_equal(got.cpu().numpy(), _hist_oracle(i, length, m)), f"{what}: != numpy")
    # weighted sums in every dtype, direct and shared form, weights batched and stride 0
    err = {False: 0.0, True: 0.0}  # the f32/int32 cases, the bf16 cases
    for dtype in WEIGHT_DTYPES:
        for b, n, length, k in ((64, 3, 37, 3), (2, 5000, 37, 3), (1, 3001, 5000, 1)):
            idx = _hist_indices(rng, b, n, length).to(dev)
            mask = torch.from_numpy(rng.rand(b, n) > 0.3).to(dev)
            if dtype.is_floating_point:
                w = torch.from_numpy(rng.randn(b, n, k) * 10).to(dev, dtype)
            else:
                info = torch.iinfo(dtype)
                w = torch.from_numpy(rng.randint(max(info.min, -(2**40)), min(info.max, 2**40), (b, n, k)))
                w = w.to(dev, dtype)
            for ww in (w, w[:1].expand(b, n, k)):
                got = histogram_cuda(idx, length, mask, ww)
                want = histogram_plain(idx, length, mask, ww)
                torch.cuda.synchronize()
                what = f"hist weights {dtype} ({b}, {n}, {k}) L={length}"
                check(got.dtype == dtype and got.shape == (b, length, k), f"{what}: dtype/shape")
                if not dtype.is_floating_point:  # exact, wrapping as the dtype does
                    check(torch.equal(got, want), f"{what}: kernel != plain")
                    oracle = _hist_oracle(idx, length, mask, ww).astype(str(dtype).replace("torch.", ""))
                    check(np.array_equal(got.cpu().numpy(), oracle), f"{what}: != numpy")
                    continue
                # the reassociation bound of the accumulator, plus one step of a bf16/f16 output
                abs_sums = torch.from_numpy(_hist_oracle(idx, length, mask, ww.abs())).to(dev)
                eps = 2.0**-53 if dtype == torch.float64 else 2.0**-24
                tol = (2 * n * eps + _HIST_OUT_EPS.get(dtype, 0.0)) * abs_sums
                diff = (got.double() - want.double()).abs()
                check(bool((diff <= tol).all()), f"{what}: err {float(diff.max())}")
                if dtype in (torch.float32, torch.bfloat16):
                    err[dtype == torch.bfloat16] = max(err[dtype == torch.bfloat16], float(diff.max()))
    # the vmap rule: one launch for the whole bucket, a stride-0 mask passed through
    rows_idx = _hist_indices(rng, BUCKET, 1, 100)
    row_mask = torch.from_numpy(rng.rand(1) > 0.5)
    for m in (None, row_mask):
        def call(i, m_dev):
            return torch.func.vmap(lambda r: histogram_accumulate(r, 100, mask=m_dev))(i)
        before = histogram_cuda.launches
        got = call(rows_idx.to(dev), None if m is None else m.to(dev))
        check(histogram_cuda.launches == before + 1, "hist vmap rule: expected exactly one launch")
        oracle = _hist_oracle(rows_idx, 100, None if m is None else m.expand(BUCKET, 1))
        check(torch.equal(got.cpu(), call(rows_idx, m)) and np.array_equal(got.cpu().numpy(), oracle), "hist vmap rule")
    return hist_timing(dev, rng, err)


def _k2(fn, idx, length):
    """``fn`` (K2's wrapper or its plain version) on ``(B, N)`` indices, as a
    closure for timing. A tree from before the batched kernel (a parent
    unpacked in ``build/baseline`` for a comparison in one call) takes 1-D
    int32 indices into one histogram of B * L bins; for it the batch is folded
    into the bins beforehand, outside the closure."""
    from metrics_tpu_torch.ops.kernels import hist_cuda

    if hasattr(hist_cuda, "histogram_op"):
        return lambda: fn(idx, length)
    b = idx.shape[0]
    flat = (idx.clamp(min=0) + torch.arange(b, device=idx.device)[:, None] * length).reshape(-1).to(torch.int32)
    return lambda: fn(flat, b * length)


def hist_timing(dev, rng, err=None):
    """One ``kernels`` entry per shape the main path launches K2 at: the
    vmapped confusion matrix, ``(B, 1)`` int64 indices into L = 100 bins at the
    64-, 256- and 1024-row buckets (phases 9, 5, 7 and 8), and the one-shot
    ``(16 384,)`` batch (phase 4). Each holds the kernel's ms and
    ``device_us``, the whole call's (``histogram_accumulate``, vmapped or not)
    ms, host µs and device launches, the plain version's ms,
    ``torch.bincount`` of the indices folded into B * L bins beforehand, and
    the bound. Runs in an unpacked parent tree as well (:func:`_k2`)."""
    from metrics_tpu_torch.ops.kernels import histogram_accumulate
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda, histogram_plain

    length = NUM_CLASSES * NUM_CLASSES
    entries = []
    for rows in (*PAGED_BUCKETS, BUCKET, None):
        # target * C + pred: int64, in range, as the confusion matrix computes it
        b, n = (rows, 1) if rows else (1, BATCH)
        idx = torch.from_numpy(rng.randint(0, length, (b, n))).to(dev)
        if rows:
            call = torch.func.vmap(lambda i: histogram_accumulate(i, length))
            whole = lambda: call(idx)  # noqa: E731
        else:
            flat_idx = idx.reshape(-1)
            whole = lambda: histogram_accumulate(flat_idx, length)  # noqa: E731
        kernel, plain = _k2(histogram_cuda, idx, length), _k2(histogram_plain, idx, length)
        folded = (idx + torch.arange(b, device=dev)[:, None] * length).reshape(-1)
        library = lambda: torch.bincount(folded, minlength=b * length)  # noqa: E731
        want = library().reshape(b, length).to(torch.int32)
        for f in (kernel, plain, whole):
            check(torch.equal(f().reshape(b, length), want), f"hist ({b}, {n}): disagrees with torch.bincount")
        trace = device_trace(whole)
        entry = {
            "name": "histogram", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/hist.cu",
            "replaces": "metrics_tpu/ops/kernels/pallas_hist.py:55",
            "shape": f"idx ({b}, {n}) int64, L={length} counts" + (f" (vmapped {rows}-row bucket)" if rows
                                                                  else " (one-shot batch)"),
            "max_abs_err": None if err is None else err[False], "max_abs_err_bf16": None if err is None else err[True],
            "ms": gpu_ms(kernel), "plain_ms": gpu_ms(plain), "library_ms": gpu_ms(library),
            "device_us": device_us(kernel),
            "call_ms": gpu_ms(whole), "call_host_us": host_us(whole),
            "call_device_us": {k: us for k, (us, _) in trace.items()},
            "call_device_launches": sum(c for _, c in trace.values()),
        }
        # each index read once, each output element written once; one add per index
        entry["bound_ms"], entry["bound_by"] = bound_ms(8 * b * n + 4 * b * length, b * n)
        entries.append(entry)
    return entries


def binned_phase(dev, rng):
    from metrics_tpu_torch.ops.binned_update import binned_counts, binned_counts_cuda, binned_counts_torch

    def data(n, c, edge):
        p = rng.rand(n, c).astype(np.float32)
        t = rng.rand(n, c) > 0.7
        if edge and n >= 40:
            p[3:9, 0] = np.nan
            p[10:30] = -np.inf  # pad rows: -inf preds, target 0
            t[10:30] = False
            p[31, :] = np.inf
            p[32, :] = 1.0
            p[33, :] = 0.0
        return torch.from_numpy(p).to(dev), torch.from_numpy(t).to(dev)

    def thr(t):
        return torch.linspace(0, 1, t, dtype=torch.float32, device=dev)

    for n, c, t, edge in ((BATCH, NUM_CLASSES, THRESHOLDS, False), (N_ROWS, NUM_CLASSES, THRESHOLDS, False),
                          (1037, 3, 7, True), (1037, 1, 1, True), (0, 4, 5, False), (BUCKET, 10, 100, True)):
        p, y = data(n, c, edge)
        got = binned_counts_cuda(p, y, thr(t))
        want = binned_counts_torch(p, y, thr(t))
        pn, yn, tn = p.cpu().numpy(), y.cpu().numpy(), thr(t).cpu().numpy()
        ge = pn[:, :, None] >= tn[None, None, :]
        oracle = ((yn[:, :, None] & ge).sum(0), (~yn[:, :, None] & ge).sum(0), (yn[:, :, None] & ~ge).sum(0))
        torch.cuda.synchronize()
        for g, w, o, name in zip(got, want, oracle, ("TP", "FP", "FN")):
            check(torch.equal(g.cpu(), w.cpu()), f"binned {name} {n}x{c}x{t}: kernel != plain")
            check(np.array_equal(g.cpu().numpy(), o.astype(np.float32)), f"binned {name} {n}x{c}x{t}: != numpy")
    # the vmap rule at one 1024-row bucket: (B, 1, C) widens to (1, B*C), one launch
    p, y = data(BUCKET, NUM_CLASSES, True)
    thresholds = thr(THRESHOLDS)
    per_row = torch.func.vmap(lambda pr, yr: binned_counts(pr, yr, thresholds))
    before = binned_counts_cuda.launches
    got = per_row(p.reshape(BUCKET, 1, NUM_CLASSES), y.reshape(BUCKET, 1, NUM_CLASSES))
    check(binned_counts_cuda.launches == before + 1, "binned vmap rule: expected exactly one launch")
    thr_cpu = thresholds.cpu()
    want = torch.func.vmap(lambda pr, yr: binned_counts(pr, yr, thr_cpu))(
        p.cpu().reshape(BUCKET, 1, NUM_CLASSES), y.cpu().reshape(BUCKET, 1, NUM_CLASSES))
    for g, w in zip(got, want):
        check(g.shape == (BUCKET, NUM_CLASSES, THRESHOLDS) and torch.equal(g.cpu(), w), "binned vmap rule")

    # timed at the one-shot batch and at the vmapped buckets that carry nearly every
    # launch: phase 9's 64 and 256 rows, phases 5 and 7's 1024, each one (1, B*C) row
    c, t = NUM_CLASSES, THRESHOLDS
    p, y = data(BATCH, c, False)
    th = thr(t)
    entries = []
    for rows, wide in ((BATCH, False), (PAGED_BUCKETS[0], True), (PAGED_BUCKETS[1], True), (BUCKET, True)):
        pp, yy = (p[:rows].reshape(1, -1).contiguous(), y[:rows].reshape(1, -1).contiguous()) if wide else (p, y)
        n, cc = pp.shape
        check(all(torch.equal(g, w) for g, w in zip(binned_counts_cuda(pp, yy, th), binned_counts_torch(pp, yy, th))),
              f"binned ({n}, {cc}) x {t}: kernel != plain at a timed shape")
        entry = {
            "name": "binned_counts", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/binned.cu",
            "replaces": "metrics_tpu/ops/binned_update.py:69",
            "shape": f"preds ({n}, {cc}) f32, T={t}" + (f" (vmapped {rows}-row bucket)" if wide else " (one-shot batch)"),
            "max_abs_err": 0.0, "max_abs_err_bf16": None,  # f32 preds only; counts exact
            "ms": gpu_ms(lambda: binned_counts_cuda(pp, yy, th)),
            "plain_ms": gpu_ms(lambda: binned_counts_torch(pp, yy, th)),
            "library_ms": None,
            "device_us": device_us(lambda: binned_counts_cuda(pp, yy, th)),
        }
        # preds (4 bytes) and target (1) read once, the thresholds once, three (C, T) f32 written
        entry["bound_ms"], entry["bound_by"] = bound_ms(n * cc * 5 + 4 * t + 3 * 4 * cc * t, n * cc * t)
        entries.append(entry)
    return entries


def _segment_case(rng, dtype, n, s, f, pattern):
    """Rows, state, int32 mask and ids: masked rows carry ids in {-7, S, 2**31-1}."""
    i32 = torch.iinfo(torch.int32)
    if dtype == torch.int32:
        rows = torch.from_numpy(rng.randint(-1000, 1000, (n, f)).astype(np.int32))
        state = torch.from_numpy(rng.randint(-1000, 1000, (s, f)).astype(np.int32))
        if pattern == "limits":
            rows[::3] = i32.max
            rows[1::3] = i32.min
    else:
        rows = torch.from_numpy(rng.randn(n, f).astype(np.float32)).to(dtype)
        state = torch.from_numpy(rng.randn(s, f).astype(np.float32)).to(dtype)
        if pattern == "nan" and n > 9:
            rows[7, : min(f, 5)] = float("nan")
            rows[9, :] = float("-inf")
    mask = rng.rand(n) > 0.3
    ids = rng.randint(0, s, n).astype(np.int32)
    if pattern == "one_segment":
        ids[:] = s - 1
    if pattern == "all_masked":
        mask[:] = False
    ids[~mask] = rng.choice(np.array([-7, s, 2**31 - 1], np.int64), int((~mask).sum())).astype(np.int32)
    return rows, state, torch.from_numpy(mask.astype(np.int32)), torch.from_numpy(ids)


def _row_sums(rows, mask, ids, s):
    """Each ``(segment, column)`` cell's exact (float64) sum of the unmasked
    rows its id addresses; ``ids`` None means one segment, shape ``(F,)``."""
    m = mask.bool()
    if ids is None:
        return rows[m].double().sum(0)
    return torch.zeros((s, rows.shape[1]), dtype=torch.float64).index_add_(0, ids[m].long(), rows[m].double())


def _reassociation_bound(rows, mask, state):
    """Per column, how far two f32 sums of the state and the unmasked rows,
    taken in other orders, can lie apart: each within n * 2**-24 * sum|terms|
    of the exact sum, n the number of terms."""
    m = mask.bool()
    terms = int(m.sum()) + 1
    return 2 * terms * 2.0 ** -24 * (state.double().abs() + rows[m].double().abs().sum(0))


def _check_close(got, want, what, sum_cols, row_sums, reassociation=None):
    """``got`` against ``want`` cell by cell; returns the largest |got - want|.
    Ints, and every column outside ``sum_cols`` (a bool or an ``(F,)`` bool
    tensor), exact; f32 sums within 1e-5 + 1e-6 * scale, or, where the kernel
    folds in an order of its own (K1 and K5: row lanes, a tree, cluster
    ranks), within the larger ``reassociation`` bound per cell; a bf16 sum
    rounds twice in both (the rows' f32 sum, then its add to the state), so
    within 2**-8 * (2|R| + |got| + |want|), R the cell's exact row sum
    (``row_sums``)."""
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape, f"{what}: dtype/shape")
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    diff = torch.where(same, torch.zeros_like(g), (g - w).abs())
    sums = torch.as_tensor(sum_cols).expand(g.shape)
    if got.dtype == torch.int32:
        tol = torch.zeros_like(g)
    elif got.dtype == torch.float32:
        scale = float(w.abs().nan_to_num(posinf=0, neginf=0).max()) if w.numel() else 0.0
        tol = torch.full_like(g, 1e-5 + 1e-6 * scale)
        if reassociation is not None:
            tol = torch.maximum(tol, reassociation.expand(g.shape))
        tol = torch.where(sums, tol, 0.0)
    else:
        tol = torch.where(sums, 2.0 ** -8 * (2 * row_sums.abs() + g.abs() + w.abs()), 0.0)
    bad = ~same & ~(diff <= tol)  # a NaN difference fails too
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} cells off, err {float(diff[bad].max())}")
    return float(diff.max()) if diff.numel() else 0.0


def segment_phase(dev, rng):
    """K4 against its plain version; timed at the unsharded engine's widest
    leaf (64 streams, a 1024-row bucket, binned AP's 1000 f32 columns)."""
    from metrics_tpu_torch.ops.kernels.segment_cuda import segment_reduce_cuda, segment_reduce_plain

    err = {False: 0.0, True: 0.0}  # the f32/int32 cases, the bf16 cases
    cases = []
    for dt in (torch.float32, torch.int32, torch.bfloat16):
        for fx in ("sum", "min", "max"):
            for s in (1, 7, 128, 5000):
                cases.append((dt, fx, 1037, s, 33, "random"))
            cases += [(dt, fx, 300, 7, 1, "one_segment"), (dt, fx, 300, 7, 9, "all_masked"),
                      (dt, fx, 0, 4, 5, "random"), (dt, fx, 1, 1, 1, "random"), (dt, fx, 500, 13000, 3, "random")]
    cases += [(torch.int32, fx, BUCKET, 64, 64, "limits") for fx in ("sum", "min", "max")]
    cases += [(torch.float32, fx, 300, 17, 17, "nan") for fx in ("sum", "min", "max")]
    for dt, fx, n, s, f, pattern in cases:
        rows, state, mask, ids = _segment_case(rng, dt, n, s, f, pattern)
        got = segment_reduce_cuda(state.to(dev), rows.to(dev), mask.to(dev), ids.to(dev), fx)
        want = segment_reduce_plain(state, rows, mask, ids, s, fx)
        e = _check_close(got, want, f"segment {dt}/{fx}/{n}x{f}/S={s}/{pattern}", fx == "sum",
                         _row_sums(rows, mask, ids, s))
        err[dt == torch.bfloat16] = max(err[dt == torch.bfloat16], e)

    def bound(n, s, f, live):  # unmasked rows, mask and ids read once; the state read and written once
        return bound_ms(4 * live * f + 8 * n + 2 * 4 * s * f, live * f)

    n, s, f = BUCKET, 64, NUM_CLASSES * THRESHOLDS
    rows = torch.from_numpy(rng.randint(0, 2, (n, f)).astype(np.float32)).to(dev)
    state = torch.zeros((s, f), device=dev)
    m = torch.from_numpy((rng.rand(n) > 0.1).astype(np.int32)).to(dev)
    ids = torch.from_numpy(rng.randint(0, s, n).astype(np.int32)).to(dev)
    masked_rows, ids64 = rows * m[:, None].float(), ids.long()
    # 0/1 rows: every sum is an integer, so kernel, plain version and library call agree exactly
    got = segment_reduce_cuda(state, rows, m, ids, "sum")
    check(max_abs_err(got, segment_reduce_plain(state, rows, m, ids, s, "sum")) == 0.0,
          "segment: kernel disagrees with its plain version at the main path's shape")
    check(max_abs_err(got, state.index_add(0, ids64, masked_rows)) == 0.0,
          "segment: kernel disagrees with index_add on 0/1 rows")
    entry = {
        "name": "segment_reduce", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/segment.cu",
        "replaces": "metrics_tpu/ops/kernels/pallas_segment.py:57", "shape": f"state ({s}, {f}), rows ({n}, {f}) f32, sum",
        "max_abs_err": err[False], "max_abs_err_bf16": err[True],
        "ms": gpu_ms(lambda: segment_reduce_cuda(state, rows, m, ids, "sum")),
        "plain_ms": gpu_ms(lambda: segment_reduce_plain(state, rows, m, ids, s, "sum")),
        "library_ms": gpu_ms(lambda: state.index_add(0, ids64, masked_rows)),
    }
    entry["bound_ms"], entry["bound_by"] = bound(n, s, f, int(m.sum()))
    entry["traffic"] = "random ids"
    entry["device_us"] = device_us(lambda: segment_reduce_cuda(state, rows, m, ids, "sum"))
    entries = [entry]

    # the step the multi-stream engine sends: one stream's rows, at binned AP's leaf and at a narrow one
    one_rng = np.random.RandomState(SEED + 5)  # its own draws: the entry above keeps its inputs and bound
    for f in (NUM_CLASSES * THRESHOLDS, NUM_CLASSES):
        state = torch.zeros((s, f), device=dev)
        rows, m, ids, sid = _one_stream(one_rng, n, s, f, dev)
        masked_rows, ids64 = rows * m[:, None].float(), torch.where(m.bool(), ids, sid).long()
        got = segment_reduce_cuda(state, rows, m, ids, "sum")
        check(max_abs_err(got, segment_reduce_plain(state, rows, m, ids, s, "sum")) == 0.0,
              f"segment: kernel disagrees with its plain version on one stream, F={f}")
        check(max_abs_err(got, state.index_add(0, ids64, masked_rows)) == 0.0,
              f"segment: kernel disagrees with index_add on one stream's 0/1 rows, F={f}")
        one = {k: entry[k] for k in ("name", "route", "source", "replaces", "max_abs_err", "max_abs_err_bf16")}
        one.update({
            "shape": f"state ({s}, {f}), rows ({n}, {f}) f32, sum", "traffic": "one stream",
            "ms": gpu_ms(lambda: segment_reduce_cuda(state, rows, m, ids, "sum")),
            "plain_ms": gpu_ms(lambda: segment_reduce_plain(state, rows, m, ids, s, "sum")),
            "library_ms": gpu_ms(lambda: state.index_add(0, ids64, masked_rows)),
            "device_us": device_us(lambda: segment_reduce_cuda(state, rows, m, ids, "sum")),
        })
        one["bound_ms"], one["bound_by"] = bound(n, s, f, int(m.sum()))
        entries.append(one)
    return entries


def _one_stream(rng, n, s, f, dev):
    """The engines' one-stream step: 0/1 f32 rows, about 10 % masked; every
    unmasked row carries one stream id, drawn in ``[0, S)``, and masked rows
    garbage ids. Returns rows, int32 mask, int32 ids and the stream id."""
    rows = torch.from_numpy(rng.randint(0, 2, (n, f)).astype(np.float32)).to(dev)
    mask = rng.rand(n) > 0.1
    sid = int(rng.randint(0, s))
    ids = np.full(n, sid, np.int32)
    ids[~mask] = rng.choice(np.array([-7, s, 2**31 - 1], np.int64), int((~mask).sum())).astype(np.int32)
    return rows, torch.from_numpy(mask.astype(np.int32)).to(dev), torch.from_numpy(ids).to(dev), sid


def _op_rows(f):
    """A uniform row per op and a mixed one (runs of each op, as leaves lay
    out), each with its bool mask of sum columns."""
    mixed = np.zeros(f, np.int32)
    mixed[f // 3: 2 * f // 3] = 1
    mixed[2 * f // 3:] = 2
    rows = [(fx, torch.full((f,), i, dtype=torch.int32)) for i, fx in enumerate(("sum", "min", "max"))]
    return [(u, ops, ops == 0) for u, ops in rows + [(None, torch.from_numpy(mixed))]]


def megastep_fold_phase(dev, rng):
    """K5 against its plain version; timed at the flagship arena's f32 buffer
    (3000 columns) over a 1024-row bucket."""
    from metrics_tpu_torch.ops.kernels.megastep_cuda import megastep_fold_cuda, megastep_fold_plain

    err = {False: 0.0, True: 0.0}  # the f32/int32 cases, the bf16 cases
    for dt in (torch.float32, torch.int32, torch.bfloat16):
        for n, f, pattern in ((1037, 300, "random"), (BUCKET, 146, "random"), (0, 7, "random"), (300, 1, "random"),
                              (300, 40, "all_masked"), (BUCKET, 64, "limits" if dt == torch.int32 else "nan")):
            for uniform, ops, sum_cols in _op_rows(f):
                rows, state, mask, _ = _segment_case(rng, dt, n, 1, f, pattern)
                got = megastep_fold_cuda(state[0].to(dev), rows.to(dev), mask.to(dev), ops.to(dev), uniform)
                want = megastep_fold_plain(state[0], rows, mask, ops)
                e = _check_close(got, want, f"megastep_fold {dt}/{uniform}/{n}x{f}/{pattern}", sum_cols,
                                 _row_sums(rows, mask, None, 1), _reassociation_bound(rows, mask, state[0]))
                err[dt == torch.bfloat16] = max(err[dt == torch.bfloat16], e)

    # timed at the flagship arena's two buffers (both uniform sum rows, as phase 7 sends
    # them): 3000 f32 columns and the int32 width ArenaLayout gives, over both buckets
    widths = make_collection(torch.device("cpu")).arena_layout().buffer_sizes()
    head = {"name": "megastep_fold", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/fold.cu",
            "replaces": "metrics_tpu/ops/kernels/pallas_megastep.py:86",
            "max_abs_err": err[False], "max_abs_err_bf16": err[True]}
    entries = []
    for key, dtype in (("float32", torch.float32), ("int32", torch.int32)):
        ops = torch.zeros(widths[key], dtype=torch.int32, device=dev)
        for n in (BUCKET, 256):
            entries.append(_timed_fold(head, lambda s, r, m: megastep_fold_cuda(s, r, m, ops, "sum"),
                                       lambda s, r, m: megastep_fold_plain(s, r, m, ops), dtype, n, widths[key],
                                       rng, dev))
    return entries


def megastep_segment_phase(dev, rng):
    """K6 and K7 against their plain versions, K7 also bit-identical to K6 on
    a host-decoded state; timed at the paged engine's f32 arena: 128 resident
    slots of 3000 columns, a 64-row bucket."""
    from metrics_tpu_torch.ops.kernels.megastep_cuda import (
        megastep_segment_cuda,
        megastep_segment_plain,
        megastep_segment_q8_cuda,
    )

    err6 = {False: 0.0, True: 0.0}  # the f32/int32 cases, the bf16 cases
    err7 = {False: 0.0, True: 0.0}
    for dt in (torch.float32, torch.int32, torch.bfloat16):
        for n, s, f, pattern in ((1037, 7, 33, "random"), (300, 128, 300, "random"), (200, 5000, 3, "random"),
                                 (300, 7, 9, "one_segment"), (300, 7, 9, "all_masked"), (0, 4, 5, "random"),
                                 (64, 1, 1, "random"), (BUCKET, 64, 64, "limits" if dt == torch.int32 else "nan")):
            for uniform, ops, sum_cols in _op_rows(f):
                rows, state, mask, ids = _segment_case(rng, dt, n, s, f, pattern)
                got = megastep_segment_cuda(state.to(dev), rows.to(dev), mask.to(dev), ids.to(dev), ops.to(dev),
                                            uniform)
                want = megastep_segment_plain(state, rows, mask, ids, ops)
                e = _check_close(got, want, f"megastep_segment {dt}/{uniform}/{n}x{f}/S={s}/{pattern}", sum_cols,
                                 _row_sums(rows, mask, ids, s))
                err6[dt == torch.bfloat16] = max(err6[dt == torch.bfloat16], e)
    # K7: flagged slots decode, touched or not, also with no rows
    for dt in (torch.float32, torch.bfloat16):
        for n, s, f in ((0, 16, 96), (211, 16, 96), (BUCKET, 128, 300), (5, 1, 1)):
            for uniform, ops, sum_cols in _op_rows(f):
                rows, state, mask, ids = _segment_case(rng, dt, n, s, f, "random")
                ids = torch.where(mask.bool(), ids % max(s // 2, 1), ids)  # the upper slots stay untouched
                flags = torch.from_numpy((np.arange(s) % 3 != 1).astype(np.int32))
                codes = torch.from_numpy(rng.randint(-127, 128, (s, f)).astype(np.int8))
                scales = torch.from_numpy((rng.rand(s, f) * 1e-2).astype(np.float32))
                qcol = torch.from_numpy((np.arange(f) % 4 != 3).astype(np.int32))
                q8 = (flags, codes, scales, qcol)
                got = megastep_segment_q8_cuda(state.to(dev), rows.to(dev), mask.to(dev), ids.to(dev), ops.to(dev),
                                               uniform, *(t.to(dev) for t in q8))
                want = megastep_segment_plain(state, rows, mask, ids, ops, q8=q8)
                what = f"megastep_segment_q8 {dt}/{uniform}/{n}x{f}/S={s}"
                e = _check_close(got, want, what, sum_cols, _row_sums(rows, mask, ids, s))
                err7[dt == torch.bfloat16] = max(err7[dt == torch.bfloat16], e)
                on = (flags[:, None] != 0) & (qcol[None, :] != 0)
                decoded = torch.where(on, (codes.float() * scales).to(dt), state)  # the host codec's arithmetic
                twin = megastep_segment_cuda(decoded.to(dev), rows.to(dev), mask.to(dev), ids.to(dev), ops.to(dev),
                                             uniform)
                torch.cuda.synchronize()
                check(torch.equal(got, twin), f"{what}: not bit-identical to K6 on the host-decoded state")

    n, s, f = 64, 128, 3 * NUM_CLASSES * THRESHOLDS
    rows = torch.from_numpy(rng.randint(0, 2, (n, f)).astype(np.float32)).to(dev)
    state = torch.zeros((s, f), device=dev)
    m = torch.from_numpy((rng.rand(n) > 0.1).astype(np.int32)).to(dev)
    ids = torch.from_numpy(rng.randint(0, s, n).astype(np.int32)).to(dev)
    ops = torch.zeros(f, dtype=torch.int32, device=dev)
    masked_rows, ids64 = rows * m[:, None].float(), ids.long()
    flags = torch.zeros(s, dtype=torch.int32, device=dev)
    flagged = 4  # a few slots paged in per step, as in the engine
    flags[:flagged] = 1
    codes = torch.from_numpy(rng.randint(-127, 128, (s, f)).astype(np.int8)).to(dev)
    scales = torch.from_numpy(rng.rand(s, f).astype(np.float32)).to(dev)
    qcol = torch.ones(f, dtype=torch.int32, device=dev)
    q8 = (flags, codes, scales, qcol)
    # 0/1 rows: every sum is an integer, so kernel, plain version and library
    # call agree exactly; K7 adds each decoded seed once, as its plain version does
    got = megastep_segment_cuda(state, rows, m, ids, ops, "sum")
    check(max_abs_err(got, megastep_segment_plain(state, rows, m, ids, ops)) == 0.0,
          "megastep_segment: kernel disagrees with its plain version at the main path's shape")
    check(max_abs_err(got, state.index_add(0, ids64, masked_rows)) == 0.0,
          "megastep_segment: kernel disagrees with index_add on 0/1 rows")
    check(max_abs_err(megastep_segment_q8_cuda(state, rows, m, ids, ops, "sum", *q8),
                      megastep_segment_plain(state, rows, m, ids, ops, q8=q8)) == 0.0,
          "megastep_segment_q8: kernel disagrees with its plain version at the main path's shape")
    qcols = int(qcol.sum())
    state_read = 4 * ((s - flagged) * f + flagged * (f - qcols))

    def k6_bound(live):  # unmasked rows, mask and ids read once; the arena read and written once
        return bound_ms(4 * live * f + 8 * n + 2 * 4 * s * f, live * f)

    def k7_bound(live):  # as K6, plus the flags and the column mask, and the codes and scales of the
        # flagged slots only; those slots' quantized columns are decoded, not read
        return bound_ms(4 * live * f + 8 * n + state_read + 4 * s * f + 4 * s + 4 * f + 5 * flagged * qcols,
                        live * f + flagged * qcols)

    live = int(m.sum())
    k6 = {
        "name": "megastep_segment", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/segment.cu",
        "replaces": "metrics_tpu/ops/kernels/pallas_megastep.py:210",
        "shape": f"arena ({s}, {f}), rows ({n}, {f}) f32, sum",
        "max_abs_err": err6[False], "max_abs_err_bf16": err6[True],
        "ms": gpu_ms(lambda: megastep_segment_cuda(state, rows, m, ids, ops, "sum")),
        "plain_ms": gpu_ms(lambda: megastep_segment_plain(state, rows, m, ids, ops)),
        "library_ms": gpu_ms(lambda: state.index_add(0, ids64, masked_rows)),
    }
    k6["bound_ms"], k6["bound_by"] = k6_bound(live)  # a uniform op row is not read
    k7 = {
        "name": "megastep_segment_q8", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/segment.cu",
        "replaces": "metrics_tpu/ops/kernels/pallas_megastep.py:258",
        "shape": f"arena ({s}, {f}), rows ({n}, {f}) f32, sum, {flagged} staged slots",
        "max_abs_err": err7[False], "max_abs_err_bf16": err7[True],
        "ms": gpu_ms(lambda: megastep_segment_q8_cuda(state, rows, m, ids, ops, "sum", *q8)),
        "plain_ms": gpu_ms(lambda: megastep_segment_plain(state, rows, m, ids, ops, q8=q8)),
        "library_ms": None,
    }
    k7["bound_ms"], k7["bound_by"] = k7_bound(live)
    k6["traffic"] = k7["traffic"] = "random ids"
    k6["device_us"] = device_us(lambda: megastep_segment_cuda(state, rows, m, ids, ops, "sum"))
    k7["device_us"] = device_us(lambda: megastep_segment_q8_cuda(state, rows, m, ids, ops, "sum", *q8))

    # the step the paged engine sends: one stream's rows into its slot, just paged in (flagged)
    one_rng = np.random.RandomState(SEED + 6)  # its own draws: the entries above keep their inputs and bounds
    rows, m, ids, sid = _one_stream(one_rng, n, s, f, dev)
    masked_rows, ids64 = rows * m[:, None].float(), torch.where(m.bool(), ids, sid).long()
    flags = torch.zeros(s, dtype=torch.int32, device=dev)
    flags[[sid] + [x for x in range(s) if x != sid][:flagged - 1]] = 1
    q8 = (flags, codes, scales, qcol)
    got = megastep_segment_cuda(state, rows, m, ids, ops, "sum")
    check(max_abs_err(got, megastep_segment_plain(state, rows, m, ids, ops)) == 0.0,
          "megastep_segment: kernel disagrees with its plain version on one stream")
    check(max_abs_err(got, state.index_add(0, ids64, masked_rows)) == 0.0,
          "megastep_segment: kernel disagrees with index_add on one stream's 0/1 rows")
    got = megastep_segment_q8_cuda(state, rows, m, ids, ops, "sum", *q8)
    check(max_abs_err(got, megastep_segment_plain(state, rows, m, ids, ops, q8=q8)) == 0.0,
          "megastep_segment_q8: kernel disagrees with its plain version on one stream")
    decoded = torch.where((flags[:, None] != 0) & (qcol[None, :] != 0), codes.float() * scales, state)
    twin = megastep_segment_cuda(decoded, rows, m, ids, ops, "sum")
    torch.cuda.synchronize()
    check(torch.equal(got, twin), "megastep_segment_q8: not bit-identical to K6 on the host-decoded state, one stream")
    live = int(m.sum())
    keys = ("name", "route", "source", "replaces", "max_abs_err", "max_abs_err_bf16")
    k6_one = {k: k6[k] for k in keys}
    k6_one.update({
        "shape": k6["shape"], "traffic": "one stream",
        "ms": gpu_ms(lambda: megastep_segment_cuda(state, rows, m, ids, ops, "sum")),
        "plain_ms": gpu_ms(lambda: megastep_segment_plain(state, rows, m, ids, ops)),
        "library_ms": gpu_ms(lambda: state.index_add(0, ids64, masked_rows)),
        "device_us": device_us(lambda: megastep_segment_cuda(state, rows, m, ids, ops, "sum")),
    })
    k6_one["bound_ms"], k6_one["bound_by"] = k6_bound(live)
    k7_one = {k: k7[k] for k in keys}
    k7_one.update({
        "shape": k7["shape"], "traffic": "one stream",
        "ms": gpu_ms(lambda: megastep_segment_q8_cuda(state, rows, m, ids, ops, "sum", *q8)),
        "plain_ms": gpu_ms(lambda: megastep_segment_plain(state, rows, m, ids, ops, q8=q8)),
        "library_ms": None,
        "device_us": device_us(lambda: megastep_segment_q8_cuda(state, rows, m, ids, ops, "sum", *q8)),
    })
    k7_one["bound_ms"], k7_one["bound_by"] = k7_bound(live)
    return [k6, k6_one], [k7, k7_one]


# ------------------------------------------------------------------------- main path

def make_collection(device, ap_precision=None):
    from metrics_tpu_torch import Accuracy, BinnedAveragePrecision, ConfusionMatrix, F1Score, MetricCollection

    return MetricCollection({
        "acc": Accuracy(device=device),
        "f1": F1Score(num_classes=NUM_CLASSES, average="macro", device=device),
        "binned_ap": BinnedAveragePrecision(num_classes=NUM_CLASSES, thresholds=THRESHOLDS, device=device,
                                            sync_precision=ap_precision),
        "confmat": ConfusionMatrix(num_classes=NUM_CLASSES, device=device),
    })


def flat_values(values):
    out = {}
    for k, v in values.items():
        v = torch.stack(list(v)) if isinstance(v, list) else v
        out[k] = v.detach().double().cpu()
    return out


def oracle_states(preds, target):
    """Every count of the collection from numpy alone."""
    c = NUM_CLASSES
    pred_label = preds.argmax(1)
    onehot = np.eye(c, dtype=bool)[target]
    pos = np.eye(c, dtype=bool)[pred_label]
    thr = np.linspace(0, 1, THRESHOLDS, dtype=np.float32)
    tp = np.zeros((c, THRESHOLDS)); fp = np.zeros_like(tp); fn = np.zeros_like(tp)
    for lo in range(0, len(preds), BATCH):
        ge = preds[lo:lo + BATCH, :, None] >= thr[None, None, :]
        y = onehot[lo:lo + BATCH, :, None]
        tp += (y & ge).sum(0); fp += (~y & ge).sum(0); fn += (y & ~ge).sum(0)
    macro = {"tp": (onehot & pos).sum(0), "fp": (~onehot & pos).sum(0),
             "tn": (~onehot & ~pos).sum(0), "fn": (onehot & ~pos).sum(0)}
    correct = int((pred_label == target).sum())
    n = len(target)
    micro = {"tp": correct, "fp": n - correct, "tn": n * (c - 1) - (n - correct), "fn": n - correct}
    return {
        "acc": micro,
        "f1": macro,
        "binned_ap": {"TPs": tp, "FPs": fp, "FNs": fn},
        "confmat": {"confmat": np.bincount(target * c + pred_label, minlength=c * c).reshape(c, c)},
    }


def compare_states(got, want, what):
    """Every leaf of ``got`` equal to ``want``'s: same dtype where ``want`` is a
    tensor of the port, same values always."""
    for k, member in want.items():
        for s, w in member.items():
            g = got[k][s].detach().cpu()
            if isinstance(w, torch.Tensor):
                check(g.dtype == w.dtype, f"{what}: {k}.{s} dtype {g.dtype} != {w.dtype}")
            w = torch.as_tensor(np.asarray(w.cpu() if isinstance(w, torch.Tensor) else w))
            check(g.shape == w.shape and torch.equal(g.double(), w.double()), f"{what}: {k}.{s} differs")


def main_path(dev, preds, target):
    """The flagship step: ``update`` over the rows in batches, then ``compute``."""
    coll = make_collection(dev)
    t0 = time.perf_counter()
    for lo in range(0, N_ROWS, BATCH):
        coll.update(preds[lo:lo + BATCH], target[lo:lo + BATCH])
    values = flat_values(coll.compute())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    state = {k: {s: getattr(m, s) for s in m._defaults} for k, m in coll.items(keep_base=True)}
    return state, values, seconds


def masked_path(dev, preds, target, rng, make=make_collection):
    coll = make(dev)
    state = coll.init_state()
    lo, buckets = 0, 0
    t0 = time.perf_counter()
    while lo < N_ROWS:
        valid = min(int(rng.randint(BUCKET // 2, BUCKET + 1)), N_ROWS - lo)
        p = rng.randn(BUCKET, NUM_CLASSES).astype(np.float32) * 1e3  # garbage padding
        p[valid:][::5] = np.nan
        t = rng.randint(-3, NUM_CLASSES + 5, BUCKET)
        p[:valid], t[:valid] = preds[lo:lo + valid], target[lo:lo + valid]
        mask = np.arange(BUCKET) < valid
        state = coll.update_state_masked(state, torch.from_numpy(p).to(dev), torch.from_numpy(t).to(dev),
                                         mask=torch.from_numpy(mask).to(dev))
        lo += valid
        buckets += 1
    check(valid < BUCKET, "the last bucket must be partly masked")
    values = flat_values(coll.compute_from(state))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return state, values, buckets, time.perf_counter() - t0


def ragged_batches(seed, lo, hi):
    """Consecutive ``[start, stop)`` row ranges of ``lo``..``hi`` rows over the main path's rows."""
    rng = np.random.RandomState(seed)
    out, start = [], 0
    while start < N_ROWS:
        stop = min(N_ROWS, start + int(rng.randint(lo, hi + 1)))
        out.append((start, stop))
        start = stop
    return out


def run_engine(eng, capture, batches, submit):
    """Drive ``eng`` through its entry points (``with`` + ``submit``): host
    seconds from the first submit until the dispatcher has drained and the
    device finished. ``capture=False`` takes the uncaptured step."""
    eng._capture = capture
    t0 = time.perf_counter()
    with eng:
        for b in batches:
            submit(eng, b)
    return time.perf_counter() - t0


def streaming_megastep_phase(dev, preds, target, capture=True, aot_cache=None):
    """Phase 7: the megastep engine over the main path's rows, ragged."""
    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine

    eng = StreamingEngine(make_collection(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep"),
                          aot_cache=aot_cache)
    seconds = run_engine(eng, capture, ragged_batches(SEED + 2, 16, BUCKET),
                         lambda e, b: e.submit(preds[b[0]:b[1]], target[b[0]:b[1]]))
    check(eng.stats.kernel_fallbacks_by_reason() == {}, f"megastep engine fell back: {eng.stats.kernel_fallbacks}")
    return eng, seconds


def stream_rows(sids, batches):
    """Row indices of every stream, in submit order."""
    rows = {}
    for sid, (start, stop) in zip(sids, batches):
        rows.setdefault(int(sid), []).append(np.arange(start, stop))
    return {sid: np.concatenate(r) for sid, r in rows.items()}


def check_streams(eng, per_stream, preds_np, target_np, streams, what, int_only=False):
    """Every listed stream's state against the numpy oracle over its rows."""
    empty = np.zeros(0, np.int64)
    for sid in streams:
        idx = per_stream.get(sid, empty)
        want = oracle_states(preds_np[idx], target_np[idx])
        if int_only:
            want = {k: v for k, v in want.items() if k != "binned_ap"}
        compare_states(eng.stream_state(sid), want, f"{what}: stream {sid}")


def dispatcher_alone(dev, preds, target, aot_cache):
    """Phase 7's batches through a warm engine (sharing ``aot_cache``: no
    capture) twice: the producer submitting while the dispatcher steps (the
    two threads share the interpreter lock), and the producer first, alone,
    with the dispatcher held on the engine's state lock, then the dispatcher
    draining the whole backlog alone. Host seconds per step of each, and the
    producer's host µs per ``submit``."""
    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine

    batches = ragged_batches(SEED + 2, 16, BUCKET)
    out = {}
    for mode in ("together", "apart"):
        eng = StreamingEngine(make_collection(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep",
                                                                 max_queue=len(batches)), aot_cache=aot_cache)
        eng.start()
        held = eng._state_lock if mode == "apart" else contextlib.nullcontext()
        t0 = time.perf_counter()
        with held:
            for start, stop in batches:
                eng.submit(preds[start:stop], target[start:stop])
            t_submit = time.perf_counter()
        eng.stop()
        t_end = time.perf_counter()
        check(eng.stats.warmup_steps == 0, "dispatcher_alone: the warm engine captured")
        out[mode] = {"steps": eng.steps, "submit_us_per_batch": (t_submit - t0) / len(batches) * 1e6,
                     "s_per_step": (t_end - (t_submit if mode == "apart" else t0)) / eng.steps}
    return out


def multistream_phase(dev, preds, target, preds_np, target_np, capture=True):
    """Phase 8: the unsharded engine, 64 streams, Zipf stream ids."""
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine

    batches = ragged_batches(SEED + 3, 16, BUCKET)
    sids = zipf_stream_ids(MS_STREAMS, len(batches), ALPHA, SEED + 3)
    eng = MultiStreamEngine(make_collection(dev), MS_STREAMS, EngineConfig(buckets=(256, BUCKET)))
    seconds = run_engine(eng, capture, list(zip(sids, batches)),
                         lambda e, b: e.submit(int(b[0]), preds[b[1][0]:b[1][1]], target[b[1][0]:b[1][1]]))
    if capture:
        check_streams(eng, stream_rows(sids, batches), preds_np, target_np, range(MS_STREAMS), "multistream")
    return eng, seconds


def paged_phase(dev, preds, target, preds_np, target_np, q8, stage=True, capture=True, coalesce=8):
    """Phase 9: the paged engine, 10 000 streams in 128 slots under "megastep"."""
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine

    batches = ragged_batches(SEED + 4, 8, 64)
    sids = zipf_stream_ids(PAGED_STREAMS, len(batches), ALPHA, SEED + 4)
    eng = MultiStreamEngine(make_collection(dev, ap_precision="q8_block" if q8 else None), PAGED_STREAMS,
                            EngineConfig(buckets=PAGED_BUCKETS, kernel_backend="megastep", compress_payloads=q8,
                                         coalesce=coalesce),
                            stream_shard=True, resident_streams=RESIDENT)
    if not stage:  # the twin: spilled rows decode on the host before seating
        eng._q8_enabled = False
        eng._q8_reset_stage()
    seconds = run_engine(eng, capture, list(zip(sids, batches)),
                         lambda e, b: e.submit(int(b[0]), preds[b[1][0]:b[1][1]], target[b[1][0]:b[1][1]]))
    per_stream = stream_rows(sids, batches)
    st = eng.stats
    check(st.page_outs > 0, "paged: nothing was spilled")
    check(st.page_ins > len(per_stream), "paged: no spilled row was paged back in")  # first touches load init rows
    if capture:
        untouched = [s for s in range(0, PAGED_STREAMS, 97) if s not in per_stream][:20]
        check_streams(eng, per_stream, preds_np, target_np, sorted(per_stream) + untouched,
                      f"paged q8={q8} stage={stage}", int_only=q8)
    return eng, seconds, per_stream


def engine_states_equal(a, b, streams, what):
    """Two multi-stream engines' states, stream by stream, bit for bit: every
    listed stream's rows out of one reassembly of all streams per engine
    (``state()``), not one flushed read per stream."""
    x, y = stacked_host(a), stacked_host(b)
    idx = np.asarray(list(streams), np.int64)
    for k in x:
        for s in x[k]:
            g, w = x[k][s][idx], y[k][s][idx]
            if g.dtype != w.dtype or not np.array_equal(g, w):
                rows = np.nonzero((g != w).reshape(len(idx), -1).any(axis=1))[0]
                check(False, f"{what}: {k}.{s} ({g.dtype} / {w.dtype}) differs, first at stream "
                             f"{idx[rows[0]] if rows.size else None}")


def check_cache(eng, what, signatures=1):
    """A cold engine captures at most one step per bucket and signature."""
    misses = eng.aot_cache.misses
    check(misses <= signatures * len(eng._cfg.buckets),
          f"{what}: {misses} captures for {len(eng._cfg.buckets)} buckets")
    return eng.aot_cache.stats()


def profile_bucket(dev, preds, target, make=make_collection):
    """Device-busy share of one megastep bucket of ``make``'s collection
    through the engine's entry points (``submit`` + ``flush``: the
    dispatcher's captured graph replay, and the uncaptured step) and of one
    per-leaf masked bucket (``update_state_masked``): the kernel time of a
    torch.profiler trace of one bucket over the bucket's host wall time
    without the profiler (median of 5)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine

    engines = {}
    for name, capture in (("megastep_bucket_captured", True), ("megastep_bucket_uncaptured", False)):
        eng = engines[name] = StreamingEngine(make(dev), EngineConfig(buckets=(BUCKET,), kernel_backend="megastep"))
        eng._capture = capture
        eng.start()
    coll = make(dev)
    p, t = preds[:BUCKET], target[:BUCKET]
    mask = torch.ones(BUCKET, dtype=torch.bool, device=dev)

    def bucket(eng):
        eng.submit(p, t)
        eng.flush()

    runs = {name: (lambda e=eng: bucket(e)) for name, eng in engines.items()}
    runs["masked_bucket"] = lambda: coll.update_state_masked(coll.init_state(), p, t, mask=mask)
    out = {}
    for name, fn in runs.items():
        walls = []
        for _ in range(6):  # the first run warms up
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e6)
        wall_us = float(np.median(walls[1:]))
        for _ in range(3):  # a trace now and then comes back without its device events: take another
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            # device-side entries only (kernels, memcpys): a CPU op's self device
            # time repeats the time of the kernels it launched
            device = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
            busy = {e.key: e.self_device_time_total for e in device}
            total = float(sum(busy.values()))
            if total > 0:
                break
        # device_ops: distinct kernel names; device_launches: every kernel, memset and copy
        out[name] = {"wall_us": wall_us, "device_busy_us": total, "device_busy_share": total / wall_us,
                     "device_ops": len(busy), "device_launches": sum(e.count for e in device),
                     "top": [(k[:60], v) for k, v in sorted(busy.items(), key=lambda kv: -kv[1])[:6]]}
    for eng in engines.values():
        eng.stop()
    for name in engines:
        check(out[name]["device_busy_us"] > 0, f"profiler: no device time in the {name}")
    return out


def kernel_wrappers():
    """The kernel wrappers K1-K7 by name, each with its ``.launches`` count."""
    from metrics_tpu_torch.ops.binned_update import binned_counts_cuda
    from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda
    from metrics_tpu_torch.ops.kernels.megastep_cuda import (
        megastep_fold_cuda,
        megastep_segment_cuda,
        megastep_segment_q8_cuda,
    )
    from metrics_tpu_torch.ops.kernels.segment_cuda import segment_reduce_cuda

    return {"fold_rows": fold_rows_cuda, "histogram": histogram_cuda, "binned_counts": binned_counts_cuda,
            "segment_reduce": segment_reduce_cuda, "megastep_fold": megastep_fold_cuda,
            "megastep_segment": megastep_segment_cuda, "megastep_segment_q8": megastep_segment_q8_cuda}


def counts():
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def delta(before):
    now = counts()
    return {k: now[k] - before[k] for k in now}


def main_rows(dev):
    """The main path's seeded rows: ``(preds, target)`` on ``dev`` and as numpy."""
    data_rng = np.random.RandomState(SEED)
    preds_np = data_rng.rand(N_ROWS, NUM_CLASSES).astype(np.float32)
    preds_np /= preds_np.sum(axis=1, keepdims=True)
    target_np = data_rng.randint(0, NUM_CLASSES, N_ROWS)
    return torch.from_numpy(preds_np).to(dev), torch.from_numpy(target_np).to(dev), preds_np, target_np


def engine_phases(dev, preds, target, preds_np, target_np, gpu_state):
    """Phases 7-9: every engine in its production form (dispatcher, captured
    steps), with the uncaptured twins, the warm twin, the oracle, twin and
    launch checks. Returns the phases' numbers."""
    phases = {}

    def per_step(eng):  # every step the card ran: the served ones and each capture's warm-up
        return eng.steps + eng.stats.warmup_steps

    # phase 7: the megastep engine; 2 K5 launches per step, no K1
    before = counts()
    mega_eng, seconds = streaming_megastep_phase(dev, preds, target)
    d = delta(before)
    n7 = per_step(mega_eng)
    check(d["megastep_fold"] == 2 * n7 and d["fold_rows"] == 0,
          f"megastep engine: {d['megastep_fold']} K5 and {d['fold_rows']} K1 launches in {n7} steps")
    compare_states(mega_eng.state(), gpu_state, "megastep engine vs one-shot")
    check(d["histogram"] == n7, "megastep engine: K2 not one launch per step")
    aot7 = check_cache(mega_eng, "megastep engine")
    # its warm twin shares the cache: every step a hit, nothing captured
    before = counts()
    twin_eng, twin_seconds = streaming_megastep_phase(dev, preds, target, aot_cache=mega_eng.aot_cache)
    dt = delta(before)
    check(twin_eng.aot_cache.misses == aot7["misses"] and twin_eng.stats.warmup_steps == 0,
          f"warm twin engine captured: {twin_eng.aot_cache.stats()}")
    check(dt["megastep_fold"] == 2 * twin_eng.steps and dt["histogram"] == twin_eng.steps,
          "warm twin engine: launches not credited per replay")
    compare_states(twin_eng.state(), gpu_state, "warm twin engine vs one-shot")
    unc_eng, unc_seconds = streaming_megastep_phase(dev, preds, target, capture=False)
    compare_states(unc_eng.state(), mega_eng.state(), "megastep engine: captured vs uncaptured")
    phases["streaming_megastep"] = {
        "seconds": seconds, "steps": mega_eng.steps, "warmup_steps": mega_eng.stats.warmup_steps,
        "megasteps": mega_eng.stats.megasteps, "batches": mega_eng.stats.batches_submitted,
        "s_per_step": seconds / mega_eng.steps, "launches": d, "aot": aot7,
        "uncaptured": {"seconds": unc_seconds, "steps": unc_eng.steps, "s_per_step": unc_seconds / unc_eng.steps},
        "warm_twin": {"seconds": twin_seconds, "steps": twin_eng.steps, "aot": twin_eng.aot_cache.stats()},
        "dispatcher_alone": dispatcher_alone(dev, preds, target, mega_eng.aot_cache),
    }

    # phase 8: unsharded multi-stream; K4 on every step (one per state leaf)
    before = counts()
    ms_eng, seconds = multistream_phase(dev, preds, target, preds_np, target_np)
    d = delta(before)
    n8 = per_step(ms_eng)
    n_leaves = ms_eng.arena_layout.num_leaves
    check(d["segment_reduce"] == n_leaves * n8, "multistream: K4 did not launch once per leaf on every step")
    check(d["histogram"] == n8, "multistream: K2 not one launch per step")
    unc_eng, unc_seconds = multistream_phase(dev, preds, target, preds_np, target_np, capture=False)
    engine_states_equal(ms_eng, unc_eng, range(MS_STREAMS), "multistream: captured vs uncaptured")
    ms_results = results_timing(ms_eng, range(MS_STREAMS))
    phases["multistream"] = {
        "seconds": seconds, "steps": ms_eng.steps, "warmup_steps": ms_eng.stats.warmup_steps,
        "megasteps": ms_eng.stats.megasteps, "batches": ms_eng.stats.batches_submitted,
        "s_per_step": seconds / ms_eng.steps, "streams": MS_STREAMS, "launches": d,
        "aot": check_cache(ms_eng, "multistream"),
        "uncaptured": {"seconds": unc_seconds, "steps": unc_eng.steps, "s_per_step": unc_seconds / unc_eng.steps},
        "results": ms_results,
    }

    # phase 9: paged, (a) exact, coalesced and not, (b) q8 staged decode, (c) (b)'s host-decode twin
    for name, q8, stage, coalesce in (("paged_exact", False, True, 8), ("paged_exact_coalesce1", False, True, 1),
                                      ("paged_q8", True, True, 1), ("paged_q8_twin", True, False, 1)):
        before = counts()
        eng, seconds, per_stream = paged_phase(dev, preds, target, preds_np, target_np, q8, stage, coalesce=coalesce)
        st = eng.stats
        d = delta(before)
        n9 = per_step(eng)
        phases[name] = {"seconds": seconds, "steps": eng.steps, "warmup_steps": st.warmup_steps,
                        "megasteps": st.megasteps, "batches_coalesced": st.batches_coalesced,
                        "batches": st.batches_submitted, "s_per_step": seconds / eng.steps, "coalesce": coalesce,
                        "streams": PAGED_STREAMS, "resident": RESIDENT, "touched": len(per_stream),
                        "page_ins": st.page_ins, "page_outs": st.page_outs, "page_hits": st.page_hits,
                        "q8_staged_rows": st.q8_staged_rows, "launches": d,
                        "aot": check_cache(eng, name)}
        # one launch per arena dtype per step: K7 for the staged f32 arena of (b), K6 for the rest
        k7_per_step = 1 if name == "paged_q8" else 0
        check(d["megastep_segment"] == (2 - k7_per_step) * n9 and d["megastep_segment_q8"] == k7_per_step * n9,
              f"{name}: {d['megastep_segment']} K6 and {d['megastep_segment_q8']} K7 launches in {n9} steps")
        check(d["histogram"] == n9, f"{name}: K2 not one launch per step")
        if name == "paged_exact":
            check(st.megasteps > 0, "paged: no queued batches coalesced")
            exact_eng, exact_streams = eng, sorted(per_stream)
            unc_eng, unc_seconds, _ = paged_phase(dev, preds, target, preds_np, target_np, False, capture=False)
            engine_states_equal(eng, unc_eng, exact_streams, "paged: captured vs uncaptured")
            phases[name]["uncaptured"] = {"seconds": unc_seconds, "steps": unc_eng.steps,
                                          "s_per_step": unc_seconds / unc_eng.steps}
            phases[name]["results"] = results_timing(eng, result_sample(eng, per_stream))
        if name == "paged_exact_coalesce1":
            check(st.megasteps == 0, "paged coalesce=1: a step carried several batches")
            engine_states_equal(exact_eng, eng, exact_streams, "paged: coalesced vs not")
        if name == "paged_q8":
            check(st.q8_staged_rows > 0, "paged q8: no spilled row was seated for K7 to decode")
            q8_eng, q8_streams = eng, sorted(per_stream)
        if name == "paged_q8_twin":
            check(st.q8_staged_rows == 0, "paged twin: staged anyway")
            engine_states_equal(q8_eng, eng, q8_streams, "paged q8 vs twin")
    return phases


# ------------------------------------------------------- phase 10: the dashboard

CAL_BINS = 15
RESULT_SAMPLES = 200  # streams whose result() is held against results(), as stream_bench samples them


def make_dashboard(device):
    """The classification dashboard: every counting metric the engines serve."""
    from metrics_tpu_torch import (CohenKappa, HammingDistance, HingeLoss, JaccardIndex, MatthewsCorrCoef,
                                   MetricCollection, Precision, Recall, Specificity)

    c = NUM_CLASSES
    return MetricCollection({
        "precision": Precision(average="macro", num_classes=c, device=device),
        "recall": Recall(average="macro", num_classes=c, device=device),
        "specificity": Specificity(average="macro", num_classes=c, device=device),
        "hamming": HammingDistance(device=device),
        "jaccard": JaccardIndex(num_classes=c, device=device),
        "kappa": CohenKappa(num_classes=c, device=device),
        "mcc": MatthewsCorrCoef(num_classes=c, device=device),
        "hinge": HingeLoss(device=device),
    })


def dashboard_oracle(preds, target):
    """Every count of the dashboard from numpy alone, and its hinge measure
    (Crammer-Singer: 1 minus the true class's score over the best other, at
    least 0) in float64 with the absolute sum of its terms."""
    base = oracle_states(preds, target)
    macro, cm = base["f1"], base["confmat"]["confmat"]
    n, c = len(target), NUM_CLASSES
    rows = np.arange(n)
    p = preds.astype(np.float64)
    other = p.copy()
    other[rows, target] = -np.inf
    terms = np.maximum(0.0, 1.0 - (p[rows, target] - other.max(1)))
    # one-hot preds against one-hot targets: a wrong row differs in two places
    counts = {"precision": macro, "recall": macro, "specificity": macro,
              "hamming": {"correct": n * c - 2 * (n - int(np.trace(cm))), "total": n * c},
              "jaccard": {"confmat": cm}, "kappa": {"confmat": cm}, "mcc": {"confmat": cm}, "hinge": {"total": n}}
    return counts, float(terms.sum()), float(np.abs(terms).sum())


def check_dashboard_state(state, oracle, what):
    """Counts equal to numpy's (``oracle``: :func:`dashboard_oracle` of the
    same rows); the f32 hinge measure within the reassociation bound of its
    float64 sum (each term rounds twice, the sum of n terms reassociates)."""
    counts, measure, abs_sum = oracle
    compare_states(state, counts, what)
    got = float(state["hinge"]["measure"])
    tol = (2 * counts["hinge"]["total"] + 4) * 2.0**-24 * abs_sum
    check(abs(got - measure) <= tol, f"{what}: hinge measure {got} vs {measure} (tol {tol})")
    return tol


def close_value(got, want, what, slack=0.0):
    """One metric value against another: within 1e-6 relative plus 1e-6
    absolute (f32 arithmetic on the same counts in another order: a value
    near 0 such as a kappa of 1 - 0.99 keeps the absolute error of its
    terms), plus ``slack``, what reassociated f32 sums can move it."""
    g, w = float(got), float(want)
    ok = abs(g - w) <= 1e-6 * abs(w) + 1e-6 + slack or (np.isnan(g) and np.isnan(w))
    check(ok, f"{what}: {g} vs {w} (slack {slack})")


def same_values(got, want, what):
    """Two value trees leaf by leaf: integers exact, floats by :func:`close_value`."""
    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in leaves(v)]
        return [tree.detach().cpu()]

    a, b = leaves(got), leaves(want)
    check(len(a) == len(b), f"{what}: {len(a)} leaves vs {len(b)}")
    for x, y in zip(a, b):
        check(x.dtype == y.dtype and x.shape == y.shape, f"{what}: dtype/shape {x.dtype} {y.dtype}")
        if x.is_floating_point():
            for g, w in zip(x.reshape(-1).tolist(), y.reshape(-1).tolist()):
                close_value(g, w, what)
        else:
            check(torch.equal(x, y), f"{what}: integers differ")


def calibration_oracle(preds, target):
    """The calibration errors of the main rows in float64 (the port's f32
    bin boundaries, ``searchsorted(left) - 1``, confidence 0 in no bin), each
    with how far f32 bin sums within their reassociation bounds
    (2 * n_b * 2**-24 * the bin's sum) can move it."""
    from metrics_tpu_torch.functional.classification.calibration_error import _bin_boundaries

    conf = preds.max(1)
    acc = (preds.argmax(1) == target).astype(np.float64)
    idx = np.searchsorted(_bin_boundaries(CAL_BINS).numpy(), conf, side="left") - 1
    keep = idx >= 0
    idx = idx[keep]
    count = np.bincount(idx, minlength=CAL_BINS).astype(np.float64)
    conf_sum = np.bincount(idx, weights=conf[keep].astype(np.float64), minlength=CAL_BINS)
    acc_sum = np.bincount(idx, weights=acc[keep], minlength=CAL_BINS)
    safe, prop = np.maximum(count, 1.0), count / len(conf)
    gap = np.abs(acc_sum - conf_sum) / safe
    move = 2 * count * 2.0**-24 * (conf_sum + acc_sum) / safe
    sq, sq_move = (gap**2 * prop).sum(), ((2 * gap * move + move**2) * prop).sum()
    return {"l1": (float((gap * prop).sum()), float((move * prop).sum())),
            "l2": (float(np.sqrt(sq)), float(np.sqrt(sq + sq_move) - np.sqrt(max(sq - sq_move, 0.0)))),
            "max": (float(gap.max()), float(move.max()))}


def kl_inputs(dev):
    """A second seeded softmax distribution over the main rows' classes: KL's ``q``."""
    rng = np.random.RandomState(SEED + 5)
    q = rng.rand(N_ROWS, NUM_CLASSES).astype(np.float32)
    q /= q.sum(axis=1, keepdims=True)
    return torch.from_numpy(q).to(dev), q


def dashboard_eager(dev, preds, target, q):
    """Phase 10(a) on ``dev``: the dashboard's ``update`` over the rows in
    batches, then ``compute``; the calibration error in all three norms
    (K2's weighted form, one launch per ``compute``), KL against ``q`` and
    ``dice_score`` on the same rows."""
    from metrics_tpu_torch import CalibrationError, KLDivergence
    from metrics_tpu_torch.functional import dice_score
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda

    coll = make_dashboard(dev)
    t0 = time.perf_counter()
    for lo in range(0, N_ROWS, BATCH):
        coll.update(preds[lo:lo + BATCH], target[lo:lo + BATCH])
    values = flat_values(coll.compute())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    state = {k: {s: getattr(m, s) for s in m._defaults} for k, m in coll.items(keep_base=True)}
    cal, cal_launches = {}, 0
    for norm in ("l1", "l2", "max"):
        m = CalibrationError(n_bins=CAL_BINS, norm=norm, device=dev)
        m.update(preds, target)
        before = histogram_cuda.launches
        cal[norm] = float(m.compute())
        cal_launches += histogram_cuda.launches - before
    kl = KLDivergence(device=dev)
    kl.update(preds, q)
    return state, values, seconds, cal, cal_launches, float(kl.compute()), float(dice_score(preds, target))


def result_sample(eng, per_stream):
    """200 streams of a paged engine: resident, spilled and never touched."""
    rng = np.random.RandomState(SEED + 6)
    resident = sorted(eng.pager.resident_streams(0))
    spilled = sorted(eng.pager.spilled_streams(0))
    untouched = [s for s in range(eng.num_streams) if s not in per_stream]
    k_res, k_spill = min(50, len(resident)), min(100, len(spilled))
    k_new = RESULT_SAMPLES - k_res - k_spill
    check(k_res > 0 and k_spill > 0 and 0 < k_new <= len(untouched), "result sample: too few streams")
    picks = [rng.choice(resident, k_res, replace=False), rng.choice(spilled, k_spill, replace=False),
             rng.choice(untouched, k_new, replace=False)]
    return sorted(int(s) for p in picks for s in p)


def results_timing(eng, sample):
    """One batched ``results()`` against ``result()`` of each sampled
    stream: one more device computation, equal values. Host ms of the
    ``results()`` (flush, assembly, one vmapped compute, one copy to the
    host) and of the per-stream loop, and the device launches and µs of one
    ``results()`` from a profiler trace."""
    calls = eng.stats.result_device_calls
    t0 = time.perf_counter()
    values = eng.results()
    results_ms = (time.perf_counter() - t0) * 1e3
    check(eng.stats.result_device_calls == calls + 1, "results(): not one device computation")
    t0 = time.perf_counter()
    singles = {sid: eng.result(sid) for sid in sample}
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3
    for sid in sample:
        same_values(values[sid], singles[sid], f"results() vs result({sid})")
    trace = device_trace(eng.results, runs=2)
    return {"streams": eng.num_streams, "results_ms": results_ms,
            "results_device_launches": sum(c for _, c in trace.values()),
            "results_device_us": sum(us for us, _ in trace.values()),
            "sampled_streams": len(sample), "per_stream_result_ms": single_ms,
            "per_stream_result_ms_each": single_ms / len(sample)}


def dashboard_phase(dev, preds, target, preds_np, target_np):
    """Phase 10: the classification dashboard. (a) eager on the card, held
    against the port's CPU run and numpy (with the calibration error, KL and
    dice), and through the per-leaf masked bucket step; (b) the captured
    megastep ``StreamingEngine``; (c) the captured paged ``MultiStreamEngine``
    of phase 9a, then one ``results()``; (d) their times."""
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, StreamingEngine

    out = {}
    q, q_np = kl_inputs(dev)
    gpu = dashboard_eager(dev, preds, target, q)
    cpu = dashboard_eager(torch.device("cpu"), torch.from_numpy(preds_np), torch.from_numpy(target_np),
                          torch.from_numpy(q_np))
    gpu_state, gpu_values, eager_s, cal, cal_launches, kl, dice = gpu
    check(cal_launches == 3, f"calibration error: {cal_launches} K2 launches for 3 computes")
    oracle = dashboard_oracle(preds_np, target_np)
    tol = check_dashboard_state(gpu_state, oracle, "dashboard (card)")
    check_dashboard_state(cpu[0], oracle, "dashboard (CPU)")
    compare_states({k: {s: v for s, v in m.items() if k != "hinge" or s != "measure"} for k, m in gpu_state.items()},
                   {k: {s: v for s, v in m.items() if k != "hinge" or s != "measure"} for k, m in cpu[0].items()},
                   "dashboard: card vs CPU")
    for k, v in gpu_values.items():
        close_value(v, cpu[1][k], f"dashboard value {k}", 2 * tol / N_ROWS if k == "hinge" else 0.0)
    for norm, (want, slack) in calibration_oracle(preds_np, target_np).items():
        close_value(cal[norm], want, f"calibration {norm} (card)", slack)
        close_value(cpu[3][norm], want, f"calibration {norm} (CPU)", slack)
    p64, q64 = preds_np.astype(np.float64), q_np.astype(np.float64)
    p64, q64 = p64 / p64.sum(1, keepdims=True), q64 / q64.sum(1, keepdims=True)
    elems = p64 * np.log(p64 / np.maximum(q64, 1e-6))
    kl_slack = (2 * N_ROWS + 8) * 2.0**-24 * float(np.abs(elems).sum()) / N_ROWS
    close_value(kl, float(elems.sum()) / N_ROWS, "KL divergence (card)", kl_slack)
    close_value(kl, cpu[5], "KL divergence card vs CPU", 2 * kl_slack)
    close_value(dice, cpu[6], "dice score card vs CPU")
    masked_state, _, buckets, masked_s = masked_path(dev, preds_np, target_np, np.random.RandomState(SEED + 1),
                                                     make=make_dashboard)
    check_dashboard_state(masked_state, oracle, "dashboard masked buckets")
    out["eager"] = {"update_compute_s": eager_s, "calibration": cal, "calibration_k2_launches": cal_launches,
                    "kl_divergence": kl, "dice": dice, "masked_buckets": buckets, "masked_update_compute_s": masked_s,
                    "values": {k: float(v) for k, v in gpu_values.items()}}

    # (b) the megastep engine: two K5 launches a step (int32 and f32 arenas), three K2 (one per confusion matrix)
    before = counts()
    eng = StreamingEngine(make_dashboard(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep"))
    seconds = run_engine(eng, True, ragged_batches(SEED + 2, 16, BUCKET),
                         lambda e, b: e.submit(preds[b[0]:b[1]], target[b[0]:b[1]]))
    d = delta(before)
    n = eng.steps + eng.stats.warmup_steps
    check(eng.stats.kernel_fallbacks_by_reason() == {}, f"dashboard megastep fell back: {eng.stats.kernel_fallbacks}")
    check(d["megastep_fold"] == 2 * n and d["fold_rows"] == 0 and d["histogram"] == 3 * n,
          f"dashboard megastep: {d['megastep_fold']} K5, {d['fold_rows']} K1, {d['histogram']} K2 in {n} steps")
    check_dashboard_state(eng.state(), oracle, "dashboard megastep engine")
    out["streaming_megastep"] = {"seconds": seconds, "steps": eng.steps, "warmup_steps": eng.stats.warmup_steps,
                                 "megasteps": eng.stats.megasteps, "s_per_step": seconds / eng.steps,
                                 "launches": d, "aot": check_cache(eng, "dashboard megastep")}

    # (c) the paged engine of phase 9a: two K6 launches a step, three K2; then one results()
    batches = ragged_batches(SEED + 4, 8, 64)
    sids = zipf_stream_ids(PAGED_STREAMS, len(batches), ALPHA, SEED + 4)
    before = counts()
    eng = MultiStreamEngine(make_dashboard(dev), PAGED_STREAMS,
                            EngineConfig(buckets=PAGED_BUCKETS, kernel_backend="megastep", coalesce=8),
                            stream_shard=True, resident_streams=RESIDENT)
    seconds = run_engine(eng, True, list(zip(sids, batches)),
                         lambda e, b: e.submit(int(b[0]), preds[b[1][0]:b[1][1]], target[b[1][0]:b[1][1]]))
    d = delta(before)
    n = eng.steps + eng.stats.warmup_steps
    check(d["megastep_segment"] == 2 * n and d["megastep_segment_q8"] == 0 and d["histogram"] == 3 * n,
          f"dashboard paged: {d['megastep_segment']} K6, {d['histogram']} K2 in {n} steps")
    check(eng.stats.page_outs > 0, "dashboard paged: nothing was spilled")
    per_stream = stream_rows(sids, batches)
    sample = result_sample(eng, per_stream)
    empty = np.zeros(0, np.int64)
    for sid in sample:
        idx = per_stream.get(sid, empty)
        check_dashboard_state(eng.stream_state(sid), dashboard_oracle(preds_np[idx], target_np[idx]),
                              f"dashboard paged stream {sid}")
    st = eng.stats
    out["paged"] = {"seconds": seconds, "steps": eng.steps, "warmup_steps": st.warmup_steps,
                    "megasteps": st.megasteps, "batches": st.batches_submitted, "s_per_step": seconds / eng.steps,
                    "streams": PAGED_STREAMS, "resident": RESIDENT, "touched": len(per_stream),
                    "page_ins": st.page_ins, "page_outs": st.page_outs, "launches": d,
                    "aot": check_cache(eng, "dashboard paged"),
                    # (d) the batched results() against the per-stream loop
                    "results": results_timing(eng, sample)}
    return out


def hist_calibration_timing(dev, preds, target):
    """K2's weighted one-shot form as phase 10's calibration error launches
    it: the main rows' top-label confidences binned into 15 bins, ``(N, 3)``
    f32 weights (in-bin flag, confidence, accuracy). Counts exact; the sums
    within the reassociation bound of the plain version's and of
    ``index_add_``'s. The library call is ``index_add_`` into a zeroed
    ``(15, 3)`` output."""
    from metrics_tpu_torch.functional.classification.calibration_error import _bin_boundaries, _ce_update
    from metrics_tpu_torch.ops.kernels import histogram_accumulate
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda, histogram_plain

    conf, acc = _ce_update(preds, target)
    idx = torch.searchsorted(_bin_boundaries(CAL_BINS, dev), conf, side="left") - 1
    w = (idx >= 0).to(torch.float32)
    idx = idx.clamp(0, CAL_BINS - 1)
    weights = torch.stack([w, conf * w, acc * w], dim=-1)
    i2, w3 = idx[None], weights[None]
    kernel = lambda: histogram_cuda(i2, CAL_BINS, None, w3)  # noqa: E731
    plain = lambda: histogram_plain(i2, CAL_BINS, None, w3)  # noqa: E731
    whole = lambda: histogram_accumulate(idx, CAL_BINS, weights=weights)  # noqa: E731
    library = lambda: torch.zeros((CAL_BINS, 3), device=dev).index_add_(0, idx, weights)  # noqa: E731
    want = plain()[0]
    tol = 2 * idx.numel() * 2.0**-24 * histogram_plain(i2, CAL_BINS, None, w3.abs())[0].double()
    err = 0.0
    for name, got in (("kernel", kernel()[0]), ("call", whole()), ("index_add_", library())):
        torch.cuda.synchronize()
        check(torch.equal(got[:, 0], want[:, 0]), f"hist calibration {name}: counts differ")
        diff = (got.double() - want.double()).abs()
        check(bool((diff <= tol).all()), f"hist calibration {name}: err {float(diff.max())}")
        err = max(err, float(diff.max()))
    trace = device_trace(whole)
    n = idx.numel()
    entry = {
        "name": "histogram", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/hist.cu",
        "replaces": "metrics_tpu/ops/kernels/pallas_hist.py:55",
        "shape": f"idx ({n},) int64 into {CAL_BINS} bins, ({n}, 3) f32 weights (calibration error, one-shot)",
        "max_abs_err": err, "max_abs_err_bf16": None,
        "ms": gpu_ms(kernel), "plain_ms": gpu_ms(plain), "library_ms": gpu_ms(library),
        "device_us": device_us(kernel),
        "call_ms": gpu_ms(whole), "call_host_us": host_us(whole),
        "call_device_us": {k: us for k, (us, _) in trace.items()},
        "call_device_launches": sum(c for _, c in trace.values()),
    }
    # the indices and weights read once, the (15, 3) sums written once; one add per weight
    entry["bound_ms"], entry["bound_by"] = bound_ms(8 * n + 12 * n + 4 * 3 * CAL_BINS, 3 * n)
    return entry


# ------------------------------------------------------------- phase 11: the curves

F32_EPS = 2.0**-24
CURVE_PREFIX_BATCHES = 2  # the uncaptured twin's batches: its eager scan takes ~1 s of host per 1024-row step
CAPACITY_KEYS = ("preds_buf", "target_buf", "valid_buf", "count", "overflow")
SCAN_REASON = "state 'preds_buf' has dist_reduce_fx='cat'"  # the JAX package's segmented refusal
SCAN_FALLBACKS = {"dtype.bool:strategy": 1, "dtype.float32:strategy": 1, "dtype.int32:strategy": 1}


def curve_oracle(scores, positive):
    """One class's exact AUROC (Mann-Whitney with scipy's average ranks) and
    step AP in float64 from the f32 scores, with the bounds the port's f32
    computations are held to: the trapezoid over ``m`` curve points and the
    step sum over ``m`` PR points, (4m + 8) * 2**-24 (fpr, tpr and precision
    rounded once, each difference and product once more, the sum
    reassociated: 2 * m * 2**-24 * sum|terms| with sum|terms| <= 1); the
    capacity form's rank sum, 2 * P * 2**-24 * sum(positive ranks) plus the
    rounding of P(P+1)/2, over P * N; its AP sum (2m + 4) * 2**-24 * AP."""
    from scipy.stats import rankdata

    s = scores.astype(np.float64)
    p = int(positive.sum())
    nn = len(s) - p
    s_pos = float(rankdata(s)[positive].sum())
    auroc = (s_pos - p * (p + 1) / 2) / (p * nn)
    order = np.argsort(-s, kind="stable")
    ys, ss = positive[order], s[order]
    end = np.r_[ss[1:] != ss[:-1], True]
    tp, fp = np.cumsum(ys)[end], np.cumsum(~ys)[end]
    ap = float((np.diff(np.r_[0, tp]) * tp / (tp + fp)).sum() / p)
    m = int(end.sum()) + 1
    return {"auroc": auroc, "ap": ap, "points": m, "support": p, "tol_curve": (4 * m + 8) * F32_EPS,
            "tol_ranks": ((2 * p + 1) * s_pos + p * (p + 1) / 2) * F32_EPS / (p * nn) + 4 * F32_EPS,
            "tol_capacity_ap": (2 * m + 4) * F32_EPS * ap + F32_EPS}


def partial_auroc_oracle(scores, positive, max_fpr):
    """Binary AUROC up to ``max_fpr`` with the McClish correction, in float64
    (the ROC at distinct thresholds, a point added at ``max_fpr`` by linear
    interpolation), and its bound: the trapezoid's (4m + 16) * 2**-24 times
    the correction's scale 0.5 / (max_fpr - max_fpr**2 / 2)."""
    s = scores.astype(np.float64)
    order = np.argsort(-s, kind="stable")
    ys, ss = positive[order], s[order]
    end = np.r_[ss[1:] != ss[:-1], True]
    tps, fps = np.r_[0, np.cumsum(ys)[end]], np.r_[0, np.cumsum(~ys)[end]]
    fpr, tpr = fps / fps[-1], tps / tps[-1]
    stop = int(np.searchsorted(fpr, max_fpr, side="right"))
    w = (max_fpr - fpr[stop - 1]) / (fpr[stop] - fpr[stop - 1])
    tpr = np.r_[tpr[:stop], tpr[stop - 1] + w * (tpr[stop] - tpr[stop - 1])]
    fpr = np.r_[fpr[:stop], max_fpr]
    partial = float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2))
    min_area = 0.5 * max_fpr**2
    scale = 0.5 / (max_fpr - min_area)
    return 0.5 * (1 + (partial - min_area) / (max_fpr - min_area)), scale * (4 * len(fpr) + 16) * F32_EPS


def make_curve_collection(device):
    """The flagship collection with an exact AUROC and AP over static buffers
    that hold every main row: the scan members of phase 11(b)."""
    from metrics_tpu_torch import AUROC, AveragePrecision

    coll = make_collection(device)
    coll.add_metrics({"auroc": AUROC(num_classes=NUM_CLASSES, capacity=N_ROWS, device=device),
                      "ap": AveragePrecision(num_classes=NUM_CLASSES, capacity=N_ROWS, device=device)})
    return coll


def curves_eager(dev, preds, target):
    """Phase 11(a) on ``dev``: every exact curve metric over the main rows
    in 4 batches (AUROC macro and weighted, AP macro, ROC, PR curve, AUC of
    class 0's ROC, the binary AUROC of class 0 up to fpr 0.3), binned recall
    at precision 0.15 over 100 thresholds, the aggregators over the
    top-label confidences, and the AUROC and AP capacity states. Returns the
    values, the K2 launches of the weighted compute and the seconds."""
    import metrics_tpu_torch as mp
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda

    c = NUM_CLASSES
    ms = {"auroc_macro": mp.AUROC(num_classes=c, device=dev),
          "auroc_weighted": mp.AUROC(num_classes=c, average="weighted", device=dev),
          "ap_macro": mp.AveragePrecision(num_classes=c, device=dev),
          "roc": mp.ROC(num_classes=c, device=dev),
          "pr_curve": mp.PrecisionRecallCurve(num_classes=c, device=dev),
          "binned_recall": mp.BinnedRecallAtFixedPrecision(num_classes=c, min_precision=0.15,
                                                           thresholds=THRESHOLDS, device=dev),
          "auroc_capacity": mp.AUROC(num_classes=c, capacity=N_ROWS, device=dev),
          "ap_capacity": mp.AveragePrecision(num_classes=c, capacity=N_ROWS, device=dev)}
    binary = mp.AUROC(max_fpr=0.3, device=dev)
    aggs = {"mean": mp.MeanMetric(device=dev), "sum": mp.SumMetric(device=dev), "max": mp.MaxMetric(device=dev),
            "min": mp.MinMetric(device=dev), "cat": mp.CatMetric(device=dev)}
    conf = preds.max(dim=1).values
    t0 = time.perf_counter()
    for lo in range(0, N_ROWS, BATCH):
        p, t = preds[lo:lo + BATCH], target[lo:lo + BATCH]
        for m in ms.values():
            m.update(p, t)
        binary.update(p[:, 0], (t == 0).to(torch.int64))
        for m in aggs.values():
            m.update(conf[lo:lo + BATCH])
    before = histogram_cuda.launches
    out = {k: m.compute() for k, m in ms.items()}
    support_launches = histogram_cuda.launches - before
    out["auroc_binary_max_fpr"] = binary.compute()
    auc = mp.AUC(device=dev)
    auc.update(out["roc"][0][0], out["roc"][1][0])
    out["auc_class0"] = auc.compute()
    out.update({f"agg_{k}": m.compute() for k, m in aggs.items()})
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    states = {k: {s: getattr(ms[k], s) for s in CAPACITY_KEYS} for k in ("auroc_capacity", "ap_capacity")}
    states["binned_recall"] = {s: getattr(ms["binned_recall"], s) for s in ("TPs", "FPs", "FNs")}
    return out, states, support_launches, seconds


def hist_auroc_support_timing(dev, target):
    """K2's one-shot form as the weighted AUROC counts class support:
    ``(65 536,)`` int64 labels into 10 bins, exact against its plain
    version and ``torch.bincount`` (the library call)."""
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda, histogram_plain
    from metrics_tpu_torch.utils.data import _bincount

    idx = target.reshape(-1)
    i2 = idx[None]
    kernel = lambda: histogram_cuda(i2, NUM_CLASSES)  # noqa: E731
    plain = lambda: histogram_plain(i2, NUM_CLASSES)  # noqa: E731
    whole = lambda: _bincount(idx, NUM_CLASSES)  # noqa: E731
    library = lambda: torch.bincount(idx, minlength=NUM_CLASSES)  # noqa: E731
    want = plain()[0]
    for name, got in (("kernel", kernel()[0]), ("call", whole()), ("bincount", library())):
        check(torch.equal(got.to(want.dtype), want), f"hist AUROC support {name}: counts differ")
    trace = device_trace(whole)
    n = idx.numel()
    entry = {
        "name": "histogram", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/hist.cu",
        "replaces": "metrics_tpu/ops/kernels/pallas_hist.py:55",
        "shape": f"idx ({n},) int64 into {NUM_CLASSES} bins (weighted AUROC support, one-shot)",
        "max_abs_err": 0.0, "max_abs_err_bf16": None,  # counts: held exactly above
        "ms": gpu_ms(kernel), "plain_ms": gpu_ms(plain), "library_ms": gpu_ms(library),
        "device_us": device_us(kernel),
        "call_ms": gpu_ms(whole), "call_host_us": host_us(whole),
        "call_device_us": {k: us for k, (us, _) in trace.items()},
        "call_device_launches": sum(c for _, c in trace.values()),
    }
    # the labels read once, the 10 int32 counts written once; one add per label
    entry["bound_ms"], entry["bound_by"] = bound_ms(8 * n + 4 * NUM_CLASSES, n)
    return entry


def close_within(got, want, tol, what):
    g = float(got)
    check(abs(g - want) <= tol, f"{what}: {g} vs {want} (tol {tol})")
    return abs(g - want)


def check_curve_values(values, oracles, preds_np, what):
    """(a)'s values against the float64 oracles, each within its bound.
    Returns the largest error beside each bound."""
    errs = {}
    per = oracles["classes"]
    w = np.array([o["support"] for o in per], np.float64) / N_ROWS
    tol_curve = np.array([o["tol_curve"] for o in per])
    tol_ranks = np.array([o["tol_ranks"] for o in per])
    auroc = np.array([o["auroc"] for o in per])
    ap = np.array([o["ap"] for o in per])
    for key, want, tol in (
        ("auroc_macro", auroc.mean(), tol_curve.mean() + 16 * F32_EPS),
        ("auroc_weighted", (auroc * w).sum(), (tol_curve * w).sum() + 16 * F32_EPS),
        ("ap_macro", ap.mean(), tol_curve.mean() + 16 * F32_EPS),
        ("auroc_capacity", auroc.mean(), tol_ranks.mean() + 16 * F32_EPS),
        ("ap_capacity", ap.mean(), np.mean([o["tol_capacity_ap"] for o in per]) + 16 * F32_EPS),
        ("auc_class0", auroc[0], tol_curve[0]),
        ("auroc_binary_max_fpr", *oracles["binary_max_fpr"]),
    ):
        errs[key] = (close_within(values[key], float(want), float(tol), f"{what}: {key}"), float(tol))
    conf = preds_np.max(1).astype(np.float64)
    total = float(conf.sum())
    tol = (2 * N_ROWS + 4) * F32_EPS * total
    errs["agg_sum"] = (close_within(values["agg_sum"], total, tol, f"{what}: sum"), tol)
    errs["agg_mean"] = (close_within(values["agg_mean"], total / N_ROWS, 2 * tol / N_ROWS, f"{what}: mean"),
                        2 * tol / N_ROWS)
    check(float(values["agg_max"]) == float(preds_np.max(1).max()), f"{what}: max")
    check(float(values["agg_min"]) == float(preds_np.max(1).min()), f"{what}: min")
    check(torch.equal(values["agg_cat"].cpu(), torch.from_numpy(preds_np.max(1))), f"{what}: cat")
    return errs


def curve_capacity_reference(preds_np, target_np, batches):
    """The CPU port's eager capacity update over ``batches``: the bit-exact
    reference of the engine's scan-folded buffers."""
    from metrics_tpu_torch import AUROC, AveragePrecision

    ms = {"auroc": AUROC(num_classes=NUM_CLASSES, capacity=N_ROWS, device="cpu"),
          "ap": AveragePrecision(num_classes=NUM_CLASSES, capacity=N_ROWS, device="cpu")}
    for start, stop in batches:
        p, t = torch.from_numpy(preds_np[start:stop]), torch.from_numpy(target_np[start:stop])
        for m in ms.values():
            m.update(p, t)
    return {k: {s: getattr(m, s) for s in CAPACITY_KEYS} for k, m in ms.items()}


def curve_engine_run(dev, preds, target, batches, capture, aot_cache=None):
    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine

    eng = StreamingEngine(make_curve_collection(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep"),
                          aot_cache=aot_cache)
    seconds = run_engine(eng, capture, batches, lambda e, b: e.submit(preds[b[0]:b[1]], target[b[0]:b[1]]))
    check(eng.stats.kernel_fallbacks_by_reason() == SCAN_FALLBACKS,
          f"curve engine fallbacks {eng.stats.kernel_fallbacks_by_reason()}")
    return eng, seconds


def profile_scan_bucket(dev, preds, target, aot_cache):
    """One 1024-row bucket through a warm twin of the curve engine (its
    captured graph replayed): host wall µs of ``submit`` + ``flush`` (median
    of 5), and from one profiler trace the device µs and device launches of
    the replay (the graph's kernel nodes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine

    eng = StreamingEngine(make_curve_collection(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep"),
                          aot_cache=aot_cache)
    p, t = preds[:BUCKET], target[:BUCKET]

    def bucket():
        eng.submit(p, t)
        eng.flush()

    eng.start()
    walls = []
    for _ in range(6):  # at most 64 buckets into the 65 536-row buffers: no overflow
        t0 = time.perf_counter()
        bucket()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e6)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bucket()
        torch.cuda.synchronize()
    eng.stop()
    check(eng.stats.warmup_steps == 0, "scan bucket profile: the warm twin captured a step")
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = float(sum(e.self_device_time_total for e in device))
    wall = float(np.median(walls[1:]))
    check(busy > 0, "profiler: no device time in the scan bucket")
    return {"wall_us": wall, "device_busy_us": busy, "device_busy_share": busy / wall,
            "device_launches": sum(e.count for e in device),
            "top": [(e.key[:60], e.self_device_time_total) for e in sorted(device, key=lambda e: -e.self_device_time_total)[:6]]}


def flat_curves(v):
    """The tensors of a curve value (tuples and per-class lists), in order."""
    if isinstance(v, (list, tuple)):
        return [x for e in v for x in flat_curves(e)]
    return [v]


def curves_phase(dev, preds, target, preds_np, target_np):
    """Phase 11: the exact curves. (a) eager on the card against float64
    oracles and the CPU port, with the weighted AUROC's support in one K2
    launch; (b) the flagship collection plus capacity AUROC and AP through
    the captured megastep engine (the scan members demote every arena dtype:
    no K5), buffers bit-equal to the CPU port's eager capacity update, an
    uncaptured twin on a prefix; (c) both multi-stream forms refuse the scan
    members with the JAX package's reason."""
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine
    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

    out = {}
    oracles = {"classes": [curve_oracle(preds_np[:, k], target_np == k) for k in range(NUM_CLASSES)],
               "binary_max_fpr": partial_auroc_oracle(preds_np[:, 0], target_np == 0, 0.3)}
    gpu, gpu_states, support_launches, eager_s = curves_eager(dev, preds, target)
    cpu, cpu_states, _, _ = curves_eager(torch.device("cpu"), torch.from_numpy(preds_np), torch.from_numpy(target_np))
    check(support_launches == 1, f"weighted AUROC: {support_launches} K2 launches in its compute")
    errs = check_curve_values(gpu, oracles, preds_np, "curves (card)")
    check_curve_values(cpu, oracles, preds_np, "curves (CPU)")
    compare_states(gpu_states, cpu_states, "curves: card vs CPU")
    compare_states({"binned_recall": gpu_states["binned_recall"]},
                   {"binned_recall": oracle_states(preds_np, target_np)["binned_ap"]}, "binned recall vs numpy")
    for k in ("roc", "pr_curve", "binned_recall"):  # counts and f32 ratios of them: bit-equal
        for g, w in zip(flat_curves(gpu[k]), flat_curves(cpu[k])):
            check(g.dtype == w.dtype and torch.equal(g.cpu(), w), f"curves: {k} card vs CPU")
    out["eager"] = {"update_compute_s": eager_s, "auroc_support_k2_launches": support_launches,
                    "values": {k: float(v) for k, v in gpu.items() if k.startswith(("auroc", "ap", "auc", "agg_"))
                               and k != "agg_cat"},
                    "err_and_bound": errs}

    # (b) the captured megastep engine with two scan members
    batches = ragged_batches(SEED + 2, 16, BUCKET)
    before = counts()
    eng, seconds = curve_engine_run(dev, preds, target, batches, True)
    d = delta(before)
    n = eng.steps + eng.stats.warmup_steps
    check(d["megastep_fold"] == 0 and d["fold_rows"] > 0 and d["histogram"] == n and d["binned_counts"] == n,
          f"curve engine: {d} in {n} steps")
    state = eng.state()
    compare_states({k: state[k] for k in ("auroc", "ap")}, curve_capacity_reference(preds_np, target_np, batches),
                   "curve engine vs CPU eager capacity update")
    main_state, _, _ = main_path(dev, preds, target)
    compare_states({k: state[k] for k in main_state}, main_state, "curve engine flagship vs phase 4")
    values = eng.result()
    for key, member in (("auroc_capacity", "auroc"), ("ap_capacity", "ap")):
        tol = errs[key][1]
        close_within(values[member], float(gpu[key]), 2 * tol, f"curve engine {member} vs eager capacity")
    close_within(values["auroc"], float(gpu["auroc_macro"]), errs["auroc_macro"][1] + errs["auroc_capacity"][1],
                 "curve engine AUROC vs eager default mode")
    aot = check_cache(eng, "curve engine")
    prefix = batches[:CURVE_PREFIX_BATCHES]
    twin, twin_s = curve_engine_run(dev, preds, target, prefix, False)
    compare_states({k: twin.state()[k] for k in ("auroc", "ap")}, curve_capacity_reference(preds_np, target_np, prefix),
                   "uncaptured curve engine vs CPU eager capacity update")
    out["streaming_megastep"] = {
        "seconds": seconds, "steps": eng.steps, "warmup_steps": eng.stats.warmup_steps, "batches": len(batches),
        "ms_per_step": seconds / eng.steps * 1e3, "capture_seconds": aot["capture_seconds"], "aot": aot,
        "launches": d, "fallbacks": eng.stats.kernel_fallbacks_by_reason(),
        "uncaptured_prefix": {"batches": len(prefix), "steps": twin.steps, "seconds": twin_s,
                              "ms_per_step": twin_s / twin.steps * 1e3},
        "bucket_1024": profile_scan_bucket(dev, preds, target, eng.aot_cache)}

    # (c) the multi-stream engines refuse the scan members
    refusals = {}
    for name, kw in (("unsharded", {}), ("paged", {"stream_shard": True, "resident_streams": RESIDENT})):
        try:
            MultiStreamEngine(make_curve_collection(dev), MS_STREAMS, EngineConfig(buckets=(256, BUCKET)), **kw)
        except MetricsTPUUserError as e:
            refusals[name] = str(e)
        check(SCAN_REASON in refusals.get(name, ""), f"{name} multi-stream engine did not refuse the scan members")
    out["refusals"] = refusals
    return out


# -------------------------------------------- phase 12: wrappers and composition

BOOTSTRAPS = 10
TRACKER_EPOCHS = 3
PAGED_TWIN_BATCHES = 230  # the uncaptured paged twin's prefix (an eighth of the 1840 batches)
REFUSAL = "full_state_update metrics read the accumulated state in update"


def f1_composition(dev, average="macro"):
    """``2 * P * R / (P + R)`` over fresh Precision and Recall: each operand
    sits in both branches of the tree."""
    from metrics_tpu_torch import Precision, Recall

    p = Precision(num_classes=NUM_CLASSES, average=average, device=dev)
    r = Recall(num_classes=NUM_CLASSES, average=average, device=dev)
    return 2 * p * r / (p + r)


def make_wrapper_collection(device):
    """The flagship collection plus a composed F1 and a multinomial bootstrap
    of the accuracy: phase 12's served collection."""
    from metrics_tpu_torch import Accuracy, BootStrapper

    coll = make_collection(device)
    coll.add_metrics({
        "f1_composed": f1_composition(device),
        "boot": BootStrapper(Accuracy(num_classes=NUM_CLASSES, device=device), num_bootstraps=BOOTSTRAPS,
                             sampling_strategy="multinomial", seed=SEED),
    })
    return coll


def make_multioutput_collection(device, remove_nans=False):
    from metrics_tpu_torch import Accuracy, MetricCollection, MultioutputWrapper

    return MetricCollection({"multi": MultioutputWrapper(Accuracy(num_classes=NUM_CLASSES, device=device),
                                                         num_outputs=2, remove_nans=remove_nans)})


def two_head_rows(dev, preds_np, target_np):
    """Two heads over the main rows: head 0 the main rows, head 1 a second
    seeded distribution and labels; ``(N, 10, 2)`` probabilities, ``(N, 2)``
    labels."""
    rng = np.random.RandomState(SEED + 7)
    q = rng.rand(N_ROWS, NUM_CLASSES).astype(np.float32)
    q /= q.sum(axis=1, keepdims=True)
    p2 = np.ascontiguousarray(np.stack([preds_np, q], axis=-1))
    t2 = np.ascontiguousarray(np.stack([target_np, rng.randint(0, NUM_CLASSES, N_ROWS)], axis=-1))
    return p2, t2


def macro_f1_of(counts):
    tp, fp, fn = (np.asarray(counts[k], np.float64) for k in ("tp", "fp", "fn"))
    return float(np.mean(2 * tp / (2 * tp + fp + fn)))


def micro_accuracy(pred_label, target):
    return float((pred_label == target).mean())


def compare_trees(got, want, what):
    """Every leaf ``want`` names, in ``got``, equal to it (numbers exact)."""
    if isinstance(want, dict):
        for k, v in want.items():
            check(k in got, f"{what}: no {k}")
            compare_trees(got[k], v, f"{what}.{k}")
    elif isinstance(want, list):
        check(len(got) == len(want), f"{what}: {len(got)} vs {len(want)} entries")
        for i, (g, w) in enumerate(zip(got, want)):
            compare_trees(g, w, f"{what}[{i}]")
    else:
        g = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        w = want.detach().cpu().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
        check(g.shape == w.shape and np.array_equal(g.astype(np.float64), w.astype(np.float64)),
              f"{what}: differs")


def same_trees(a, b, what):
    """Two state trees bit for bit (same dtypes)."""
    from metrics_tpu_torch.utils.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    check(len(la) == len(lb), f"{what}: {len(la)} vs {len(lb)} leaves")
    for x, y in zip(la, lb):
        check(x.dtype == y.dtype and torch.equal(x, y), f"{what}: a leaf differs")


def wrapper_oracle(preds, target, template):
    """Every integer state of the served collection from numpy: the
    flagship's, the composition's (each occurrence of P and R counts every
    row twice: the operand is updated once per occurrence, as in the JAX
    package; ``template`` is the composition's state tree) and the
    bootstrap's (each replica sees each row once, ``draw_count`` counts the
    rows)."""
    base = oracle_states(preds, target)
    macro2 = {k: 2 * np.asarray(v) for k, v in base["f1"].items()}

    def doubled(tree):
        if isinstance(tree, list):
            return [doubled(v) for v in tree]
        return {k: doubled(v) if isinstance(v, (dict, list)) else macro2[k] for k, v in tree.items()}

    base["f1_composed"] = doubled(template)
    base["boot"] = {"draw_count": len(target), "_children": {"metrics": [base["acc"]] * BOOTSTRAPS}}
    return base


def wrapper_eager(dev, preds, target, preds_np, target_np):
    """Phase 12(a): the wrappers and compositions eagerly in 4 batches on the
    card, each against a numpy oracle (values within 1e-6, counts exact)."""
    from metrics_tpu_torch import (Accuracy, BootStrapper, F1Score, MetricTracker, MinMaxMetric, Precision,
                                   Recall)

    out = {}
    t0 = time.perf_counter()
    label = preds_np.argmax(1)
    batches = [(lo, lo + BATCH) for lo in range(0, N_ROWS, BATCH)]
    prefix_f1 = [macro_f1_of(oracle_states(preds_np[:hi], target_np[:hi])["f1"]) for _, hi in batches]
    # MinMax: prefix semantics, and the fold at compute
    for fold in (False, True):
        mm = MinMaxMetric(F1Score(num_classes=NUM_CLASSES, average="macro", device=dev), fold_on_compute=fold)
        for lo, hi in batches:
            mm.update(preds[lo:hi], target[lo:hi])
        v = mm.compute()
        lo_want, hi_want = (prefix_f1[-1], prefix_f1[-1]) if fold else (min(prefix_f1), max(prefix_f1))
        close_value(v["raw"], prefix_f1[-1], f"minmax fold={fold} raw")
        close_value(v["min"], lo_want, f"minmax fold={fold} min")
        close_value(v["max"], hi_want, f"minmax fold={fold} max")
        out[f"minmax{'_fold_on_compute' if fold else ''}"] = {k: float(x) for k, x in v.items()}
    # Multioutput over two heads, NaN rows planted, removed per head
    p2, t2 = two_head_rows(dev, preds_np, target_np)
    nan_rows = {0: [5, 1000, N_ROWS * 5 // 8], 1: [77, N_ROWS - 1]}
    for h, rows in nan_rows.items():
        p2[rows, 3, h] = np.nan
    mo = make_multioutput_collection(dev, remove_nans=True)["multi"]
    p2d, t2d = torch.from_numpy(p2).to(dev), torch.from_numpy(t2).to(dev)
    for lo, hi in batches:
        mo.update(p2d[lo:hi], t2d[lo:hi])
    v = mo.compute()
    for h, rows in nan_rows.items():
        keep = np.ones(N_ROWS, bool)
        keep[rows] = False
        close_value(v[h], micro_accuracy(p2[keep, :, h].argmax(1), t2[keep, h]), f"multioutput head {h}")
        check(int(mo.metrics[h].tp + mo.metrics[h].fn) == N_ROWS - len(rows), f"multioutput head {h}: rows kept")
    out["multioutput"] = [float(x) for x in v]
    # BootStrapper: poisson (the same numpy draws) and multinomial (the same generator state)
    for strategy in ("poisson", "multinomial"):
        boot = BootStrapper(Accuracy(num_classes=NUM_CLASSES, device=dev), num_bootstraps=BOOTSTRAPS, quantile=0.5,
                            raw=True, sampling_strategy=strategy, seed=SEED)
        rng, gen = np.random.RandomState(SEED), torch.Generator()
        gen.set_state(boot._generator.get_state())
        correct, total = np.zeros(BOOTSTRAPS), np.zeros(BOOTSTRAPS)
        for lo, hi in batches:
            boot.update(preds[lo:hi], target[lo:hi])
            for r in range(BOOTSTRAPS):
                if strategy == "poisson":
                    idx = np.repeat(np.arange(hi - lo), rng.poisson(1, hi - lo))
                else:
                    idx = torch.randint(0, hi - lo, (hi - lo,), generator=gen).numpy()
                correct[r] += (label[lo:hi][idx] == target_np[lo:hi][idx]).sum()
                total[r] += idx.size
        v = boot.compute()
        raw = correct / total
        for r, m in enumerate(boot.metrics):
            check(int(m.tp) == int(correct[r]) and int(m.tp + m.fn) == int(total[r]), f"bootstrap {strategy}: replica {r}")
        for got, want, name in ((v["mean"], raw.mean(), "mean"), (v["std"], raw.std(ddof=1), "std"),
                                (v["quantile"], np.quantile(raw, 0.5), "quantile")):
            close_value(got, want, f"bootstrap {strategy} {name}")
        for got, want in zip(v["raw"].tolist(), raw):
            close_value(got, want, f"bootstrap {strategy} raw")
        out[f"bootstrap_{strategy}"] = {"mean": float(v["mean"]), "std": float(v["std"])}
    # compositions: the F1 harmonic mean, a scalar operand, a comparison, an index
    macro = oracle_states(preds_np, target_np)["f1"]
    tp, fp, fn = (np.asarray(macro[k], np.float64) for k in ("tp", "fp", "fn"))
    prec_c, rec_c = tp / (tp + fp), tp / (tp + fn)
    pm, rm = prec_c.mean(), rec_c.mean()
    f1c, f1c_pct = f1_composition(dev), f1_composition(dev) * 100.0
    p_gt_r = Precision(num_classes=NUM_CLASSES, average="macro", device=dev) > Recall(
        num_classes=NUM_CLASSES, average="macro", device=dev)
    p3 = Precision(num_classes=NUM_CLASSES, average="none", device=dev)[3]
    per_class, f1_none = f1_composition(dev, "none"), F1Score(num_classes=NUM_CLASSES, average="none", device=dev)
    comps = (f1c, f1c_pct, p_gt_r, p3, per_class, f1_none)
    for lo, hi in batches:
        for c in comps:
            c.update(preds[lo:hi], target[lo:hi])
    close_value(f1c.compute(), 2 * pm * rm / (pm + rm), "composed F1")
    close_value(f1c_pct.compute(), 100 * 2 * pm * rm / (pm + rm), "composed F1 x 100")
    check(bool(p_gt_r.compute()) == bool(pm > rm), "P > R")
    close_value(p3.compute(), prec_c[3], "precision[3]")
    for got, want in zip(per_class.compute().tolist(), f1_none.compute().tolist()):
        close_value(got, want, "per-class composition vs F1Score(average='none')")
    compare_trees(f1c.metric_b.metric_a._pack_state(), {k: 2 * np.asarray(v) for k, v in macro.items()},
                  "composed F1: P's counts (two occurrences)")
    out["composition"] = {"f1_composed": float(f1c.compute()), "macro_f1": macro_f1_of(macro),
                          "precision_gt_recall": bool(p_gt_r.compute())}
    # MetricTracker over the flagship collection, 3 epochs (one batch each)
    tracker = MetricTracker(make_collection(dev), maximize=[True, True, True, True])
    f1_tracker = MetricTracker(F1Score(num_classes=NUM_CLASSES, average="macro", device=dev))
    epoch_f1 = []
    for lo, hi in batches[:TRACKER_EPOCHS]:
        for t in (tracker, f1_tracker):
            t.increment()
            t.update(preds[lo:hi], target[lo:hi])
        epoch_f1.append(macro_f1_of(oracle_states(preds_np[lo:hi], target_np[lo:hi])["f1"]))
    allv = tracker.compute_all()
    for e, (lo, hi) in enumerate(batches[:TRACKER_EPOCHS]):
        close_value(allv["f1"][e], epoch_f1[e], f"tracker epoch {e} F1")
        close_value(allv["acc"][e], micro_accuracy(label[lo:hi], target_np[lo:hi]), f"tracker epoch {e} accuracy")
        compare_trees(allv["confmat"][e], oracle_states(preds_np[lo:hi], target_np[lo:hi])["confmat"]["confmat"],
                      f"tracker epoch {e} confmat")
    step, best = f1_tracker.best_metric(return_step=True)
    check(step == int(np.argmax(epoch_f1)), f"tracker best step {step}")
    close_value(best, max(epoch_f1), "tracker best F1")
    out["tracker"] = {"best_step": step, "best_f1": best}
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    return out


def wrapper_engine_run(dev, batches, submit, capture, make, cfg, aot_cache=None, **kw):
    from metrics_tpu_torch.engine import MultiStreamEngine, StreamingEngine

    if kw:
        eng = MultiStreamEngine(make(dev), PAGED_STREAMS, cfg, aot_cache=aot_cache, **kw)
    else:
        eng = StreamingEngine(make(dev), cfg, aot_cache=aot_cache)
    return eng, run_engine(eng, capture, batches, submit)


def wrapper_phase(dev, preds, target, preds_np, target_np):
    """Phase 12: (a) the wrappers and compositions eagerly; (b) the flagship
    plus a composed F1 and a multinomial BootStrapper through the captured
    megastep ``StreamingEngine`` (with its uncaptured and warm twins) and the
    captured paged ``MultiStreamEngine`` (an uncaptured twin on a prefix),
    and ``MultioutputWrapper(remove_nans=False)`` through the megastep engine
    on two-head rows; integer states, children included, bit-equal to the
    twins and to numpy; (c) the refusals."""
    from metrics_tpu_torch import Accuracy, MetricCollection, MinMaxMetric
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, StreamingEngine
    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError
    from metrics_tpu_torch.utils.tree import tree_map

    out = {"eager": wrapper_eager(dev, preds, target, preds_np, target_np)}
    template = make_wrapper_collection(torch.device("cpu")).init_state()["f1_composed"]

    # (b) the captured megastep engine, its uncaptured twin and a warm twin
    mega = EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep")
    batches = ragged_batches(SEED + 2, 16, BUCKET)
    submit = lambda e, b: e.submit(preds[b[0]:b[1]], target[b[0]:b[1]])  # noqa: E731
    before = counts()
    eng, seconds = wrapper_engine_run(dev, batches, submit, True, make_wrapper_collection, mega)
    d = delta(before)
    n = eng.steps + eng.stats.warmup_steps
    check(eng.stats.kernel_fallbacks_by_reason() == {}, f"wrapper engine fell back: {eng.stats.kernel_fallbacks}")
    check(d["megastep_fold"] == 3 * n and d["fold_rows"] == 0, f"wrapper engine: {d} in {n} steps")
    state = eng.state()
    compare_trees(state, wrapper_oracle(preds_np, target_np, template), "wrapper engine vs numpy")
    aot = check_cache(eng, "wrapper engine")
    unc, unc_seconds = wrapper_engine_run(dev, batches, submit, False, make_wrapper_collection, mega)
    same_trees(unc.state(), state, "wrapper engine: uncaptured vs captured")
    twin, twin_seconds = wrapper_engine_run(dev, batches, submit, True, make_wrapper_collection, mega,
                                            aot_cache=eng.aot_cache)
    check(twin.stats.warmup_steps == 0 and eng.aot_cache.misses == aot["misses"], "wrapper warm twin captured")
    same_trees(twin.state(), state, "wrapper engine: warm twin vs first")
    value = eng.result()
    close_value(value["boot"]["mean"], value["acc"], "served bootstrap mean vs accuracy")
    close_value(value["boot"]["std"], 0.0, "served bootstrap std")
    out["streaming_megastep"] = {
        "steps": eng.steps, "batches": len(batches), "seconds": seconds, "ms_per_step": seconds / eng.steps * 1e3,
        "capture_seconds": aot["capture_seconds"], "aot": aot, "launches": d,
        "uncaptured_ms_per_step": unc_seconds / unc.steps * 1e3,
        "warm_twin": {"warmup_steps": twin.stats.warmup_steps, "ms_per_step": twin_seconds / twin.steps * 1e3},
        "bucket_1024": profile_bucket(dev, preds, target, make=make_wrapper_collection)}

    # the paged engine: an uncaptured twin on a prefix, then the rest captured
    paged = EngineConfig(buckets=PAGED_BUCKETS, kernel_backend="megastep")
    pbatches = ragged_batches(SEED + 4, 8, 64)
    sids = zipf_stream_ids(PAGED_STREAMS, len(pbatches), ALPHA, SEED + 4)
    items = list(zip(sids, pbatches))
    psubmit = lambda e, b: e.submit(int(b[0]), preds[b[1][0]:b[1][1]], target[b[1][0]:b[1][1]])  # noqa: E731
    pkw = {"stream_shard": True, "resident_streams": RESIDENT}
    before = counts()
    peng, p_first = wrapper_engine_run(dev, items[:PAGED_TWIN_BATCHES], psubmit, True, make_wrapper_collection, paged,
                                       **pkw)
    punc, punc_seconds = wrapper_engine_run(dev, items[:PAGED_TWIN_BATCHES], psubmit, False, make_wrapper_collection,
                                            paged, **pkw)
    same_trees(punc.state(), peng.state(), "paged wrapper engine: uncaptured vs captured prefix")
    p_rest = run_engine(peng, True, items[PAGED_TWIN_BATCHES:], psubmit)
    pd = delta(before)
    check(pd["megastep_segment"] > 0 and peng.stats.kernel_fallbacks_by_reason() == {},
          f"paged wrapper engine: {pd}, {peng.stats.kernel_fallbacks}")
    check(peng.stats.page_outs > 0, "paged wrapper engine: nothing was spilled")
    # every stream: the sums over streams equal the counts over all rows
    stacked = tree_map(lambda x: x.cpu().numpy().astype(np.int64).sum(0) if not x.is_floating_point()
                       else x.double().sum(0).cpu().numpy(), peng.state())
    compare_trees(stacked, wrapper_oracle(preds_np, target_np, template), "paged wrapper engine: sum over streams")
    per_stream = stream_rows(sids, pbatches)
    busiest = sorted(per_stream, key=lambda s: -len(per_stream[s]))[:10]
    quiet = [s for s in sorted(per_stream) if len(per_stream[s]) < 64][:10]
    for sid in busiest + quiet + [s for s in range(0, PAGED_STREAMS, 997) if s not in per_stream][:3]:
        idx = per_stream.get(sid, np.zeros(0, np.int64))
        compare_trees(peng.stream_state(sid), wrapper_oracle(preds_np[idx], target_np[idx], template),
                      f"paged wrapper engine: stream {sid}")
    paot = check_cache(peng, "paged wrapper engine")
    out["paged"] = {"steps": peng.steps, "batches": len(items), "seconds": p_first + p_rest,
                    "ms_per_step": (p_first + p_rest) / peng.steps * 1e3, "capture_seconds": paot["capture_seconds"],
                    "aot": paot, "launches": pd, "page_outs": peng.stats.page_outs, "page_ins": peng.stats.page_ins,
                    "uncaptured_prefix": {"batches": PAGED_TWIN_BATCHES, "steps": punc.steps,
                                          "ms_per_step": punc_seconds / punc.steps * 1e3}}

    # MultioutputWrapper(remove_nans=False) through the megastep engine on two-head rows
    p2, t2 = two_head_rows(dev, preds_np, target_np)
    p2d, t2d = torch.from_numpy(p2).to(dev), torch.from_numpy(t2).to(dev)
    msubmit = lambda e, b: e.submit(p2d[b[0]:b[1]], t2d[b[0]:b[1]])  # noqa: E731
    meng, m_seconds = wrapper_engine_run(dev, batches, msubmit, True, make_multioutput_collection, mega)
    munc, _ = wrapper_engine_run(dev, batches, msubmit, False, make_multioutput_collection, mega)
    same_trees(munc.state(), meng.state(), "multioutput engine: uncaptured vs captured")
    want = {"multi": {"_children": {"metrics": [oracle_states(p2[:, :, h], t2[:, h])["acc"] for h in range(2)]}}}
    compare_trees(meng.state(), want, "multioutput engine vs numpy")
    out["multioutput_megastep"] = {"steps": meng.steps, "ms_per_step": m_seconds / meng.steps * 1e3,
                                   "capture_seconds": meng.aot_cache.stats()["capture_seconds"]}

    # (c) the refusals
    refusals = {}
    minmax = MetricCollection({"minmax": MinMaxMetric(Accuracy(device=dev))})
    for name, build in (("streaming", lambda: StreamingEngine(minmax, mega)),
                        ("paged", lambda: MultiStreamEngine(minmax, PAGED_STREAMS, paged, **pkw))):
        try:
            build()
        except MetricsTPUUserError as e:
            refusals[name] = str(e)
        check(REFUSAL in refusals.get(name, ""), f"the {name} engine did not refuse MinMaxMetric")
    nan_multi = make_multioutput_collection(dev, remove_nans=True)
    try:
        nan_multi.update_state_masked(nan_multi.init_state(), p2d[:BUCKET], t2d[:BUCKET],
                                      mask=torch.ones(BUCKET, dtype=torch.bool, device=dev))
        refusals["multioutput_remove_nans_masked"] = None
    except RuntimeError as e:
        refusals["multioutput_remove_nans_masked"] = str(e)[:120]
    check(refusals["multioutput_remove_nans_masked"] is not None,
          "a masked update of MultioutputWrapper(remove_nans=True) did not raise")
    out["refusals"] = refusals
    return out


# ---------------------------------------------------- phase 13: regression and pairwise

TWEEDIE_POWERS = (0.0, 1.0, 1.5, 2.0, 3.0)
SERVED_POWER = 1.5
MAPE_EPS = 1.17e-06
U32 = 2.0 ** -24  # the f32 unit roundoff
CORR_TOL = 1e-5
COSINE_DIM = 16
REG_SHARDS = 4
# the uncaptured twins' prefixes (each engine's captured run goes on past it)
REG_TWIN_BATCHES = {"streaming_megastep": 24, "multistream": 24, "paged": 240}
PAIR_ROWS, PAIR_DIM, MANHATTEN_ROWS, PAIR_SAMPLE = 8192, 512, 1024, 256
REG_REFUSALS = {  # the JAX package's reasons
    ("pearson", "streaming"): "full_state_update metrics read the accumulated state in update; a row fold is not exact",
    ("pearson", "multistream"): "full_state_update metrics read the accumulated state in update; row deltas are not exact",
    ("list", "streaming"): "state 'preds' is a list (cat/gather) state with no static shape",
    ("list", "multistream"): "state 'preds' is a list (cat/gather) state",
}
R2_REASON = "R2Score's compute reads n_obs on the host"


def regression_rows(dev):
    """Phase 13's seeded rows: gamma(2, 1) targets, and the targets times
    log-normal(0, 0.3) noise as predictions. Both are positive, so the log
    error and every Tweedie power are defined."""
    rng = np.random.RandomState(SEED + 13)
    t = rng.gamma(2.0, 1.0, N_ROWS).astype(np.float32)
    p = (t * np.exp(rng.normal(0.0, 0.3, N_ROWS))).astype(np.float32)
    return torch.from_numpy(p).to(dev), torch.from_numpy(t).to(dev), p, t


def make_regression_collection(device):
    """The eight members whose value the engines serve (phase 13(b))."""
    from metrics_tpu_torch import (ExplainedVariance, MeanAbsoluteError, MeanAbsolutePercentageError,
                                   MeanSquaredError, MeanSquaredLogError, MetricCollection,
                                   SymmetricMeanAbsolutePercentageError, TweedieDevianceScore)

    return MetricCollection({
        "mse": MeanSquaredError(device=device),
        "rmse": MeanSquaredError(squared=False, device=device),
        "mae": MeanAbsoluteError(device=device),
        "msle": MeanSquaredLogError(device=device),
        "mape": MeanAbsolutePercentageError(device=device),
        "smape": SymmetricMeanAbsolutePercentageError(device=device),
        "explained_variance": ExplainedVariance(device=device),
        "tweedie": TweedieDevianceScore(power=SERVED_POWER, device=device),
    })


def make_r2_collection(device):
    """R2Score alone: its updates serve, its value does not."""
    from metrics_tpu_torch import MetricCollection, R2Score

    return MetricCollection({"r2": R2Score(device=device)})


def tweedie_parts(p, t, power):
    """The float64 deviance per row at ``power``, and the magnitude of the
    parts each is computed from (what its f32 rounding scales with)."""
    if power == 0:
        d = (t - p) ** 2
        return d, d
    if power == 1:
        a = t * np.log(t / p)
        return 2 * (a + p - t), 2 * (np.abs(a) + p + t)
    if power == 2:
        a = np.log(p / t)
        return 2 * (a + t / p - 1), 2 * (np.abs(a) + t / p + 1)
    t1 = t ** (2 - power) / ((1 - power) * (2 - power))
    t2 = t * p ** (1 - power) / (1 - power)
    t3 = p ** (2 - power) / (2 - power)
    return 2 * (t1 - t2 + t3), 2 * (np.abs(t1) + np.abs(t2) + np.abs(t3))


def regression_terms(p, t, power=SERVED_POWER):
    """Per row, every state of the served members and of R2Score in float64:
    ``(term, parts)`` for an f32 sum (``parts`` bounds the term's own
    rounding), a plain array for an integer count."""
    p, t = p.astype(np.float64), t.astype(np.float64)
    d = p - t
    lp, lt = np.log1p(p), np.log1p(t)
    ld = lp - lt
    ones = np.ones_like(p)
    ape = np.abs(d) / np.maximum(np.abs(t), MAPE_EPS)
    sape = 2 * np.abs(d) / np.maximum(np.abs(t) + np.abs(p), MAPE_EPS)
    dev, parts = tweedie_parts(p, t, power)
    sq = (d * d, d * d)
    return {
        "mse": {"sum_squared_error": sq, "total": ones},
        "rmse": {"sum_squared_error": sq, "total": ones},
        "mae": {"sum_abs_error": (np.abs(d), np.abs(d)), "total": ones},
        "msle": {"sum_squared_log_error": (ld * ld, 2 * np.abs(ld) * (np.abs(lp) + np.abs(lt) + np.abs(ld))),
                 "total": ones},
        "mape": {"sum_abs_per_error": (ape, ape), "total": (ones, ones)},
        "smape": {"sum_abs_per_error": (sape, sape), "total": (ones, ones)},
        "explained_variance": {"sum_error": (-d, np.abs(d)), "sum_squared_error": sq, "sum_target": (t, t),
                               "sum_squared_target": (t * t, t * t), "n_obs": (ones, ones)},
        "tweedie": {"sum_deviance_score": (dev, parts), "num_observations": ones},
        "r2": {"sum_squared_error": (t * t, t * t), "sum_error": (t, t), "residual": sq, "total": ones},
    }


def regression_oracle(p, t, groups=None, num_groups=1, power=SERVED_POWER):
    """Every state's float64 sum, per group of rows (``groups``: each row's
    stream; None: one group), as ``{member: {state: (sum, bound)}}``; an
    integer count's bound is 0. An f32 sum of n terms is within
    2^-24 (2 n Σ|term| + 8 Σ parts) of the exact one: the reassociation
    bound of the masked folds, plus each term's own rounding."""
    groups = np.zeros(len(p), np.int64) if groups is None else groups
    n = np.bincount(groups, minlength=num_groups).astype(np.float64)
    out = {}
    for member, states in regression_terms(p, t, power).items():
        out[member] = {}
        for name, v in states.items():
            if isinstance(v, tuple):
                term, parts = v
                s = np.bincount(groups, weights=term, minlength=num_groups)
                mag = np.bincount(groups, weights=np.abs(term), minlength=num_groups)
                par = np.bincount(groups, weights=parts, minlength=num_groups)
                out[member][name] = (s, U32 * (2 * n * mag + 8 * par))
            else:
                out[member][name] = (np.bincount(groups, weights=v, minlength=num_groups), np.zeros(num_groups))
    return out


def check_regression_states(state, oracle, what):
    """Every leaf of ``state`` (stream-stacked or not) within its oracle bound;
    integer counts exact."""
    errs = {}
    for member, states in oracle.items():
        if member not in state:
            continue
        for name, (want, bound) in states.items():
            got = state[member][name].detach().double().cpu().numpy().reshape(len(want))
            err = np.abs(got - want)
            if state[member][name].is_floating_point():
                check(np.all(err <= bound), f"{what}: {member}.{name} err {err.max()} over bound {bound.max()}")
            else:
                check(np.array_equal(got, want), f"{what}: {member}.{name} count differs")
            errs[f"{member}.{name}"] = float(err.max()) if err.size else 0.0
    return errs


def _ev(s):
    n = s["n_obs"]
    num = s["sum_squared_error"] / n - (s["sum_error"] / n) ** 2
    den = s["sum_squared_target"] / n - (s["sum_target"] / n) ** 2
    return np.where((num != 0) & (den != 0), 1 - num / np.where(den != 0, den, 1), np.where(num != 0, 0.0, 1.0))


def _r2(s):
    n = s["total"]
    return 1 - s["residual"] / (s["sum_squared_error"] - s["sum_error"] * s["sum_error"] / n)


REG_VALUES = {
    "mse": lambda s: s["sum_squared_error"] / s["total"],
    "rmse": lambda s: np.sqrt(s["sum_squared_error"] / s["total"]),
    "mae": lambda s: s["sum_abs_error"] / s["total"],
    "msle": lambda s: s["sum_squared_log_error"] / s["total"],
    "mape": lambda s: s["sum_abs_per_error"] / s["total"],
    "smape": lambda s: s["sum_abs_per_error"] / s["total"],
    "explained_variance": _ev,
    "tweedie": lambda s: s["sum_deviance_score"] / s["num_observations"],
    "r2": _r2,
}


def regression_values(oracle):
    """Each member's value from its oracle sums, with the slack its f32
    compute may take: the value's move under each sum moved by its bound,
    plus 8 roundings of the intermediates the explained variance and R2
    subtract (their cancellation). Returns ``{member: (value, slack)}``."""
    out = {}
    with np.errstate(divide="ignore", invalid="ignore"):
        for member, states in oracle.items():
            s = {k: v for k, (v, _) in states.items()}
            fn = REG_VALUES[member]
            value = fn(s)
            slack = np.zeros_like(value)
            for k, (v, b) in states.items():
                move = np.zeros_like(value)
                for sign in (1, -1):
                    move = np.maximum(move, np.nan_to_num(np.abs(fn({**s, k: v + sign * b}) - value)))
                slack = slack + move
            n = s.get("n_obs", s.get("total"))
            if member == "explained_variance":
                a, b = s["sum_squared_error"] / n, (s["sum_error"] / n) ** 2
                c, e = s["sum_squared_target"] / n, (s["sum_target"] / n) ** 2
                slack = slack + 8 * U32 * np.nan_to_num((a + b) / np.abs(c - e) + np.abs(a - b) * (c + e) / (c - e) ** 2)
            if member == "r2":
                ss, se, rss = s["sum_squared_error"], s["sum_error"], s["residual"]
                tss = ss - se * se / n
                slack = slack + 8 * U32 * np.nan_to_num(rss * (ss + se * se / n) / tss ** 2 + np.abs(rss / tss))
            out[member] = (value, slack)
    return out


def check_regression_values(values, oracle_values, what):
    """``values`` (``{member: tensor}``, stream-stacked or not) within 1e-6
    relative plus 1e-6 of the oracle's, plus its slack; equal NaNs agree
    (an untouched stream's 0/0)."""
    worst = {}
    for member, got in values.items():
        want, slack = oracle_values[member]
        g = np.asarray([float(x) for x in got], np.float64) if isinstance(got, list) else \
            got.detach().double().cpu().numpy().reshape(len(want))
        err = np.abs(g - want)
        ok = (err <= 1e-6 * np.abs(want) + 1e-6 + slack) | (np.isnan(g) & np.isnan(want))
        check(np.all(ok), f"{what}: {member} {g[~ok][:3]} vs {want[~ok][:3]} (slack {slack[~ok][:3]})")
        worst[member] = float(np.nanmax(np.where(np.isnan(err), 0, err))) if err.size else 0.0
    return worst


def regression_eager(dev, p, t, pn, tn):
    """Phase 13(a): each regression metric over 4 batches and each functional
    over all rows on the card, against float64 numpy (scipy's correlations);
    Tweedie at every power; Pearson's Chan fold of 4 hand-stacked shards; the
    served collection through the masked bucket step (K1), padded with rows
    outside every domain."""
    from scipy import stats

    import metrics_tpu_torch.functional as F
    from metrics_tpu_torch import CosineSimilarity, PearsonCorrCoef, R2Score, SpearmanCorrCoef, TweedieDevianceScore

    out = {}
    t0 = time.perf_counter()
    batches = [(lo, lo + BATCH) for lo in range(0, N_ROWS, BATCH)]
    oracle = regression_oracle(pn, tn)
    want = regression_values(oracle)
    # the served members and R2Score
    coll, r2 = make_regression_collection(dev), R2Score(device=dev)
    for lo, hi in batches:
        coll.update(p[lo:hi], t[lo:hi])
        r2.update(p[lo:hi], t[lo:hi])
    state = {k: m._pack_state() for k, m in coll.items(keep_base=True)}
    state["r2"] = r2._pack_state()
    out["state_err"] = check_regression_states(state, oracle, "eager")
    values = {k: v for k, v in coll.compute().items()}
    values["r2"] = r2.compute()
    out["value_err"] = check_regression_values(values, want, "eager")
    out["values"] = {k: float(v) for k, v in values.items()}
    # the functionals over every row at once
    fvalues = {"mse": F.mean_squared_error(p, t), "rmse": F.mean_squared_error(p, t, squared=False),
               "mae": F.mean_absolute_error(p, t), "msle": F.mean_squared_log_error(p, t),
               "mape": F.mean_absolute_percentage_error(p, t), "smape": F.symmetric_mean_absolute_percentage_error(p, t),
               "explained_variance": F.explained_variance(p, t), "r2": F.r2_score(p, t),
               "tweedie": F.tweedie_deviance_score(p, t, power=SERVED_POWER)}
    out["functional_err"] = check_regression_values(fvalues, want, "functional")
    # Tweedie at every power, metric and functional
    tweedie = {}
    for power in TWEEDIE_POWERS:
        sub = {"tweedie": regression_oracle(pn, tn, power=power)["tweedie"]}
        m = TweedieDevianceScore(power=power, device=dev)
        for lo, hi in batches:
            m.update(p[lo:hi], t[lo:hi])
        check_regression_states({"tweedie": m._pack_state()}, sub, f"tweedie power {power}")
        w = regression_values(sub)
        check_regression_values({"tweedie": m.compute()}, w, f"tweedie power {power}")
        check_regression_values({"tweedie": F.tweedie_deviance_score(p, t, power=power)}, w,
                                f"tweedie functional power {power}")
        tweedie[str(power)] = float(m.compute())
    out["tweedie"] = tweedie
    # the correlations, against scipy in float64
    p64, t64 = pn.astype(np.float64), tn.astype(np.float64)
    pearson_want, spearman_want = stats.pearsonr(p64, t64)[0], stats.spearmanr(p64, t64)[0]
    pearson, spearman = PearsonCorrCoef(device=dev), SpearmanCorrCoef(device=dev)
    shards = [PearsonCorrCoef(device=dev) for _ in range(REG_SHARDS)]
    for (lo, hi), shard in zip(batches, shards):
        for m in (pearson, spearman, shard):
            m.update(p[lo:hi], t[lo:hi])
    stacked = {k: torch.stack([getattr(s, k) for s in shards]) for k in shards[0]._defaults}
    corr = {"pearson": float(pearson.compute()), "pearson_functional": float(F.pearson_corrcoef(p, t)),
            "pearson_chan_fold": float(pearson.compute_from(stacked)),
            "spearman": float(spearman.compute()), "spearman_functional": float(F.spearman_corrcoef(p, t))}
    for k, v in corr.items():
        w = spearman_want if k.startswith("spearman") else pearson_want
        check(abs(v - w) <= CORR_TOL, f"{k}: {v} vs scipy {w}")
    out["correlations"] = {**corr, "scipy_pearson": float(pearson_want), "scipy_spearman": float(spearman_want)}
    # cosine similarity of (N / 16, 16) vectors
    pv, tv = p.reshape(-1, COSINE_DIM), t.reshape(-1, COSINE_DIM)
    p2, t2 = p64.reshape(-1, COSINE_DIM), t64.reshape(-1, COSINE_DIM)
    cos = (p2 * t2).sum(1) / np.sqrt((p2 * p2).sum(1) * (t2 * t2).sum(1))
    cosine = CosineSimilarity(reduction="mean", device=dev)
    rows = len(pv) // REG_SHARDS
    for lo in range(0, len(pv), rows):
        cosine.update(pv[lo:lo + rows], tv[lo:lo + rows])
    got = {"mean": float(cosine.compute()), "sum": float(F.cosine_similarity(pv, tv))}
    check(abs(got["mean"] - cos.mean()) <= CORR_TOL, f"cosine mean: {got['mean']} vs {cos.mean()}")
    check(abs(got["sum"] - cos.sum()) <= CORR_TOL * len(cos), f"cosine sum: {got['sum']} vs {cos.sum()}")
    none = F.cosine_similarity(pv, tv, reduction="none").double().cpu().numpy()
    check(np.abs(none - cos).max() <= CORR_TOL, "cosine per row")
    out["cosine"] = got
    # the served collection through masked 1024-row buckets (K1), padding outside every domain
    rng = np.random.RandomState(SEED + 15)
    mcoll = make_regression_collection(dev)
    mstate = mcoll.init_state()
    lo, buckets = 0, 0
    while lo < N_ROWS:
        valid = min(int(rng.randint(BUCKET // 2, BUCKET + 1)), N_ROWS - lo)
        bp = np.full(BUCKET, -1.0, np.float32)  # log1p(-1) = -inf, a negative Tweedie prediction
        bt = np.full(BUCKET, np.nan, np.float32)
        bp[:valid], bt[:valid] = pn[lo:lo + valid], tn[lo:lo + valid]
        mask = np.arange(BUCKET) < valid
        mstate = mcoll.update_state_masked(mstate, torch.from_numpy(bp).to(dev), torch.from_numpy(bt).to(dev),
                                           mask=torch.from_numpy(mask).to(dev))
        lo += valid
        buckets += 1
    out["masked_buckets"] = buckets
    out["masked_state_err"] = check_regression_states(mstate, oracle, "masked buckets")
    check_regression_values(mcoll.compute_from(mstate), want, "masked buckets")
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    return out


def regression_engine(dev, make, kind, capture, items):
    """A regression engine of ``kind`` (phase 7's megastep ``StreamingEngine``,
    phase 8's unsharded or phase 9a's paged ``MultiStreamEngine``), one batch
    a step (``coalesce=1``: grouping follows timing, and f32 sums folded in
    other groups differ in their last bits), driven over ``items``."""
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, StreamingEngine

    if kind == "streaming_megastep":
        eng = StreamingEngine(make(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep", coalesce=1))
    elif kind == "multistream":
        eng = MultiStreamEngine(make(dev), MS_STREAMS, EngineConfig(buckets=(256, BUCKET), coalesce=1))
    else:
        eng = MultiStreamEngine(make(dev), PAGED_STREAMS, EngineConfig(buckets=PAGED_BUCKETS, kernel_backend="megastep",
                                                                       coalesce=1),
                                stream_shard=True, resident_streams=RESIDENT)
    return eng, regression_run(eng, capture, items)


def regression_run(eng, capture, items):
    return run_engine(eng, capture, items, lambda e, b: e.submit(*b))


def regression_served(dev, p, t, pn, tn):
    """Phase 13(b): the served collection and R2Score alone through three
    engines, each first over an uncaptured twin's prefix (bit-equal), then
    on to every row captured; every state (every stream's) within its bound
    of the float64 oracle; the collection's values from ``result()`` or one
    timed ``results()`` against the oracle's; R2Score's served value raises."""
    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

    out = {}
    layouts = {
        "streaming_megastep": (ragged_batches(SEED + 2, 16, BUCKET), None),
        "multistream": (ragged_batches(SEED + 3, 16, BUCKET), MS_STREAMS),
        "paged": (ragged_batches(SEED + 4, 8, 64), PAGED_STREAMS),
    }
    for kind, (batches, streams) in layouts.items():
        if streams is None:
            items = [(p[a:b], t[a:b]) for a, b in batches]
            groups, num = None, 1
        else:
            sids = zipf_stream_ids(streams, len(batches), ALPHA, SEED + (3 if kind == "multistream" else 4))
            items = [(int(s), p[a:b], t[a:b]) for s, (a, b) in zip(sids, batches)]
            groups = np.repeat(sids.astype(np.int64), [b - a for a, b in batches])
            num = streams
        oracle = regression_oracle(pn, tn, groups, num)
        prefix = REG_TWIN_BATCHES[kind]
        for name, make in (("regression", make_regression_collection), ("r2", make_r2_collection)):
            before = counts()
            eng, first = regression_engine(dev, make, kind, True, items[:prefix])
            mid = counts()
            twin, twin_seconds = regression_engine(dev, make, kind, False, items[:prefix])
            d_twin = delta(mid)
            same_trees(twin.state(), eng.state(), f"{kind} {name}: uncaptured twin vs captured, {prefix} batches")
            resumed = counts()
            rest = regression_run(eng, True, items[prefix:])
            d = {k: v + mid[k] - before[k] for k, v in delta(resumed).items()}
            check(eng.stats.kernel_fallbacks_by_reason() == {}, f"{kind} {name} fell back: {eng.stats.kernel_fallbacks}")
            # every step the card ran: the served ones and each capture's warm-up; two arena dtypes (f32, int32)
            for e, launched in ((eng, d), (twin, d_twin)):
                n = e.steps + e.stats.warmup_steps
                if kind == "streaming_megastep":
                    ok = launched["megastep_fold"] == 2 * n and launched["fold_rows"] == 0
                elif kind == "multistream":
                    ok = launched["segment_reduce"] == e.arena_layout.num_leaves * n
                else:
                    ok = launched["megastep_segment"] == 2 * n and e.stats.page_outs > 0
                check(ok, f"{kind} {name}: {launched} in {n} steps")
            state = eng.state()
            entry = {"steps": eng.steps, "batches": len(items), "seconds": first + rest,
                     "ms_per_step": (first + rest) / eng.steps * 1e3, "launches": d,
                     "aot": check_cache(eng, f"{kind} {name}"),
                     "uncaptured_prefix": {"batches": prefix, "steps": twin.steps,
                                           "ms_per_step": twin_seconds / twin.steps * 1e3},
                     "state_err": check_regression_states(state, {k: oracle[k] for k in state}, f"{kind} {name}")}
            if kind == "paged":
                entry.update(page_ins=eng.stats.page_ins, page_outs=eng.stats.page_outs)
            want = regression_values({k: oracle[k] for k in state})
            if name == "r2":
                for call in ([eng.result] if streams is None else [eng.results, lambda: eng.result(0)]):
                    try:
                        call()
                        raised = None
                    except MetricsTPUUserError as e:
                        raised = str(e)
                    check(raised is not None and R2_REASON in raised, f"{kind}: R2Score's served value did not raise")
                entry["served_value_raises"] = raised[:80]
                # the eager compute of the served state works: every stream's would take seconds, so 16 of them
                r2 = eng._metric["r2"]
                picked = [0] if streams is None else sorted(int(s) for s in np.unique(groups)[:: max(1, num // 16)])
                got = [r2.compute_from(eng.state()["r2"] if streams is None else eng.stream_state(sid)["r2"])
                       for sid in picked]
                w, slack = want["r2"]
                entry["value_err_eager"] = check_regression_values(
                    {"r2": got}, {"r2": (w[picked], slack[picked])}, f"{kind} r2 eager on served state")
            elif streams is None:
                entry["value_err"] = check_regression_values(eng.result(), want, f"{kind} result()")
            else:
                sample = range(streams) if kind == "multistream" else \
                    result_sample(eng, {int(s) for s in np.unique(groups)})
                entry["results"] = results_timing(eng, sample)
                values = eng.results()
                stacked = {m: [values[sid][m] for sid in range(streams)] for m in want}
                entry["value_err"] = check_regression_values(stacked, want, f"{kind} results()")
            out[f"{kind}_{name}"] = entry
    return out


def regression_refusals(dev):
    """Phase 13(c): the engines refuse Pearson, Spearman and CosineSimilarity
    with the JAX package's reasons."""
    from metrics_tpu_torch import CosineSimilarity, MetricCollection, PearsonCorrCoef, SpearmanCorrCoef
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, StreamingEngine
    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

    out = {}
    engines = {
        "streaming": lambda c: StreamingEngine(c, EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep")),
        "multistream": lambda c: MultiStreamEngine(c, MS_STREAMS, EngineConfig(buckets=(256, BUCKET))),
        "paged": lambda c: MultiStreamEngine(c, PAGED_STREAMS, EngineConfig(buckets=PAGED_BUCKETS,
                                                                            kernel_backend="megastep"),
                                             stream_shard=True, resident_streams=RESIDENT),
    }
    for name, cls in (("pearson", PearsonCorrCoef), ("spearman", SpearmanCorrCoef), ("cosine", CosineSimilarity)):
        for kind, build in engines.items():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # Spearman's buffer warning
                coll = MetricCollection({"x": cls(device=dev)})
            try:
                build(coll)
                reason = None
            except MetricsTPUUserError as e:
                reason = str(e)
            want = REG_REFUSALS[("pearson" if name == "pearson" else "list",
                                 "streaming" if kind == "streaming" else "multistream")]
            check(reason is not None and reason.endswith(want), f"{kind} engine: {name} refusal {reason!r}")
            out[f"{name}_{kind}"] = reason
    return out


def pairwise_phase(dev):
    """Phase 13(d): the four pairwise functions on the card against float64
    numpy on a sample of rows: cosine, linear and euclidean at
    (8192, 512) x (8192, 512), manhatten at (1024, 512) x (1024, 512) (its
    (N, M, d) broadcast holds 2 GiB). An f32 dot product over d terms is
    within 2 d 2^-24 Σ|x_k y_k| of the exact one; a euclidean distance within
    the square root of its expansion's bound, or that bound over the
    distance where smaller; a manhatten distance within (2 d + 2) 2^-24 of
    its own size."""
    import metrics_tpu_torch.functional as F

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on: the products would not be f32")
    rng = np.random.RandomState(SEED + 16)
    x = rng.normal(size=(PAIR_ROWS, PAIR_DIM)).astype(np.float32)
    y = rng.normal(size=(PAIR_ROWS, PAIR_DIM)).astype(np.float32)
    xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    rows = np.sort(rng.choice(PAIR_ROWS, PAIR_SAMPLE, replace=False))
    xs, y64 = x[rows].astype(np.float64), y.astype(np.float64)
    dots, absdots = xs @ y64.T, np.abs(xs) @ np.abs(y64).T
    nx, ny = (xs * xs).sum(1)[:, None], (y64 * y64).sum(1)[None, :]
    d = PAIR_DIM
    out = {}

    picked = torch.from_numpy(rows).to(dev)

    def held(name, fn, want, allowed):
        err = np.abs(fn()[picked].double().cpu().numpy() - want)
        check(np.all(err <= allowed), f"pairwise {name}: err {err.max()} over its bound")
        out[name] = {"max_abs_err": float(err.max()), "ms": gpu_ms(fn, runs=5)}

    held("linear", lambda: F.pairwise_linear_similarity(xd, yd), dots, 2 * d * U32 * absdots + 1e-30)
    cos_want = dots / np.sqrt(nx * ny)
    held("cosine", lambda: F.pairwise_cosine_similarity(xd, yd), cos_want,
         2 * (d + 4) * U32 * absdots / np.sqrt(nx * ny) + 1e-30)
    sq = nx + ny - 2 * dots
    euc_want = np.sqrt(np.maximum(sq, 0))
    bsq = 2 * (d + 2) * U32 * (nx + ny + 2 * absdots)
    held("euclidean", lambda: F.pairwise_euclidean_distance(xd, yd), euc_want,
         np.minimum(np.sqrt(bsq), bsq / np.maximum(euc_want, 1e-30)))
    # the reductions over the same matrix: a row's mean of the sampled rows' full rows
    mean = F.pairwise_linear_similarity(xd, yd, reduction="mean")[picked].double().cpu().numpy()
    check(np.all(np.abs(mean - dots.mean(1)) <= (2 * d * U32 * absdots).mean(1) + 1e-6 * np.abs(dots).mean(1)),
          "pairwise linear mean")
    xm, ym = x[:MANHATTEN_ROWS], y[:MANHATTEN_ROWS]
    msample = rows[rows < MANHATTEN_ROWS]
    man_want = np.abs(xm[msample].astype(np.float64)[:, None, :] - ym.astype(np.float64)[None, :, :]).sum(-1)
    got = F.pairwise_manhatten_distance(xd[:MANHATTEN_ROWS], yd[:MANHATTEN_ROWS])
    err = np.abs(got[torch.from_numpy(msample).to(dev)].double().cpu().numpy() - man_want)
    check(np.all(err <= (2 * d + 2) * U32 * man_want), f"pairwise manhatten: err {err.max()}")
    out["manhatten"] = {"max_abs_err": float(err.max()), "sampled_rows": int(len(msample)),
                        "ms": gpu_ms(lambda: F.pairwise_manhatten_distance(xd[:MANHATTEN_ROWS], yd[:MANHATTEN_ROWS]),
                                     runs=5)}
    zero = F.pairwise_euclidean_distance(xd[:64])
    check(bool((torch.diagonal(zero) == 0).all()), "pairwise euclidean: x against itself keeps its diagonal")
    out["sampled_rows"] = PAIR_SAMPLE
    return out


def regression_phase(dev):
    """Phase 13: regression and pairwise on the flagship's 65 536 rows."""
    p, t, pn, tn = regression_rows(dev)
    out = {"eager": regression_eager(dev, p, t, pn, tn)}
    out["served"] = regression_served(dev, p, t, pn, tn)
    out["bucket_1024"] = profile_bucket(dev, p, t, make=make_regression_collection)
    out["refusals"] = regression_refusals(dev)
    out["pairwise"] = pairwise_phase(dev)
    return out


# ------------------------------------------------ phase 14: cross-process sync

SYNC_TIMED = 20  # syncs per host-ms median
SYNC_BATCHES = 4  # update batches over all rows, as phases 4 and 13(a)


def make_sync_collections(device, capacity):
    """Phase 14's two collections: the flagship plus capacity AUROC and AP
    (phase 4's rows), and phase 13's served members plus Pearson (stacked
    None moments) and a ``MinMaxMetric`` of an MSE (min/max states), the
    MSE's squared-error sum on the q8 carrier (phase 13's rows)."""
    from metrics_tpu_torch import AUROC, AveragePrecision, MeanSquaredError, MinMaxMetric, PearsonCorrCoef

    cls = make_collection(device)
    cls.add_metrics({"auroc": AUROC(num_classes=NUM_CLASSES, capacity=capacity, device=device),
                     "ap": AveragePrecision(num_classes=NUM_CLASSES, capacity=capacity, device=device)})
    reg = make_regression_collection(device)
    reg.add_metrics({"pearson": PearsonCorrCoef(device=device),
                     "minmax": MinMaxMetric(MeanSquaredError(device=device))})
    reg["mse"].set_sync_precision("q8_block")
    return cls, reg


def sync_rows(dev, lo, hi):
    """Rows ``lo:hi`` of phase 4's and of phase 13's seeded rows, on ``dev``."""
    preds, target, _, _ = main_rows(dev)
    rp, rt, _, _ = regression_rows(dev)
    return (preds[lo:hi], target[lo:hi]), (rp[lo:hi], rt[lo:hi])


def sync_update(colls, rows, batches):
    for coll, (p, t) in zip(colls, rows):
        step = p.shape[0] // batches
        for lo in range(0, p.shape[0], step):
            coll.update(p[lo:lo + step], t[lo:lo + step])


def coll_state(coll):
    return {k: m._pack_state() for k, m in coll.items(keep_base=True)}


def host_tree(x, fn=lambda t: t.detach().cpu()):
    """A state or value tree with ``fn`` applied to every tensor (default: a
    host copy)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: host_tree(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [host_tree(v, fn) for v in x]
    return x


def numpy_tree(x):
    """``host_tree`` as numpy arrays: what a rank sends through a queue (a
    tensor would travel as a file descriptor the exiting rank closes)."""
    return host_tree(x, lambda t: t.detach().cpu().numpy())


def timed_syncs(coll, state, dev):
    """Median host ms of one ``sync_states`` of ``state`` (device drained)."""
    times = []
    for _ in range(SYNC_TIMED):
        t0 = time.perf_counter()
        coll.sync_states(state)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def bundle_numbers(coll, state, world):
    """One counted ``sync_states``: its collectives against the plan's, and
    the payload bytes of the declared precisions and of all-exact ones."""
    from metrics_tpu_torch.parallel import collectives as col

    leaves = coll.sync_leaf_info()
    col.reset_collective_counts()
    synced = coll.sync_states(state)
    got = col.collective_counts()
    plan = col.fused_sync_plan(leaves, world)
    check(got["all_reduce"] + got["all_gather"] == plan["collectives"],
          f"sync bundle: {got} collectives, the plan names {plan['collectives']}")
    return synced, {"collectives": got, "plan_collectives": plan["collectives"],
                    "payload_bytes": col.sync_payload_bytes(leaves, world),
                    "payload_bytes_exact": col.sync_payload_bytes([(f, l, "exact") for f, l, _ in leaves], world)}


def sync_rank(rank, store, device, queue):
    """One rank of phase 14(b): gloo at world 2 with the tensors on ``device``
    (the first card); updates its half of the rows, syncs, computes; sends
    the host copies back."""
    import torch.distributed as dist

    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
        half = N_ROWS // 2
        colls = make_sync_collections(dev, half)
        sync_update(colls, sync_rows(dev, rank * half, (rank + 1) * half), SYNC_BATCHES // 2)
        out = {"local": [], "synced": [], "values": [], "bundle": [], "sync_ms": []}
        for coll in colls:
            state = coll_state(coll)
            synced, numbers = bundle_numbers(coll, state, 2)
            check(all(v.device == dev for v in tensor_leaves(synced)), "gloo sync left the card")
            out["local"].append(host_tree(state))
            out["synced"].append(host_tree(synced))
            out["values"].append(host_tree(coll.compute()))  # eager: every member syncs itself
            out["bundle"].append(numbers)
            out["sync_ms"].append(timed_syncs(coll, state, dev))
        dist.destroy_process_group()
        queue.put((rank, True, numpy_tree(out)))
    except BaseException:  # noqa: BLE001 - the parent reports it and fails
        import traceback

        queue.put((rank, False, traceback.format_exc()))


def tensor_tree(x):
    """Inverse of :func:`numpy_tree`."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, dict):
        return {k: tensor_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [tensor_tree(v) for v in x]
    return x


def tensor_leaves(tree):
    """Every tensor of a state tree."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return []


def same_tree(got, want, what):
    """Bit-equal trees of host tensors."""
    if isinstance(want, dict):
        check(set(got) == set(want), f"{what}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            same_tree(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, list):
        check(len(got) == len(want), f"{what}: lengths differ")
        for i, (g, x) in enumerate(zip(got, want)):
            same_tree(g, x, f"{what}[{i}]")
    else:
        check(got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want),
              f"{what}: differs ({got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)})")


def sync_phase(dev, gpu_state, gpu_values):
    """Phase 14: (a) NCCL at world 1, (b) gloo at world 2 in two processes on
    the card, held against (a). Returns the phase's numbers."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as tmp

    from metrics_tpu_torch.parallel.collectives import q8_roundtrip, q8_sum_error_bound

    out = {}
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_sync_")
    t0 = time.perf_counter()
    # (a) NCCL, world 1 (gloo when rehearsed on the CPU)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(store_dir, "world1"), 1), rank=0, world_size=1)
    try:
        colls = make_sync_collections(dev, N_ROWS)
        sync_update(colls, sync_rows(dev, 0, N_ROWS), SYNC_BATCHES)
        world1 = {"local": [], "synced": [], "values": [], "bundle": [], "sync_ms": []}
        for coll in colls:
            state = coll_state(coll)
            values = host_tree(coll.compute())  # world 1: no eager sync
            for k, m in coll.items(keep_base=True):  # the eager transport, forced at world 1
                with m.sync_context(distributed_available_fn=lambda: True):
                    check(m._is_synced, f"14(a) {k}: the eager sync did not run")
                    eager = host_tree(m.compute_from(m._pack_state()))
                same_tree(host_tree(m._pack_state()), host_tree(state[k]), f"14(a) {k} restored after unsync")
                check(tree_err(eager, values[k]) == 0, f"14(a) {k}: eager synced value differs")
            synced, numbers = bundle_numbers(coll, state, 1)
            synced_values = host_tree(coll.compute_from(synced))
            world1["local"].append(host_tree(state))
            world1["synced"].append(host_tree(synced))
            world1["values"].append(values)
            world1["bundle"].append(numbers)
            world1["sync_ms"].append(timed_syncs(coll, state, dev))
            for k, v in values.items():
                if k not in ("mse", "rmse"):  # the q8 leaf: checked below
                    check(tree_err(synced_values[k], v) == 0, f"14(a) compute_synced {k} differs from compute")
    finally:
        dist.destroy_process_group()
    cls_local, reg_local = world1["local"]
    cls_synced, reg_synced = world1["synced"]
    for k in ("acc", "f1", "binned_ap", "confmat"):
        same_tree(host_tree({s: cls_local[k][s] for s in gpu_state[k]}), host_tree(gpu_state[k]), f"14(a) {k} vs phase 4")
        check(tree_err(world1["values"][0][k], gpu_values[k]) == 0, f"14(a) {k} value vs phase 4")
    for i, (local, synced) in enumerate(zip(world1["local"], world1["synced"])):
        for k in local:
            for s, v in local[k].items():
                if k == "mse" and s == "sum_squared_error":
                    want = torch.from_numpy(q8_roundtrip(v)).reshape(v.shape)
                    check(torch.equal(synced[k][s], want), "14(a) q8 leaf is not its one-rank round trip")
                elif s == "_children":
                    continue
                elif synced[k][s].shape != v.shape:  # fx=None: stacked (1, ...)
                    check(torch.equal(synced[k][s], v[None]), f"14(a) {k}.{s} not stacked")
                else:
                    check(torch.equal(synced[k][s], v), f"14(a) {k}.{s} changed by a world-1 sync")
    out["world1"] = {"backend": backend, "bundles": world1["bundle"], "sync_host_ms": world1["sync_ms"],
                     "seconds": time.perf_counter() - t0}

    # (b) gloo, world 2: two processes on the card, half the rows each
    t0 = time.perf_counter()
    ctx = tmp.get_context("spawn")
    queue = ctx.Queue()
    store = os.path.join(store_dir, "gloo")
    procs = [ctx.Process(target=sync_rank, args=(r, store, str(dev), queue)) for r in range(2)]
    for proc in procs:
        proc.start()
    try:
        got = {}
        for _ in procs:
            rank, ok, res = queue.get(timeout=300)
            check(ok, f"14(b) rank {rank} failed:\n{res}")
            got[rank] = tensor_tree(res)
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
    check(all(proc.exitcode == 0 for proc in procs), "14(b): a rank did not exit cleanly")
    ranks = [got[0], got[1]]
    for i in range(2):
        same_tree(ranks[1]["synced"][i], ranks[0]["synced"][i], "14(b) ranks' synced states")
    # the flagship's counts and the capacity buffers: bit for bit
    b_cls, b_reg = ranks[0]["synced"]
    for k in cls_local:
        same_tree(b_cls[k], cls_local[k], f"14(b) {k}")
    errs = {}
    for k, member in reg_local.items():
        for s, want in member.items():
            if s == "_children":
                continue
            parts = torch.stack([r["local"][1][k][s] for r in ranks])
            gotv = b_reg[k][s]
            if not want.is_floating_point():
                check(torch.equal(gotv, want), f"14(b) {k}.{s} differs")
            elif k == "minmax":
                fold = parts.min(0).values if s == "min_val" else parts.max(0).values
                check(torch.equal(gotv, fold), f"14(b) {k}.{s} differs from the ranks' fold")
            elif k == "pearson":
                check(gotv.shape == (2,) + tuple(want.shape), f"14(b) pearson {s} not stacked")
            else:
                # four roundings apart: (a) summed four batch sums in a row, (b) two per rank then the ranks
                bound = 2.0**-22 * (parts.abs().sum(0).double() + want.abs().double())
                if k == "mse" and s == "sum_squared_error":
                    bound = bound + torch.from_numpy(q8_sum_error_bound(parts)).double()
                err = (gotv.double() - want.double()).abs()
                check(bool((err <= bound).all()), f"14(b) {k}.{s}: err {float(err.max())} > {float(bound.max())}")
                errs[f"{k}.{s}"] = float(err.max())
    for r in ranks:
        for i, want_vals in enumerate(world1["values"]):
            for k, v in want_vals.items():
                gotv = r["values"][i][k]
                if k == "minmax":  # its extremes follow each rank's own prefixes
                    gotv, v = gotv["raw"], v["raw"]
                e = tree_err(gotv, v)
                tol = 0.0 if i == 0 else 2e-5 * max(1.0, flat_tree_abs(v))
                check(e <= tol, f"14(b) compute() {k}: err {e} > {tol}")
    out["world2"] = {"backend": "gloo", "transport": f"gloo/{dev.type}", "bundles": ranks[0]["bundle"],
                     "sync_host_ms": [r["sync_ms"] for r in ranks], "f32_sum_max_abs_err": errs,
                     "seconds": time.perf_counter() - t0}
    out["nccl_world_gt_1"] = "not run: one card takes one NCCL rank"
    return out


def tree_err(got, want):
    """``max_abs_err`` over value trees (a list of per-class tensors stacks)."""
    if isinstance(want, dict):
        check(set(got) == set(want), f"value keys {sorted(got)} != {sorted(want)}")
        return max(tree_err(got[k], want[k]) for k in want)
    got = torch.stack(list(got)) if isinstance(got, (list, tuple)) else got
    want = torch.stack(list(want)) if isinstance(want, (list, tuple)) else want
    return max_abs_err(got, want)


def flat_tree_abs(x):
    """The largest |value| of a value tree (for a relative tolerance)."""
    if isinstance(x, dict):
        return max(flat_tree_abs(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return max(flat_tree_abs(v) for v in x)
    return float(torch.as_tensor(x).double().abs().max())

# --------------------------------------------------- phase 15: the compiled forward

FWD_BATCH = 1024  # a training loop's per-step call: 64 forwards over the 65 536 rows
FWD_SUFFIX = " (detected by a compiled forward step; raised deferred)"
# each signature's entry kind after the run, as the JAX package's forward leaves
# them (pinned on the CPU against JAX by tests/test_torch_forward.py)
FWD_REGRESSION_KINDS = {"collection": ["eager_only"], **{k: ["compiled"] for k in (
    "mse", "rmse", "mae", "msle", "mape", "smape", "explained_variance", "tweedie")}, "r2": ["eager_only"]}


def fwd_kinds(owner):
    """Each signature's entry of ``owner``'s compiled forward: compiled, eager_only or pending."""
    from metrics_tpu_torch.metric import forward_entry_kinds

    return forward_entry_kinds(owner)


def fwd_entry(owner):
    """``owner``'s one built forward step (a ``CapturedForward``)."""
    from metrics_tpu_torch.metric import compiled_forward_steps

    entries = compiled_forward_steps(owner)
    check(len(entries) == 1, f"expected one built forward step, got {len(entries)}")
    return entries[0]


def same_value_trees(got, want, what):
    """Bit-equal value trees (dicts, lists of per-class tensors, tensors)."""
    if isinstance(want, dict):
        check(set(got) == set(want), f"{what}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            same_value_trees(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        check(len(got) == len(want), f"{what}: length")
        for i, (g, w) in enumerate(zip(got, want)):
            same_value_trees(g, w, f"{what}[{i}]")
    else:
        check(got.shape == want.shape and got.dtype == want.dtype and torch.equal(got, want), f"{what} differs")


def eager_twin(owner):
    """``owner`` with the compiled forward off: every call the eager
    ``compute_from(update_state(init_state(), ...))`` and merge."""
    from metrics_tpu_torch.metric import keep_forward_eager

    return keep_forward_eager(owner)


def forward_run(owner, batches):
    """``owner(p, t)`` per batch: the values, host ms per call (the device
    drained after each), the launches of all calls and of the first, and the
    device memory the second call (the capture) kept."""
    before = counts()
    values, host_ms, mem = [], [], []
    for i, (p, t) in enumerate(batches):
        t0 = time.perf_counter()
        values.append(owner(p, t))
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        mem.append(torch.cuda.memory_allocated())
        if i == 0:
            first = delta(before)
    # (the capture empties PyTorch's cache of free blocks: reserved memory says nothing here)
    return values, host_ms, {"launches": delta(before), "first_call_launches": first,
                             "capture_allocated_bytes": mem[1] - mem[0]}


def forward_profile(owner, p, t):
    """Device launches and µs of one more forward of ``owner`` (profiler)."""
    trace = device_trace(lambda: owner(p, t), runs=10)
    return {"device_launches": sum(c for _, c in trace.values()), "device_us": sum(us for us, _ in trace.values())}


def forward_members_phase(owner, twin, batches, what, state_of, want_state):
    """One owner's forwards against its eager twin's: values bit-equal, final
    states bit-equal to the twin's and to ``want_state``; host ms per call
    (the median over the replays), launches and the capture's memory."""
    vals, host_ms, run = forward_run(owner, batches)
    twin_vals, twin_ms, _ = forward_run(twin, batches)
    for i, (g, w) in enumerate(zip(vals, twin_vals)):
        same_value_trees(g, w, f"15{what} batch {i} vs the eager twin")
    got = state_of(owner)
    same_value_trees(got, state_of(twin), f"15{what} state vs the eager twin")
    if want_state is not None:
        compare_states(got, want_state, f"15{what} vs phase 4")
    return {"host_ms_median": float(np.median(host_ms[2:])), "host_ms_eager_call": host_ms[0],
            "host_ms_capture_call": host_ms[1], "eager_twin_host_ms_median": float(np.median(twin_ms[2:])), **run}


def forward_phase(dev, preds, target, gpu_state, gpu_values):
    """Phase 15: ``Metric.forward`` and ``MetricCollection.forward`` as one
    CUDA graph per input signature (``engine/aot.py``'s ``CapturedForward``),
    against eager twins. Returns the phase's numbers."""
    from metrics_tpu_torch import BinnedAveragePrecision, ConfusionMatrix, Metric, R2Score, TweedieDevianceScore
    from metrics_tpu_torch.engine.aot import FORWARD_CACHE

    out = {}
    batches = [(preds[lo:lo + FWD_BATCH], target[lo:lo + FWD_BATCH]) for lo in range(0, N_ROWS, FWD_BATCH)]
    n = len(batches)
    cache0 = FORWARD_CACHE.stats()

    # (a) the flagship collection, fused into one graph
    state_of = lambda c: {k: {s: getattr(m, s) for s in m._defaults} for k, m in c.items(keep_base=True)}
    coll = make_collection(dev)
    a = forward_members_phase(coll, eager_twin(make_collection(dev)), batches, "(a) flagship", state_of, gpu_state)
    entry = fwd_entry(coll)
    check(fwd_kinds(coll) == ["compiled"] and entry.captures == 1 and entry.replays == n - 1,
          f"15(a): {fwd_kinds(coll)}, {entry.captures} captures, {entry.replays} replays")
    kept = coll.compute()  # the confusion matrix's is its state tensor: (e) forwards again and reads it
    same_value_trees(flat_values(kept), gpu_values, "15(a) compute() vs phase 4")
    per_forward = a.pop("first_call_launches")
    for k in ("histogram", "binned_counts"):
        # the eager call and the warm-up launch for real; each replay credits the captured launches
        check(per_forward[k] > 0 and a["launches"][k] == (n + 1) * per_forward[k],
              f"15(a) {k}: {a['launches'][k]} launches, {per_forward[k]} per forward")
    a.update({"forwards": n, "eager": 1, "captures": entry.captures, "replays": entry.replays,
              "eager_only": 0, "capture_seconds": entry.capture_seconds,
              "per_forward_launches": {k: v for k, v in per_forward.items() if v}})
    a["profile_captured"] = forward_profile(coll, *batches[0])
    a["profile_eager"] = forward_profile(eager_twin(make_collection(dev)), *batches[0])
    out["a_flagship"] = a

    # (b) BinnedAveragePrecision alone: the single metric's step
    make_ap = lambda: BinnedAveragePrecision(num_classes=NUM_CLASSES, thresholds=THRESHOLDS, device=dev)
    ap = make_ap()
    b = forward_members_phase(ap, eager_twin(make_ap()), batches, "(b) binned AP",
                                    lambda m: {"binned_ap": {s: getattr(m, s) for s in m._defaults}},
                                    {"binned_ap": gpu_state["binned_ap"]})
    entry = fwd_entry(ap)
    check(fwd_kinds(ap) == ["compiled"] and entry.captures == 1 and entry.replays == n - 1,
          f"15(b): {fwd_kinds(ap)}, {entry.captures} captures, {entry.replays} replays")
    b.pop("first_call_launches")
    check(b["launches"]["binned_counts"] == n + 1, f"15(b) K3: {b['launches']['binned_counts']} launches")
    b.update({"forwards": n, "captures": entry.captures, "replays": entry.replays, "eager_only": 0,
              "capture_seconds": entry.capture_seconds})
    b["profile_captured"] = forward_profile(ap, *batches[0])
    b["profile_eager"] = forward_profile(eager_twin(make_ap()), *batches[0])
    out["b_binned_ap"] = b

    # (c) phase 13's regression members and R2Score as a collection: the fused
    # step fails (R2Score's compute reads n_obs on the host), the members take their own
    def make_reg():
        c = make_regression_collection(dev)
        c["r2"] = R2Score(device=dev)
        return c

    rp, rt, _, _ = regression_rows(dev)
    reg_batches = [(rp[lo:lo + FWD_BATCH], rt[lo:lo + FWD_BATCH]) for lo in range(0, N_ROWS, FWD_BATCH)]
    reg = make_reg()
    eager_only0 = FORWARD_CACHE.eager_only
    c = forward_members_phase(reg, eager_twin(make_reg()), reg_batches, "(c) regression", state_of, None)
    c.pop("first_call_launches")
    kinds = {"collection": fwd_kinds(reg), **{k: fwd_kinds(m) for k, m in reg.items(keep_base=True)}}
    check(kinds == FWD_REGRESSION_KINDS, f"15(c) entry kinds {kinds}")
    members = [fwd_entry(m) for k, m in reg.items(keep_base=True) if k != "r2"]
    check(all(e.captures == 1 and e.replays == n - 1 for e in members), "15(c): a member's captures or replays")
    c.update({"forwards": n, "kinds": kinds, "captures": sum(e.captures for e in members),
              "replays": sum(e.replays for e in members), "eager_only": FORWARD_CACHE.eager_only - eager_only0,
              "capture_seconds": sum(e.capture_seconds for e in members)})
    check(c["eager_only"] == 2, f"15(c): {c['eager_only']} eager-only signatures, not 2")
    out["c_regression"] = c

    # (d) deferred checks on the card: forward returns, compute() raises JAX's message until reset()
    d = {}
    for name, make, good, bad, msg in (
            ("confmat", lambda: ConfusionMatrix(num_classes=NUM_CLASSES, device=dev), batches[0],
             (batches[0][0], torch.full_like(batches[0][1], NUM_CLASSES)),
             "The highest label in `target` should be smaller than the size of the `C` dimension of `preds`."),
            ("tweedie", lambda: TweedieDevianceScore(power=SERVED_POWER, device=dev), reg_batches[0],
             (reg_batches[0][0], -reg_batches[0][1]),
             "Tweedie deviance inputs violate the positivity domain for the chosen `power`.")):
        m = make()
        for _ in range(3):
            m(*good)
        check(fwd_kinds(m) == ["compiled"], f"15(d) {name}: {fwd_kinds(m)}")
        m(*bad)  # the captured step: no raise here
        raised = []
        for _ in range(3):
            try:
                m.compute()
                raised.append(None)
            except ValueError as e:
                raised.append(str(e))
        check(raised == [msg + FWD_SUFFIX] * 3, f"15(d) {name}: {raised}")
        m.reset()
        m(*good)
        m.compute()
        d[name] = raised[0]
    out["d_deferred"] = d

    # (e) steps that cannot be captured. A host read is found in the warm-up,
    # before any capture; one made only while a capture runs gets past the
    # warm-up and breaks the capture, which must leave the state, the card and
    # its random generator (shared with a graph of the user's) as they were
    def host_read_metric(only_while_capturing):
        class HostRead(Metric):
            def __init__(self, **kw):
                super().__init__(**kw)
                self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

            def update(self, x, y):
                read = (x - y.unsqueeze(1)).sum()
                if not only_while_capturing or torch.cuda.is_current_stream_capturing():
                    read.item()
                self.total = self.total + read

            def compute(self):
                return self.total

        return HostRead(device=dev), eager_twin(HostRead(device=dev))

    drawn = torch.empty(4096, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        drawn.uniform_()
    torch.cuda.current_stream(dev).wait_stream(side)
    users = torch.cuda.CUDAGraph()
    with torch.cuda.graph(users):
        drawn.uniform_()
    e = {}
    for name, only_while_capturing in (("refused_in_warm_up", False), ("capture_failed", True)):
        hr, hr_twin = host_read_metric(only_while_capturing)
        eager_only0, captures0 = FORWARD_CACHE.eager_only, FORWARD_CACHE.misses
        refusals0 = FORWARD_CACHE.host_sync_refusals
        for p, t in batches[:4]:
            hr(p, t)
            hr_twin(p, t)
        refused = FORWARD_CACHE.host_sync_refusals - refusals0
        check(fwd_kinds(hr) == ["eager_only"] and FORWARD_CACHE.eager_only == eager_only0 + 1
              and FORWARD_CACHE.misses == captures0 and refused == int(not only_while_capturing),
              f"15(e) {name}: {fwd_kinds(hr)}, {refused} warm-up refusals")
        check(torch.equal(hr.total, hr_twin.total), f"15(e) {name}: the failed try moved the state")
        e[name] = fwd_kinds(hr)
    torch.cuda.manual_seed(7)
    users.replay()
    first = drawn.clone()
    eager_draw = torch.rand(4096, device=dev)
    torch.cuda.manual_seed(7)
    users.replay()
    check(torch.equal(drawn, first), "15(e): manual_seed no longer reaches the user's random graph")
    check(not torch.equal(eager_draw, first), "15(e): eager draws repeat the user's graph's")
    replays = fwd_entry(coll).replays
    got = coll(*batches[5])
    want = eager_twin(make_collection(dev))(*batches[5])
    same_value_trees(got, want, "15(e) the flagship's graph after the failed capture")
    check(fwd_entry(coll).replays == replays + 1, "15(e): the flagship's forward did not replay")
    same_value_trees(flat_values(kept), gpu_values, "15(e) a compute() result kept across a forward")
    ap2, ap2_twin = make_ap(), eager_twin(make_ap())
    for p, t in batches[:3]:
        same_value_trees(ap2(p, t), ap2_twin(p, t), "15(e) a capture after the failed one")
    check(fwd_kinds(ap2) == ["compiled"], f"15(e): a later capture: {fwd_kinds(ap2)}")
    out["e_failed_capture"] = {**e, "state_equal": True, "user_random_graph_follows_seed": True,
                               "kept_compute_unchanged": True, "later_capture": fwd_kinds(ap2)}

    stats = FORWARD_CACHE.stats()
    out["forward_cache"] = {k: stats[k] - cache0[k] if isinstance(stats[k], (int, float)) else stats[k]
                            for k in stats}
    return out


# --------------------------------------------- phase 16: snapshots and the restore matrix

SNAP_EVERY = 16  # 16(a)'s cadence, in batches
SNAP_KILL = 80  # 16(a): the engine dies after this batch
SNAP_STAGED = 8  # 16(b): spilled streams staged as int8 codes when the snapshot is taken
SNAP_DIR = Path(__file__).resolve().parent / "build" / "phase16"  # gitignored; removed after the phase


def snap_dir(name):
    path = SNAP_DIR / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return str(path)


def state_ptrs(eng):
    return {k: v.data_ptr() for k, v in eng._state.items()}


def snapshot_streaming(dev, preds, target, gpu_state, gpu_values):
    """16(a), (c) and the megastep half of (d): phase 7's engine and traffic
    with ``snapshot_every=16``, killed after batch 80, restored into a fresh
    engine sharing the AotCache and replayed; ``corrupt_snapshot`` on LATEST
    and the fallback restore; host ms and bytes of one snapshot and one
    restore; host ms per captured step with the cadence against without."""
    from metrics_tpu_torch.engine import AotCache, EngineConfig, StreamingEngine
    from metrics_tpu_torch.engine.faults import corrupt_snapshot
    from metrics_tpu_torch.engine.snapshot import latest_snapshot

    aot = AotCache()
    batches = ragged_batches(SEED + 2, 16, BUCKET)

    def engine(snapdir=None, every=0):
        return StreamingEngine(make_collection(dev), EngineConfig(
            buckets=(256, BUCKET), kernel_backend="megastep", snapshot_every=every, snapshot_dir=snapdir),
            aot_cache=aot)

    def submit(e, b):
        e.submit(preds[b[0]:b[1]], target[b[0]:b[1]])

    d = snap_dir("a")
    killed = engine(d, SNAP_EVERY)
    run_engine(killed, True, batches[:SNAP_KILL], submit)
    check(killed.stats.snapshots == SNAP_KILL // SNAP_EVERY and killed.stats.snapshot_failures == 0,
          f"16(a): {killed.stats.snapshots} periodic snapshots, {killed.stats.snapshot_failures} failed")
    misses = aot.misses
    del killed  # the kill: the engine and its buffers are gone
    resumed = engine(d)
    ptrs = state_ptrs(resumed)
    t0 = time.perf_counter()
    meta = resumed.restore()
    restore_ms = (time.perf_counter() - t0) * 1e3
    check(meta["batches_done"] == SNAP_KILL and meta["generations_skipped"] == 0, f"16(a): restored {meta}")
    check(state_ptrs(resumed) == ptrs, "16(a): restore rebound a state buffer")
    run_engine(resumed, True, batches[SNAP_KILL:], submit)
    check(aot.misses == misses and resumed.stats.warmup_steps == 0,
          f"16(a): the resumed engine captured ({aot.misses - misses} misses)")
    # the flagship's states are counts: bit-exact however the dispatcher coalesced
    compare_states(resumed.state(), gpu_state, "16(a) resumed vs uninterrupted (one-shot)")
    values = flat_values(resumed.result())
    for k in gpu_values:
        check(max_abs_err(values[k], gpu_values[k]) <= 1e-6, f"16(a): value {k}")
    # (c) the newest generation rots: restore falls back one generation, replay is exact
    corrupt_snapshot(latest_snapshot(d), np.random.RandomState(SEED + 16))
    fallback = engine(d)
    meta_c = fallback.restore()
    check(meta_c["generations_skipped"] == 1 and meta_c["batches_done"] == SNAP_KILL - SNAP_EVERY
          and fallback.stats.snapshot_fallbacks == 1, f"16(c): {meta_c}")
    run_engine(fallback, True, batches[meta_c["batches_done"]:], submit)
    check(fallback.stats.warmup_steps == 0, "16(c): the fallback engine captured")
    compare_states(fallback.state(), gpu_state, "16(c) fallback vs uninterrupted")
    # (d) one snapshot and one restore of the whole flagship arena, into the live captured engine
    t0 = time.perf_counter()
    path = resumed.snapshot()
    snapshot_ms = (time.perf_counter() - t0) * 1e3
    live_ptrs, misses = state_ptrs(resumed), aot.misses
    t0 = time.perf_counter()
    resumed.restore(path)
    live_restore_ms = (time.perf_counter() - t0) * 1e3
    check(state_ptrs(resumed) == live_ptrs and aot.misses == misses, "16(a): a live restore rebound or captured")
    compare_states(resumed.state(), gpu_state, "16(a) live restore")
    # the cadence's cost: host ms per captured step, warm (no capture), in turns
    cadence = {"without": [], "with": []}
    for name in ("without", "with", "with", "without"):
        every = SNAP_EVERY if name == "with" else 0
        eng = engine(snap_dir(f"d_{name}_{len(cadence[name])}") if every else None, every)
        seconds = run_engine(eng, True, batches, submit)
        check(eng.stats.warmup_steps == 0 and eng.stats.snapshot_failures == 0, f"16(d): {name} captured or failed")
        compare_states(eng.state(), gpu_state, f"16(d) {name} cadence")
        cadence[name].append({"ms_per_step": seconds / eng.steps * 1e3, "steps": eng.steps,
                              "snapshots": eng.stats.snapshots})
    return {"batches": len(batches), "killed_at": SNAP_KILL, "every": SNAP_EVERY,
            "resumed_steps": resumed.steps - meta["step"], "restore_ms": restore_ms, "live_restore_ms": live_restore_ms,
            "snapshot_ms": snapshot_ms, "snapshot_bytes": os.path.getsize(path),
            "fallback_cursor": meta_c["batches_done"], "captures": aot.misses, "cadence": cadence}


def stacked_host(eng):
    """Every stream's logical state as host numpy, ``(S, ...)`` per leaf."""
    return {k: {s: v.detach().cpu().numpy() for s, v in member.items()} for k, member in eng.state().items()}


def snapshot_paged(dev, preds, target):
    """16(b) and the paged half of (d): phase 9's q8-staged tenancy (10 000
    streams, 128 slots, ``compress_payloads=True``, ``coalesce=1``)
    snapshotted halfway with rows spilled and SNAP_STAGED spilled streams
    staged as int8 codes, then served to the end (the uninterrupted run); the
    snapshot restored into the same residency, into 256 slots and merged
    into an unsharded engine, each replaying the second half. Every integer
    state equals the uninterrupted run's bit for bit; the q8-policy float
    states (binned AP's counts) within the codec's bound: each encode moves an
    element by at most its block's absmax / 254, a stream's absmax is at most
    its row count n_s, and after the snapshot the two runs encode a stream's
    row at most 2 b_s + 4 times between them (b_s: its batches in the second
    half; one eviction per fault-in, plus the snapshot's and the re-homing's
    encodes)."""
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine

    batches = ragged_batches(SEED + 4, 8, 64)
    sids = zipf_stream_ids(PAGED_STREAMS, len(batches), ALPHA, SEED + 4)
    traffic = list(zip(sids, batches))
    half = len(traffic) // 2

    def engine(resident, snapdir=None):
        cfg = EngineConfig(buckets=PAGED_BUCKETS, kernel_backend="megastep", compress_payloads=True, coalesce=1,
                           snapshot_dir=snapdir)
        coll = make_collection(dev, ap_precision="q8_block")
        if resident is None:
            return MultiStreamEngine(coll, PAGED_STREAMS, cfg)
        return MultiStreamEngine(coll, PAGED_STREAMS, cfg, stream_shard=True, resident_streams=resident)

    def submit(e, b):
        e.submit(int(b[0]), preds[b[1][0]:b[1][1]], target[b[1][0]:b[1][1]])

    src = engine(RESIDENT, snap_dir("b"))
    src.start()
    for b in traffic[:half]:
        submit(src, b)
    src.flush()
    stage = sorted(src.pager.spilled_streams(0))[:SNAP_STAGED]
    want_staged = {sid: src.stream_state(sid) for sid in stage}  # read through the host decode, nothing seated
    with src._device_section():
        src._page_round({0: stage})  # seat them as a round would: int8 codes staged for K7, q8 columns zero
    flags = int(src._q8_stage[0]["flags"].sum())
    check(flags == SNAP_STAGED, f"16(b): {flags} staged slots, want {SNAP_STAGED}")
    t0 = time.perf_counter()
    path = src.snapshot()
    snapshot_ms = (time.perf_counter() - t0) * 1e3
    check(int(src._q8_stage[0]["flags"].sum()) == 0, "16(b): the snapshot left staged slots unseated")
    staged_rows = src.stats.q8_staged_rows
    spilled_at_snapshot = src.pager.spilled_count()
    for b in traffic[half:]:
        submit(src, b)
    src.stop()
    want = stacked_host(src)
    want_values = src.results()
    rows = {sid: len(r) for sid, r in stream_rows(sids, batches).items()}
    tail = {}
    for sid in sids[half:]:
        tail[int(sid)] = tail.get(int(sid), 0) + 1
    bound = np.zeros(PAGED_STREAMS)
    for sid, n in rows.items():
        bound[sid] = (2 * tail.get(sid, 0) + 4) * n / 254.0
    out = {"streams": PAGED_STREAMS, "snapshot_at": half, "snapshot_ms": snapshot_ms,
           "snapshot_bytes": os.path.getsize(path), "spilled_at_snapshot": spilled_at_snapshot,
           "staged_at_snapshot": flags, "q8_staged_rows": staged_rows, "targets": {}}
    for name, resident in (("same_residency", RESIDENT), ("resident_256", 256), ("merged_unsharded", None)):
        eng = engine(resident)
        t0 = time.perf_counter()
        meta = eng.restore(path)
        restore_ms = (time.perf_counter() - t0) * 1e3
        check(meta["batches_done"] == half, f"16(b) {name}: cursor {meta['batches_done']}")
        for sid in stage:  # the staged rows survived the snapshot, bit for bit
            got = eng.stream_state(sid)
            for k, member in want_staged[sid].items():
                for s, w in member.items():
                    check(torch.equal(got[k][s], w), f"16(b) {name}: staged stream {sid} {k}.{s} lost")
        seconds = run_engine(eng, True, traffic[half:], submit)
        steps = eng.steps - meta["step"]  # the restored cursor counts the first half's steps
        got = stacked_host(eng)
        worst = 0.0
        for k, member in want.items():
            for s, w in member.items():
                g = got[k][s]
                check(g.dtype == w.dtype and g.shape == w.shape, f"16(b) {name}: {k}.{s} dtype/shape")
                if w.dtype.kind != "f":
                    check(np.array_equal(g, w), f"16(b) {name}: integer state {k}.{s} differs")
                    continue
                err = np.abs(g.astype(np.float64) - w).reshape(PAGED_STREAMS, -1).max(axis=1)
                worst = max(worst, float(err.max()))
                over = np.nonzero(err > bound + 1e-3)[0]
                check(over.size == 0, f"16(b) {name}: {k}.{s} of {over.size} streams past the q8 bound")
        values = eng.results()
        for sid in range(0, PAGED_STREAMS, 7):  # the count-derived values, exactly
            for k in ("acc", "f1", "confmat"):
                check(torch.equal(values[sid][k], want_values[sid][k]), f"16(b) {name}: stream {sid} {k}")
        out["targets"][name] = {"restore_ms": restore_ms, "replay_s": seconds, "steps": steps,
                                "ms_per_step": seconds / steps * 1e3, "q8_max_abs_err": worst,
                                "page_ins": eng.stats.page_ins}
    return out


def snapshot_phase(dev, preds, target, gpu_state, gpu_values):
    """Phase 16: kill/resume through the captured engines (module docstring)."""
    try:
        return {"streaming": snapshot_streaming(dev, preds, target, gpu_state, gpu_values),
                "paged": snapshot_paged(dev, preds, target)}
    finally:
        shutil.rmtree(SNAP_DIR, ignore_errors=True)


# ------------------------------------------------------- phase 17: the chaos sweep

CHAOS_DIR = Path(__file__).resolve().parent / "build" / "phase17"  # gitignored; removed after the phase
CHAOS_EVERY = 16  # 17(a)'s snapshot cadence, in batches
CHAOS_KERNEL_AT = 8  # 17(a): the kernel site's occurrence that fires (JAX's plan: 0, before any K5 could launch)
HANG_TIMEOUT_S = 0.1  # 17(c): the watchdog
HANG_S = 0.15  # 17(c): the hang enqueued ahead of the step, 1.5 x the watchdog


def chaos_dir(name):
    path = CHAOS_DIR / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return str(path)


def watch_steps(eng):
    """Record, at each step attempt of ``eng``, the kernel launch counts,
    the demotions so far and the q8 rows staged so far (host counters:
    nothing syncs)."""
    seen = []
    do_step = eng._do_step

    def watched(*a, **kw):
        seen.append(dict(counts(), demotions=eng.stats.kernel_demotions, staged=eng.stats.q8_staged_rows))
        return do_step(*a, **kw)

    eng._do_step = watched
    return seen


def recovery(st):
    return {k: getattr(st, k) for k in ("retries", "rollbacks", "kernel_demotions", "coalesce_degraded",
                                        "coalesce_shrinks", "watchdog_timeouts", "quarantined_batches",
                                        "quarantined_rows", "snapshots", "snapshot_failures", "snapshot_fallbacks")}


def demotion_split(seen, final):
    """Launches of each kernel before the demotion (the counts at the first
    attempt after it) and after it."""
    at = next(i for i, r in enumerate(seen) if r["demotions"])
    before = {k: seen[at][k] for k in final}
    return at, before, {k: final[k] - before[k] for k in final}


def chaos_traffic(dev, preds, target):
    """Phase 7's traffic with 17(a)'s 2-row NaN batch at cursor 2."""
    traffic = [(preds[a:b], target[a:b]) for a, b in ragged_batches(SEED + 2, 16, BUCKET)]
    poison = torch.full((2, NUM_CLASSES), 0.1, device=dev)
    poison[0, 3] = float("nan")
    traffic.insert(2, (poison, torch.tensor([1, 0], device=dev)))
    return traffic


def chaos_plan(n_batches):
    """17(a)'s plan for ``n_batches`` at the CHAOS_EVERY cadence: JAX's chaos
    plan (``chaos_smoke.py:127-225``) with ``kernel`` at CHAOS_KERNEL_AT and
    ``snapshot_corrupt`` on the last good save (the first periodic save fails)."""
    from metrics_tpu_torch.engine import FaultInjector, FaultSpec

    good_saves = n_batches // CHAOS_EVERY - 1
    return FaultInjector(seed=7, plan={
        "coalesce": FaultSpec(rate=1.0), "ingest": FaultSpec(schedule=(1,)), "compile": FaultSpec(schedule=(1,)),
        "step": FaultSpec(schedule=(3,)), "kernel": FaultSpec(schedule=(CHAOS_KERNEL_AT,)),
        "watchdog": FaultSpec(schedule=(6,)), "snapshot_write": FaultSpec(schedule=(0,)),
        "snapshot_corrupt": FaultSpec(schedule=(good_saves - 1,)),
    })


def paging_plan(kernel_at):
    """17(b)'s plan: the pager's and the codec's sites, and ``kernel`` at the
    paged engine's step ``kernel_at``."""
    from metrics_tpu_torch.engine import FaultInjector, FaultSpec

    return FaultInjector(seed=19, plan={
        "page_out": FaultSpec(schedule=(0,)), "page_in": FaultSpec(schedule=(1,)),
        "quant_encode": FaultSpec(schedule=(0,)), "quant_decode": FaultSpec(schedule=(0,)),
        "kernel": FaultSpec(schedule=(kernel_at,))})


def chaos_megastep(dev, preds, target, gpu_state):
    """17(a): phase 7's engine and traffic, plus a 2-row NaN batch at cursor
    2, under JAX's chaos plan (``chaos_smoke.py:127-225``), then killed and
    restored past the corrupt LATEST with a transient ``snapshot_read``."""
    from metrics_tpu_torch.engine import EngineConfig, FaultInjector, FaultSpec, ScreenPolicy, StreamingEngine

    traffic = chaos_traffic(dev, preds, target)
    inj = chaos_plan(len(traffic))
    d = chaos_dir("a")
    screen = ScreenPolicy(non_finite="quarantine")
    eng = StreamingEngine(make_collection(dev), EngineConfig(
        buckets=(256, BUCKET), kernel_backend="megastep", coalesce=8, screen=screen, snapshot_every=CHAOS_EVERY,
        snapshot_dir=d, snapshot_keep=4, fault_injector=inj))
    ptrs = state_ptrs(eng)
    seen = watch_steps(eng)
    before = counts()
    seconds = run_engine(eng, True, traffic, lambda e, b: e.submit(*b))
    launches = delta(before)
    st = eng.stats
    check(state_ptrs(eng) == ptrs, "17(a): a state buffer moved")
    compare_states(eng.state(), gpu_state, "17(a) chaos vs phase 4 (the poisoned rows excluded)")
    at, pre, post = demotion_split([{**r, **{k: r[k] - before[k] for k in before}} for r in seen], launches)
    check(st.kernel_demotions == 1 and eng._kernel_tag() == "auto", f"17(a): {st.kernel_demotions} demotions")
    check(pre["megastep_fold"] > 0 and post["megastep_fold"] == 0 and pre["fold_rows"] == 0
          and post["fold_rows"] > 0, f"17(a): K5 {pre['megastep_fold']}/{post['megastep_fold']} and K1 "
          f"{pre['fold_rows']}/{post['fold_rows']} launches before/after the demotion")
    check(st.rollbacks >= 3 and st.retries >= 3 and st.watchdog_timeouts == 1 and st.coalesce_degraded >= 3
          and st.snapshot_failures == 1, f"17(a): recovery counters {recovery(st)}")
    ledger = [(r.cursor, r.rows, r.stream_id) for r in eng.quarantine()]
    check(ledger == [(2, 2, None)] and "non-finite" in eng.quarantine()[0].reason, f"17(a): ledger {ledger}")
    check(st.quarantined_batches == 1 and st.quarantined_rows == 2, "17(a): quarantine counts")
    out = {"batches": len(traffic), "steps": eng.steps, "seconds": seconds, "demoted_at_attempt": at,
           "recovery": recovery(st), "faults": st.faults_by_site(), "injector": inj.summary(),
           "launches_before_demotion": pre, "launches_after_demotion": post, "captures": eng.aot_cache.misses}
    del eng  # the kill
    read = FaultInjector(seed=11, plan={"snapshot_read": FaultSpec(schedule=(0,))})
    resumed = StreamingEngine(make_collection(dev), EngineConfig(
        buckets=(256, BUCKET), kernel_backend="megastep", coalesce=1, screen=screen, snapshot_dir=d,
        fault_injector=read))
    meta = resumed.restore()
    cursor = meta["batches_done"]
    want_cursor = (len(traffic) // CHAOS_EVERY - 1) * CHAOS_EVERY  # the generation before the rotten LATEST
    check(meta["generations_skipped"] == 1 and cursor == want_cursor and resumed.stats.retries == 1
          and resumed.stats.snapshot_fallbacks == 1, f"17(a) restore: {meta}, {recovery(resumed.stats)}")
    run_engine(resumed, True, traffic[cursor:], lambda e, b: e.submit(*b))
    compare_states(resumed.state(), gpu_state, "17(a) resumed past the corrupt LATEST vs phase 4")
    out["resumed"] = {"cursor": cursor, "replayed_batches": len(traffic) - cursor,
                      "recovery": recovery(resumed.stats)}
    return out


def chaos_paged(dev, preds, target):
    """17(b): phase 9's q8 tenancy (``coalesce=1``) under the paging and
    codec sites and a ``kernel`` fault at a mid-stream step that decodes
    staged rows: every stream bit-equal to its fault-free twin."""
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine

    batches = ragged_batches(SEED + 4, 8, 64)
    sids = zipf_stream_ids(PAGED_STREAMS, len(batches), ALPHA, SEED + 4)
    traffic = list(zip(sids, batches))

    def engine(inj=None):
        return MultiStreamEngine(make_collection(dev, ap_precision="q8_block"), PAGED_STREAMS, EngineConfig(
            buckets=PAGED_BUCKETS, kernel_backend="megastep", compress_payloads=True, coalesce=1,
            fault_injector=inj), stream_shard=True, resident_streams=RESIDENT)

    def submit(e, b):
        e.submit(int(b[0]), preds[b[1][0]:b[1][1]], target[b[1][0]:b[1][1]])

    twin = engine()
    twin_seen = watch_steps(twin)
    twin_s = run_engine(twin, True, traffic, submit)
    # the first step past the middle whose page round staged rows (attempt i sees round i's)
    at = next(i for i in range(len(twin_seen) // 2, len(twin_seen))
              if twin_seen[i]["staged"] > twin_seen[i - 1]["staged"])
    inj = paging_plan(at)
    eng = engine(inj)
    ptrs = state_ptrs(eng)
    seen = watch_steps(eng)
    before = counts()
    seconds = run_engine(eng, True, traffic, submit)
    launches = delta(before)
    st = eng.stats
    check(state_ptrs(eng) == ptrs, "17(b): a state buffer moved")
    check(inj.fired == {"page_out": 1, "page_in": 1, "quant_encode": 1, "quant_decode": 1, "kernel": 1},
          f"17(b): fired {inj.fired}")
    check(st.kernel_demotions == 1 and st.retries == 4 and st.rollbacks == 1, f"17(b): {recovery(st)}")
    demoted, pre, post = demotion_split([{**r, **{k: r[k] - before[k] for k in before}} for r in seen], launches)
    # the failed attempt (the step's first) and its demoted retry saw the staged rows
    check(demoted == at + 1 and seen[at]["staged"] > seen[at - 1]["staged"],
          f"17(b): demoted at attempt {demoted} for the kernel fault at {at}, or no rows were staged there")
    check(pre["megastep_segment"] > 0 and pre["megastep_segment_q8"] > 0 and pre["segment_reduce"] == 0
          and post["megastep_segment"] == 0 and post["megastep_segment_q8"] == 0 and post["segment_reduce"] > 0,
          f"17(b): K6/K7/K4 launches before {pre} and after {post} the demotion")
    want, got = stacked_host(twin), stacked_host(eng)  # every stream, reassembled once per engine
    for k, member in want.items():
        for name, w in member.items():
            check(got[k][name].dtype == w.dtype and np.array_equal(got[k][name], w),
                  f"17(b) chaos vs fault-free twin: {k}.{name}")
    return {"batches": len(traffic), "steps": eng.steps, "seconds": seconds, "twin_seconds": twin_s,
            "kernel_at": at, "recovery": recovery(st), "injector": inj.summary(),
            "q8_staged_rows": st.q8_staged_rows, "twin_q8_staged_rows": twin.stats.q8_staged_rows,
            "page_ins": st.page_ins, "page_outs": st.page_outs,
            "launches_before_demotion": pre, "launches_after_demotion": post}


def chaos_hang(dev, preds, target, aot):
    """17(c): a real hang. A warm engine with the watchdog at HANG_TIMEOUT_S
    serves a prefix of phase 7's traffic and drains; a device sleep of
    HANG_S is enqueued on its own stream; one more batch: one expiry, one
    rollback, one retry, the state bit-equal to the fault-free twin's."""
    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine

    batches = ragged_batches(SEED + 2, 16, BUCKET)[:24]
    # cycles of the device sleep per ms, on this card now
    cycles = 10_000_000
    per_ms = cycles / gpu_ms(lambda: torch.cuda._sleep(cycles), runs=3)

    def engine(timeout):
        return StreamingEngine(make_collection(dev), EngineConfig(
            buckets=(256, BUCKET), kernel_backend="megastep", step_timeout_s=timeout), aot_cache=aot)

    def submit(e, b):
        e.submit(preds[b[0]:b[1]], target[b[0]:b[1]])

    twin = engine(0.0)
    run_engine(twin, True, batches, submit)
    eng = engine(HANG_TIMEOUT_S)
    eng.start()
    for b in batches[:-1]:
        submit(eng, b)
    eng.flush()
    check(eng.stats.watchdog_timeouts == 0, "17(c): the watchdog expired before the hang")
    ptrs = state_ptrs(eng)
    with torch.cuda.stream(eng._stream):
        torch.cuda._sleep(int(HANG_S * 1e3 * per_ms))
    t0 = time.perf_counter()
    submit(eng, batches[-1])
    eng.flush()
    wall = time.perf_counter() - t0
    eng.stop()
    st = eng.stats
    check(st.watchdog_timeouts == 1 and st.rollbacks == 1 and st.retries == 1,
          f"17(c): {st.watchdog_timeouts} expiries, {st.rollbacks} rollbacks, {st.retries} retries")
    check(state_ptrs(eng) == ptrs, "17(c): a state buffer moved")
    check(eng.stats.warmup_steps == 0, "17(c): the warm engine captured")
    compare_states(eng.state(), twin.state(), "17(c) hang vs fault-free twin")
    return {"timeout_s": HANG_TIMEOUT_S, "hang_s": HANG_S, "sleep_cycles_per_ms": per_ms,
            "last_batch_wall_s": wall, "recovery": recovery(st)}


def chaos_dead(dev, preds, target, gpu_state, aot):
    """17(d): a fatal ``dispatcher_kill`` on the first group; ``submit(timeout=0.5)``
    raises the sticky error; ``reset()``, then phase 7's traffic gives phase 4's states."""
    from metrics_tpu_torch.engine import (
        BackpressureTimeout,
        EngineConfig,
        EngineDispatchError,
        FaultInjector,
        FaultSpec,
        StreamingEngine,
    )

    batches = ragged_batches(SEED + 2, 16, BUCKET)
    inj = FaultInjector(seed=17, plan={"dispatcher_kill": FaultSpec(schedule=(0,), transient=False, fatal=True)})
    eng = StreamingEngine(make_collection(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep",
                                                             max_queue=2, fault_injector=inj), aot_cache=aot)
    eng.start()
    eng.submit(preds[:100], target[:100])
    t0 = time.perf_counter()
    sticky = None
    while sticky is None and time.perf_counter() - t0 < 10.0:
        try:
            eng.submit(preds[:100], target[:100], timeout=0.5)
        except EngineDispatchError as e:
            sticky = e
        except BackpressureTimeout:
            continue
    raised_s = time.perf_counter() - t0
    check(sticky is not None and "dispatcher_kill" in str(sticky) and raised_s < 5.0,
          f"17(d): submit(timeout=0.5) gave {sticky!r} after {raised_s:.2f} s")
    eng.reset()
    run_engine(eng, True, batches, lambda e, b: e.submit(preds[b[0]:b[1]], target[b[0]:b[1]]))
    compare_states(eng.state(), gpu_state, "17(d) after reset vs phase 4")
    return {"raised_after_s": raised_s, "error": type(sticky.__cause__).__name__, "steps_after_reset": eng.steps}


def chaos_cost(dev, preds, target, gpu_state, aot):
    """17(e): host ms a captured (warm) step for phase 7's traffic without
    the fault layer, transactional (an empty-plan injector), drained (a plan
    naming the watchdog site at an occurrence never reached: every step is
    synchronized, no deadline) and with the watchdog armed
    (``step_timeout_s=1.0``: every step's event polled), in turns; and the
    device µs of one shadow copy of the flagship arena and of the paged
    tenancy's."""
    from metrics_tpu_torch.engine import EngineConfig, FaultInjector, FaultSpec, MultiStreamEngine, StreamingEngine

    batches = ragged_batches(SEED + 2, 16, BUCKET)
    configs = {"plain": {}, "transactional": {"fault_injector": FaultInjector(0, {})},
               "drained": {"fault_injector": FaultInjector(0, {"watchdog": FaultSpec(schedule=(1 << 30,))})},
               "watchdog": {"step_timeout_s": 1.0}}
    runs = {k: [] for k in configs}
    warm = StreamingEngine(make_collection(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep"),
                           aot_cache=aot)
    run_engine(warm, True, batches, lambda e, b: e.submit(preds[b[0]:b[1]], target[b[0]:b[1]]))  # the captures
    for name in ("plain", "transactional", "drained", "watchdog", "watchdog", "drained", "transactional", "plain"):
        eng = StreamingEngine(make_collection(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep",
                                                                 **configs[name]), aot_cache=aot)
        seconds = run_engine(eng, True, batches, lambda e, b: e.submit(preds[b[0]:b[1]], target[b[0]:b[1]]))
        check(eng.stats.warmup_steps == 0, f"17(e) {name}: the warm engine captured")
        check(eng._transactional == (name != "plain"), f"17(e) {name}: transactional={eng._transactional}")
        compare_states(eng.state(), gpu_state, f"17(e) {name}")
        runs[name].append({"ms_per_step": seconds / eng.steps * 1e3, "steps": eng.steps})
    flagship = eng._state
    paged = MultiStreamEngine(make_collection(dev), PAGED_STREAMS, EngineConfig(
        buckets=PAGED_BUCKETS, kernel_backend="megastep"), stream_shard=True, resident_streams=RESIDENT)._state
    shadow = {}
    for name, state in (("flagship", flagship), ("paged_128", paged)):
        copy = {k: torch.empty_like(v) for k, v in state.items()}
        nbytes = sum(v.numel() * v.element_size() for v in state.values())
        ms = gpu_ms(lambda: [copy[k].copy_(v) for k, v in state.items()])
        bound, by = bound_ms(2 * nbytes, 0)  # each byte read once and written once
        shadow[name] = {"bytes": nbytes, "us": ms * 1e3, "bound_us": bound * 1e3, "bound_by": by}
    return {"runs": runs, "shadow_copy": shadow}


def chaos_phase(dev, preds, target, gpu_state):
    """Phase 17: the chaos sweep through the captured engines (module docstring)."""
    from metrics_tpu_torch.engine import AotCache

    aot = AotCache()
    try:
        return {"megastep": chaos_megastep(dev, preds, target, gpu_state),
                "paged": chaos_paged(dev, preds, target),
                "cost": chaos_cost(dev, preds, target, gpu_state, aot),
                "hang": chaos_hang(dev, preds, target, aot),
                "dead": chaos_dead(dev, preds, target, gpu_state, aot)}
    finally:
        shutil.rmtree(CHAOS_DIR, ignore_errors=True)


# ------------------------------------------------- phase 18: observability and overload

OBS_DIR = Path(__file__).resolve().parent / "build" / "phase18"  # gitignored; removed after the phase
OBS_PAGED_PREFIX = 320  # 18(b): the q8 tenancy's batches (the first spill at 197, the first staged seat at 237)
OBS_KERNEL_AT = 260  # 18(b): the paged engine's kernel site occurrence that fires, with rows staged
OBS_SHED_EVERY = 16  # 18(c): streams 15, 31, ... (625 of 10 000) are the shed class
OBS_SHED_CLASS = 2
OBS_SPILL_RATE = 0.5  # 18(c): one spill in a one-batch group trips the detector
OBS_UP_AFTER, OBS_DOWN_AFTER = 8, 4  # 18(c): the ladder's count hysteresis
OBS_TAIL = 24  # 18(c): the recovery tail's batches, over resident streams


def obs_dir(name):
    path = OBS_DIR / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return str(path)


def trace_tools():
    """The repository's stdlib-only validators (``tools/trace_export.py``)."""
    tools = str(Path(__file__).resolve().parent / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import trace_export

    return trace_export


def obs_traced(dev, preds, target, gpu_state, aot):
    """18(a): phase 7's engine and traffic with a recorder on the card: the
    Chrome trace, OpenMetrics text and telemetry document through the
    repository's tools, states against phase 4's; host ms a warm captured
    step with the recorder off and on, in turns."""
    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine, TraceRecorder

    trace_export = trace_tools()
    batches = ragged_batches(SEED + 2, 16, BUCKET)

    def submit(e, b):
        e.submit(preds[b[0]:b[1]], target[b[0]:b[1]])

    def engine(rec):
        return StreamingEngine(make_collection(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep",
                                                                 trace=rec), aot_cache=aot)

    rec = TraceRecorder(capacity=1 << 15, device=dev)  # on the card its folds launch K2
    eng = engine(rec)
    seconds = run_engine(eng, True, batches, submit)
    compare_states(eng.state(), gpu_state, "18(a) traced vs phase 4")
    eng.result()
    k2 = kernel_wrappers()["histogram"]
    before = k2.launches
    text = eng.metrics_text()
    tele = Path(obs_dir("a")) / "telemetry.json"
    eng.export_telemetry(str(tele))
    fold_launches = k2.launches - before
    doc = json.loads(json.dumps(rec.to_chrome_trace()))
    errors = trace_export.validate_chrome_trace(doc) + trace_export.validate_links(doc)
    check(not errors, f"18(a): the Chrome trace fails the validators: {errors[:3]}")
    submits, groups = rec.spans("submit"), rec.spans("coalesce")
    megabatches = sum(len(g["args"]["links"]) > 1 for g in groups)
    check(len(submits) == len(batches) and megabatches >= 1 and rec.dropped == 0,
          f"18(a): {len(submits)} submit spans for {len(batches)} batches, {megabatches} megabatches")
    fams = trace_export.parse_openmetrics(text)
    step = {s["name"].rsplit("_", 1)[-1]: s for s in fams["metrics_tpu_engine_step_latency_us"]["samples"]
            if not s["labels"] or s["labels"].get("le") == "+Inf"}
    folded = next(h for h in rec.histograms() if h.name == "step_latency_us").snapshot()
    check(sum(folded["counts"]) == step["count"]["value"] == step["bucket"]["value"] == eng.stats.steps,
          f"18(a): step histogram {sum(folded['counts'])} / {step['count']['value']} for {eng.stats.steps} steps")
    check(fold_launches >= 3, f"18(a): the scrape's folds launched K2 {fold_launches} times")
    report = subprocess.run([sys.executable, str(Path(__file__).resolve().parent / "tools" / "engine_report.py"),
                             str(tele), "--json"], capture_output=True, text=True, timeout=120)
    check(report.returncode == 0, f"18(a): engine_report failed: {report.stderr[-400:]}")
    rendered = json.loads(report.stdout)
    check(rendered["summary"]["steps"] == eng.stats.steps and rendered["trace"]["spans"] == len(rec.spans()),
          "18(a): engine_report's document disagrees with the engine")
    runs = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        warm = engine(TraceRecorder(device=dev) if mode == "on" else None)
        s = run_engine(warm, True, batches, submit)
        check(warm.stats.warmup_steps == 0, f"18(a) {mode}: the warm engine captured")
        compare_states(warm.state(), gpu_state, f"18(a) recorder {mode}")
        runs[mode].append({"ms_per_step": s / warm.steps * 1e3, "steps": warm.steps})
    by_name = rec.summary()["by_name"]
    return {"batches": len(batches), "steps": eng.steps, "seconds": seconds, "megabatches": megabatches,
            "spans": len(rec.spans()), "events": len(rec.events()), "fold_k2_launches": fold_launches,
            "fold_indices": 1 << max(0, (eng.stats.steps - 1).bit_length()),
            "span_us_total": {k: v["dur_us_total"] for k, v in by_name.items()},
            "queue_wait_p99_us": next(h for h in rec.histograms() if h.name == "queue_wait_us").quantile(0.99),
            "host_ms_per_warm_step": runs}


def obs_chaos_run(dev, preds, target, d):
    """One 18(b) run into a fresh recorder and capture cache: 17(a)'s plan on
    phase 7's engine and the restore past the corrupt LATEST, 17(b)'s sites
    on the first OBS_PAGED_PREFIX batches of phase 9's q8 tenancy, and 17(d)'s
    fatal kill read back by ``flush()`` (so no producer timing enters)."""
    from metrics_tpu_torch.engine import (
        AotCache,
        EngineConfig,
        EngineDispatchError,
        FaultInjector,
        FaultSpec,
        MultiStreamEngine,
        ScreenPolicy,
        StreamingEngine,
        TraceRecorder,
    )

    rec, aot = TraceRecorder(capacity=1 << 16, device=dev), AotCache()
    traffic = chaos_traffic(dev, preds, target)
    chaos = chaos_plan(len(traffic))
    screen = ScreenPolicy(non_finite="quarantine")

    def single(inj, **kw):
        return StreamingEngine(make_collection(dev), EngineConfig(
            buckets=(256, BUCKET), kernel_backend="megastep", screen=screen, snapshot_dir=d, fault_injector=inj,
            trace=rec, **kw), aot_cache=aot)

    run_engine(single(chaos, coalesce=8, snapshot_every=CHAOS_EVERY, snapshot_keep=4), True, traffic,
               lambda e, b: e.submit(*b))
    read = FaultInjector(seed=11, plan={"snapshot_read": FaultSpec(schedule=(0,))})
    resumed = single(read, coalesce=1)
    cursor = resumed.restore()["batches_done"]
    run_engine(resumed, True, traffic[cursor:], lambda e, b: e.submit(*b))
    pbatches = ragged_batches(SEED + 4, 8, 64)[:OBS_PAGED_PREFIX]
    psids = zipf_stream_ids(PAGED_STREAMS, len(pbatches), ALPHA, SEED + 4)
    paging = paging_plan(OBS_KERNEL_AT)
    paged = MultiStreamEngine(make_collection(dev, ap_precision="q8_block"), PAGED_STREAMS, EngineConfig(
        buckets=PAGED_BUCKETS, kernel_backend="megastep", compress_payloads=True, coalesce=1, fault_injector=paging,
        trace=rec), aot_cache=aot, stream_shard=True, resident_streams=RESIDENT)
    run_engine(paged, True, list(zip(psids, pbatches)),
               lambda e, b: e.submit(int(b[0]), preds[b[1][0]:b[1][1]], target[b[1][0]:b[1][1]]))
    kill = FaultInjector(seed=17, plan={"dispatcher_kill": FaultSpec(schedule=(0,), transient=False, fatal=True)})
    dead = StreamingEngine(make_collection(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep",
                                                              coalesce=1, fault_injector=kill, trace=rec),
                           aot_cache=aot)
    dead.start()
    dead.submit(preds[:100], target[:100])
    try:
        dead.flush()
        check(False, "18(b): the killed dispatcher's flush returned")
    except EngineDispatchError as e:
        check("dispatcher_kill" in str(e), f"18(b): {e}")
    dead.reset()
    dead.submit(preds[:100], target[:100])
    dead.flush()
    dead.stop()
    fired = {}
    for inj in (chaos, read, paging, kill):
        for site, n in inj.fired.items():
            fired[site] = fired.get(site, 0) + n
    states = {"resumed": {k: {s: v.detach().cpu().numpy() for s, v in m.items()} for k, m in resumed.state().items()},
              "paged": stacked_host(paged),
              "dead": {k: {s: v.detach().cpu().numpy() for s, v in m.items()} for k, m in dead.state().items()}}
    return rec, states, fired, {"paged_demotions": paged.stats.kernel_demotions, "cursor": cursor}


def obs_chaos(dev, preds, target):
    """18(b): the chaos plans of phase 17 (its 14 ported sites) twice into
    fresh recorders on the card: identical canonical sequences, bit-identical
    results, every firing a ``fault`` event."""
    runs = [obs_chaos_run(dev, preds, target, obs_dir(f"b{i}")) for i in range(2)]
    (rec0, states0, fired0, info0), (rec1, states1, fired1, _) = runs
    check(rec0.dropped == rec1.dropped == 0, "18(b): the recorder dropped records")
    check(rec0.canonical_sequence() == rec1.canonical_sequence(), "18(b): the canonical sequences differ")
    check(fired0 == fired1 and len(fired0) == 14, f"18(b): fired {fired0} / {fired1}")
    check(rec0.fault_sites() == fired0, f"18(b): fault events {rec0.fault_sites()} for firings {fired0}")
    check(info0["paged_demotions"] == 1, f"18(b): {info0}")
    for part, member in states0.items():
        for k, leaves in member.items():
            for name, v in leaves.items():
                w = states1[part][k][name]
                check(v.dtype == w.dtype and np.array_equal(v, w), f"18(b): {part} {k}.{name} differs between runs")
    seq = rec0.canonical_sequence()
    return {"fired": fired0, "records": {track: len(r) for track, r in seq.items()},
            "events": {name: len(rec0.events(name)) for name in ("fault", "retry", "rollback", "kernel_demotion",
                                                                  "quarantine")},
            **info0}


def obs_overload(dev, preds, target, preds_np, target_np):
    """18(c): phase 9's paged tenancy on the port's hot-spot-shift traffic
    (``shift_at`` the middle batch, the head rotated by S // 2), one batch a
    group (a flush after each submit), under an AdmissionPolicy with one
    shed class and a DegradationLadder on widen_coalesce, defer_cold_reads
    and shed whose detector reads the spill rate only; a recovery tail over
    resident streams; every stream against numpy over the admitted batches."""
    from metrics_tpu_torch.engine import (
        AdmissionPolicy,
        AdmissionRejected,
        DegradationLadder,
        EngineConfig,
        MultiStreamEngine,
        OverloadDetector,
        TraceRecorder,
    )

    batches = ragged_batches(SEED + 4, 8, 64)
    n = len(batches)
    sids = zipf_stream_ids(PAGED_STREAMS, n, ALPHA, SEED + 4, shift_at=n // 2, shift_rotation=PAGED_STREAMS // 2)
    shed_streams = set(range(OBS_SHED_EVERY - 1, PAGED_STREAMS, OBS_SHED_EVERY))
    admission = AdmissionPolicy(rows_per_s=1e9, burst_rows=1e9,  # the rate never binds: shedding is under test
                                priorities={s: OBS_SHED_CLASS for s in shed_streams}, default_priority=1)
    ladder = DegradationLadder(
        detector=OverloadDetector(queue_p99_us=None, spill_rate=OBS_SPILL_RATE, queue_depth_frac=None),
        rungs=("widen_coalesce", "defer_cold_reads", "shed"), up_after=OBS_UP_AFTER, down_after=OBS_DOWN_AFTER)
    rec = TraceRecorder(capacity=1 << 17, device=dev)
    eng = MultiStreamEngine(make_collection(dev), PAGED_STREAMS, EngineConfig(
        buckets=PAGED_BUCKETS, kernel_backend="megastep", coalesce=1, admission=admission, ladder=ladder,
        trace=rec), stream_shard=True, resident_streams=RESIDENT)
    fed, shed, engaged = [], [], {}
    top = len(ladder.rungs)

    def feed(sid, a, b):
        try:
            eng.submit(sid, preds[a:b], target[a:b])
        except AdmissionRejected as e:
            check(e.shed and e.priority == OBS_SHED_CLASS and e.retry_after_s == float("inf"), f"18(c): {e}")
            shed.append(sid)
            return False
        eng.flush()
        fed.append((sid, a, b))
        return True

    t0 = time.perf_counter()
    with eng:
        for i, (sid, (a, b)) in enumerate(zip(sids, batches)):
            feed(int(sid), a, b)
            if engaged or eng.stats.ladder_level < top:
                continue
            # the shed rung engaged: a shed-class probe is refused, a cold
            # stream's repeated read is served from the cache, and a recovery
            # tail over resident streams (no spill) walks the ladder down
            engaged["at_batch"] = i
            probe = min(shed_streams)
            check(not feed(probe, 0, 8), "18(c): a shed-class submit was admitted under the shed rung")
            cold = next(s for s, _, _ in fed if s not in shed_streams and eng.pager.slot_of(0, s) is None)
            v1, v2 = eng.result(cold), eng.result(cold)
            check(eng.stats.deferred_reads == 1 and all(v1[k] is v2[k] for k in v1),
                  f"18(c): {eng.stats.deferred_reads} deferred reads for stream {cold}")
            engaged["cold_stream"] = cold
            resident = [s for s in eng.pager.resident_streams(0) if s not in shed_streams][:8]
            outs = eng.stats.page_outs
            for j, (ta, tb) in enumerate(batches[:OBS_TAIL]):
                feed(resident[j % len(resident)], ta, tb)
                if eng.stats.ladder_level == 0 and "tail_to_level_0" not in engaged:
                    engaged["tail_to_level_0"] = j + 1
            check(eng.stats.ladder_level == 0 and eng.stats.page_outs == outs,
                  f"18(c): the ladder is at {eng.stats.ladder_level} after the recovery tail "
                  f"({eng.stats.page_outs - outs} spills in it)")
            check(feed(probe, 0, 8), "18(c): the shed class is still refused after the walk down")
        main_s = time.perf_counter() - t0
        check(engaged and engaged["at_batch"] >= n // 2, f"18(c): the ladder reached shed at {engaged} "
              f"(the shift is at batch {n // 2})")
        level_at_end = eng.stats.ladder_level
        text = eng.metrics_text()
    transitions = [(e["args"]["action"], e["args"]["level"]) for e in rec.events("ladder")]
    check(len(transitions) == eng.stats.ladder_transitions and len(rec.events("admission_rejected")) == len(shed),
          "18(c): the ladder and admission events disagree with the counters")
    check(rec.spans("page_in") and rec.spans("page_out") and rec.spans("route"), "18(c): no paging spans")
    fams = trace_tools().parse_openmetrics(text)
    for fam in ("admission_admitted", "admission_shed", "ladder_level", "ladder_transitions", "deferred_reads"):
        check(f"metrics_tpu_engine_{fam}" in fams, f"18(c): family {fam} missing from metrics_text()")
    check(eng.telemetry()["admission"]["shed_by_priority"] == {str(OBS_SHED_CLASS): len(shed)},
          "18(c): the telemetry's admission block")
    host = stacked_host(eng)
    rows = {}
    for sid, a, b in fed:
        rows.setdefault(sid, []).append(np.arange(a, b))
    touched = np.asarray(sorted(rows), np.int64)
    for k, member in host.items():
        for name, v in member.items():
            rest = np.ones(PAGED_STREAMS, bool)
            rest[touched] = False
            check(not np.any(v[rest]), f"18(c): an untouched stream's {k}.{name} is not zero")
    for sid, idx in rows.items():
        want = oracle_states(preds_np[np.concatenate(idx)], target_np[np.concatenate(idx)])
        for k, member in want.items():
            for name, w in member.items():
                check(np.array_equal(host[k][name][sid].astype(np.float64), np.asarray(w, np.float64)),
                      f"18(c): stream {sid} {k}.{name} differs from numpy")
    return {"batches": n, "shift_at": n // 2, "admitted": len(fed), "shed_drops": len(shed),
            "shed_engaged": engaged, "level_at_end": level_at_end,
            "transitions": eng.stats.ladder_transitions, "escalations": sum(a == "escalate" for a, _ in transitions),
            "deferred_reads": eng.stats.deferred_reads, "steps": eng.steps, "page_outs": eng.stats.page_outs,
            "page_ins": eng.stats.page_ins, "streams_checked": PAGED_STREAMS, "streams_touched": len(rows),
            "main_seconds": main_s, "ms_per_batch": main_s / n * 1e3,
            "page_in_spans": len(rec.spans("page_in")), "page_out_spans": len(rec.spans("page_out"))}


def obs_fold_entry(dev, n_idx):
    """The ``kernels`` entry of K2 at the recorder fold's shape: ``n_idx``
    int32 bucket indices into 15 bins (18(a)'s step histogram, padded to a
    power of two with the out-of-range 15, which drops), held against the
    plain version and ``torch.bincount`` (with one bin more for the pad) and
    timed. Before it, a card histogram against a CPU one over 4096 seeded
    observations, each folded inline once."""
    from metrics_tpu_torch.engine import DEFAULT_LATENCY_BUCKETS_US, FixedBucketHistogram
    from metrics_tpu_torch.ops.kernels.hist_cuda import histogram_cuda, histogram_plain

    vals = np.random.RandomState(SEED + 18).gamma(2.0, 400.0, size=FixedBucketHistogram.FOLD_PENDING_AT)
    card, cpu = (FixedBucketHistogram("h_us", device=d) for d in (dev, "cpu"))
    for v in vals:
        card.observe(v)
        cpu.observe(v)
    check(np.array_equal(card.bucket_counts(), cpu.bucket_counts()) and card.count == vals.size,
          "recorder fold: the card's counts differ from the CPU's")
    edges = np.asarray(DEFAULT_LATENCY_BUCKETS_US)
    length = edges.size + 1
    idx_np = np.full(n_idx, length, np.int32)
    idx_np[: min(n_idx, vals.size)] = np.searchsorted(edges, vals[:n_idx], side="left")
    idx = torch.from_numpy(idx_np).to(dev)
    i2 = idx[None]
    kernel = lambda: histogram_cuda(i2, length, None, None)  # noqa: E731
    plain = lambda: histogram_plain(i2, length, None, None)  # noqa: E731
    library = lambda: torch.bincount(idx, minlength=length + 1)  # noqa: E731
    got, want, lib = kernel()[0], plain()[0], library()[:length].to(torch.int32)
    check(torch.equal(got, want) and torch.equal(got, lib), "recorder fold: K2 differs from its plain version")
    entry = {
        "name": "histogram", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/hist.cu",
        "replaces": "metrics_tpu/ops/kernels/pallas_hist.py:55",
        "shape": f"idx ({n_idx},) int32 into {length} bins (the flight recorder's histogram fold)",
        "max_abs_err": max_abs_err(got, want), "max_abs_err_bf16": None,
        "ms": gpu_ms(kernel), "plain_ms": gpu_ms(plain), "library_ms": gpu_ms(library),
        "device_us": device_us(kernel),
    }
    # the indices read once, the counts written once; one add per index
    entry["bound_ms"], entry["bound_by"] = bound_ms(4 * n_idx + 4 * length, n_idx)
    return entry


def obs_phase(dev, preds, target, preds_np, target_np, gpu_state):
    """Phase 18: the flight recorder, the stats ring and OpenMetrics, and the
    admission control and degradation ladder that read them (module docstring)."""
    from metrics_tpu_torch.engine import AotCache

    try:
        return {"traced": obs_traced(dev, preds, target, gpu_state, AotCache()),
                "chaos": obs_chaos(dev, preds, target),
                "overload": obs_overload(dev, preds, target, preds_np, target_np)}
    finally:
        shutil.rmtree(OBS_DIR, ignore_errors=True)


WIN_DIR = Path(__file__).resolve().parent / "build" / "phase19"  # gitignored; removed after the phase
WIN_PANE = 16  # 19(a), (b), (e): batches per pane of phase 7's traffic
WIN_TUMBLING = 3  # 19(a): the tumbling ring's panes (it wraps: every pane row is cleared and reused)
WIN_SLIDE = 3  # 19(b), (e): the sliding ring's panes
WIN_SNAP_EVERY = 24  # 19(e): the snapshot cadence ...
WIN_KILL = 90  # ... and the batch after which the engine dies: its newest snapshot, 72, is half a pane in
WIN_PAGED_BATCHES = 800  # 19(d): the prefix of phase 9's traffic the windowed tenancy takes
WIN_PAGED_PANE = 300  # 19(d): batches per pane (two rotations: the live window is [300, 800))
WIN_PAGED_SAMPLE = 200  # 19(d): streams held against numpy, as phase 9a samples them
WIN_EWMA_PANE = 8  # 19(g): batches per EWMA rotation
WIN_DRIFT = dict(num_streams=4, n_batches=72, seed=7, max_rows=8, label_acc=0.92, drift_at=36, drift_ramp=6,
                 drift_flip=0.8)  # 19(f): the JAX package's windows smoke's label-drift traffic


def window_dir(name):
    path = WIN_DIR / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return str(path)


def windowed_engine(dev, window, aot, make=make_collection, **cfg):
    """Phase 7's megastep engine under ``window`` (None: cumulative, with no
    ``window`` field at all, as a tree without windows builds it)."""
    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine

    if window is not None:
        cfg["window"] = window
    return StreamingEngine(make(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep", **cfg),
                           aot_cache=aot)


def fresh_run(dev, preds, target, batches, aot):
    """A cumulative megastep engine over ``batches`` alone, sharing ``aot``:
    the window's oracle on the card, replaying the same captured graphs."""
    eng = windowed_engine(dev, None, aot)
    with eng:
        for a, b in batches:
            eng.submit(preds[a:b], target[a:b])
    check(eng.stats.warmup_steps == 0, "19: a fresh engine captured")
    return eng


def warm_cache(dev, preds, target, aot):
    """Capture the cumulative megastep engine's two steps (one batch per
    bucket) into ``aot``: every engine of 19(a), (b), (e) and the timing,
    windowed or not, replays these two graphs and captures nothing."""
    fresh = windowed_engine(dev, None, aot)
    with fresh:
        for a, b in ((0, 100), (100, 1100)):
            fresh.submit(preds[a:b], target[a:b])
            fresh.flush()
    check(aot.misses == 2, f"19: {aot.misses} captures for the two buckets")


def pane_row(eng, pane):
    """Pane ``pane``'s logical state out of a ring's ``state()``."""
    return {k: {s: v[pane] for s, v in member.items()} for k, member in eng.state().items()}


def bit_equal_values(got, want, what):
    """Two value trees bit for bit (19's windows against fresh engines)."""
    g, w = flat_values(got), flat_values(want)
    for k in w:
        check(g[k].shape == w[k].shape and torch.equal(g[k], w[k]), f"{what}: value {k} differs")


def window_tumbling(dev, preds, target, aot):
    """19(a) and (c): phase 7's engine and traffic under ``tumbling(16 batches,
    3 panes)``; at each pane's close the ring's row of that pane equals a fresh
    engine's state over the pane's batches, and the open pane's ``result()``
    at the end a fresh engine's; the windowed engine replays the cumulative
    engine's two graphs and captures nothing across its rotations."""
    from metrics_tpu_torch.engine import WindowPolicy

    batches = ragged_batches(SEED + 2, 16, BUCKET)
    eng = windowed_engine(dev, WindowPolicy.tumbling(pane_batches=WIN_PANE, n_panes=WIN_TUMBLING), aot)
    checked = 0
    t0 = time.perf_counter()
    with eng:
        for i, (a, b) in enumerate(batches):
            eng.submit(preds[a:b], target[a:b])
            if (i + 1) % WIN_PANE == 0:
                pane = i // WIN_PANE
                eng.flush()
                check(eng.rotations == pane + 1 and eng.pane_cursor == (pane + 1) % WIN_TUMBLING,
                      f"19(a): ring at rotation {eng.rotations}, cursor {eng.pane_cursor} after pane {pane}")
                fresh = fresh_run(dev, preds, target, batches[pane * WIN_PANE:(pane + 1) * WIN_PANE], aot)
                compare_states(pane_row(eng, pane % WIN_TUMBLING), fresh.state(), f"19(a) pane {pane}")
                checked += 1
        open_start = (len(batches) // WIN_PANE) * WIN_PANE
        bit_equal_values(eng.result(), fresh_run(dev, preds, target, batches[open_start:], aot).result(),
                    "19(a) open pane")
    seconds = time.perf_counter() - t0
    check(checked >= 3 and eng.rotations >= 3, f"19(a): {checked} panes checked, {eng.rotations} rotations")
    check(eng.stats.warmup_steps == 0 and aot.misses == 2,
          f"19(c): {eng.stats.warmup_steps} captures across {eng.rotations} rotations")
    check(eng.stats.kernel_fallbacks_by_reason() == {}, "19(a): the windowed megastep engine fell back")
    return {"panes_checked": checked, "rotations": eng.rotations, "captures": eng.stats.warmup_steps,
            "cache_misses": aot.misses, "steps": eng.steps, "seconds": seconds}


def window_sliding(dev, preds, target, aot):
    """19(b): the same under ``sliding(3 panes of 16 batches)``: ``result()``
    read in the middle of every pane equals a recompute, a fresh engine over
    the live panes' batches, bit for bit."""
    from metrics_tpu_torch.engine import WindowPolicy

    batches = ragged_batches(SEED + 2, 16, BUCKET)
    eng = windowed_engine(dev, WindowPolicy.sliding(n_panes=WIN_SLIDE, pane_batches=WIN_PANE), aot)
    reads = 0
    with eng:
        for i, (a, b) in enumerate(batches):
            eng.submit(preds[a:b], target[a:b])
            if i % WIN_PANE == WIN_PANE // 2:
                start = max(0, (i // WIN_PANE - (WIN_SLIDE - 1)) * WIN_PANE)
                bit_equal_values(eng.result(), fresh_run(dev, preds, target, batches[start:i + 1], aot).result(),
                            f"19(b) batch {i}")
                reads += 1
    check(reads >= 4 and eng.rotations == len(batches) // WIN_PANE, f"19(b): {reads} reads")
    check(eng.stats.warmup_steps == 0, "19(b): the sliding engine captured")
    return eng, {"reads": reads, "rotations": eng.rotations, "steps": eng.steps}


def window_resume(dev, preds, target, aot, sliding):
    """19(e): 19(b)'s engine with ``snapshot_every=24`` killed after batch 90;
    a fresh engine sharing the cache restores the newest generation (cursor
    72, half a pane into the ring), replays the rest and ends with 19(b)'s
    ring and value, bit for bit, capturing nothing."""
    from metrics_tpu_torch.engine import WindowPolicy

    batches = ragged_batches(SEED + 2, 16, BUCKET)
    window = WindowPolicy.sliding(n_panes=WIN_SLIDE, pane_batches=WIN_PANE)
    d = window_dir("resume")
    killed = windowed_engine(dev, window, aot, snapshot_every=WIN_SNAP_EVERY, snapshot_dir=d)
    with killed:
        for a, b in batches[:WIN_KILL]:
            killed.submit(preds[a:b], target[a:b])
    del killed
    misses = aot.misses
    resumed = windowed_engine(dev, window, aot, snapshot_dir=d)
    t0 = time.perf_counter()
    meta = resumed.restore()
    restore_ms = (time.perf_counter() - t0) * 1e3
    cursor = int(meta["batches_done"])
    check(cursor == (WIN_KILL // WIN_SNAP_EVERY) * WIN_SNAP_EVERY and cursor % WIN_PANE != 0,
          f"19(e): restored at cursor {cursor}, not mid-pane")
    check(meta["window"] == window.fingerprint() and int(meta["pane_fill"]) == cursor % WIN_PANE,
          f"19(e): meta {meta.get('window')} fill {meta.get('pane_fill')}")
    with resumed:
        for a, b in batches[cursor:]:
            resumed.submit(preds[a:b], target[a:b])
    check((resumed.rotations, resumed.pane_cursor) == (sliding.rotations, sliding.pane_cursor), "19(e): ring marks")
    compare_states(resumed.state(), sliding.state(), "19(e) ring")
    bit_equal_values(resumed.result(), sliding.result(), "19(e) value")
    check(aot.misses == misses, "19(e): the resumed engine captured")
    return {"cursor": cursor, "pane_fill": int(meta["pane_fill"]), "restore_ms": restore_ms}


def window_paged(dev, preds, target, preds_np, target_np):
    """19(d): phase 9's q8 tenancy (10 000 streams, 128 slots,
    ``compress_payloads=True``, ``coalesce=1``) on its first 800 batches under
    ``sliding(2 panes of 300 batches)``: each (stream, pane) is its own pager
    row, so pane rows spill and page back in as int8 codes K7 decodes; every
    sampled stream's two pane rows against numpy over that pane's rows
    (integer states exact), streams seen only before the window all-zero."""
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, WindowPolicy

    batches = ragged_batches(SEED + 4, 8, 64)
    sids = zipf_stream_ids(PAGED_STREAMS, len(batches), ALPHA, SEED + 4)[:WIN_PAGED_BATCHES]
    batches = batches[:WIN_PAGED_BATCHES]
    eng = MultiStreamEngine(make_collection(dev, ap_precision="q8_block"), PAGED_STREAMS,
                            EngineConfig(buckets=PAGED_BUCKETS, kernel_backend="megastep", compress_payloads=True,
                                         coalesce=1, window=WindowPolicy.sliding(n_panes=2, pane_batches=WIN_PAGED_PANE)),
                            stream_shard=True, resident_streams=RESIDENT)
    before = counts()
    seconds = run_engine(eng, True, list(zip(sids, batches)),
                         lambda e, b: e.submit(int(b[0]), preds[b[1][0]:b[1][1]], target[b[1][0]:b[1][1]]))
    launched = delta(before)
    st = eng.stats
    check(eng.rotations == WIN_PAGED_BATCHES // WIN_PAGED_PANE, f"19(d): {eng.rotations} rotations")
    check(st.page_outs > 0 and st.q8_staged_rows > 0, f"19(d): spills {st.page_outs}, staged {st.q8_staged_rows}")
    check(launched["megastep_segment"] > 0 and launched["megastep_segment_q8"] > 0, f"19(d): launches {launched}")
    # the ring after two rotations: pane 0 holds [600, 800) (open), pane 1 holds [300, 600)
    panes = {0: (600, WIN_PAGED_BATCHES), 1: (WIN_PAGED_PANE, 600)}
    rows = {p: stream_rows(sids[lo:hi], batches[lo:hi]) for p, (lo, hi) in panes.items()}
    live = sorted(set(rows[0]) | set(rows[1]), key=lambda s: -sum(len(rows[p].get(s, ())) for p in rows))
    early = [s for s in stream_rows(sids[:WIN_PAGED_PANE], batches[:WIN_PAGED_PANE]) if s not in live][:20]
    sample = live[:WIN_PAGED_SAMPLE // 2] + live[-WIN_PAGED_SAMPLE // 2:] + early
    empty = np.zeros(0, np.int64)
    for sid in sample:
        ring = eng.stream_state(sid)
        for p in panes:
            idx = rows[p].get(sid, empty)
            want = {k: v for k, v in oracle_states(preds_np[idx], target_np[idx]).items() if k != "binned_ap"}
            compare_states({k: {s: v[p] for s, v in m.items()} for k, m in ring.items()}, want,
                           f"19(d) stream {sid} pane {p}")
    return {"batches": WIN_PAGED_BATCHES, "rotations": eng.rotations, "page_outs": st.page_outs,
            "page_ins": st.page_ins, "q8_staged_rows": st.q8_staged_rows, "streams_checked": len(sample),
            "early_streams_zero": len(early), "s_per_step": seconds / eng.steps, "launches": launched}


def drift_run(dev, aot=None):
    from metrics_tpu_torch import Accuracy
    from metrics_tpu_torch.engine import DriftDetector, EngineConfig, StreamingEngine, WindowPolicy
    from metrics_tpu_torch.engine.traffic import zipf_traffic

    det = DriftDetector(threshold=0.2, up_after=2, down_after=2, baseline="first")
    eng = StreamingEngine(Accuracy(device=dev), EngineConfig(buckets=(32,), coalesce=1, kernel_backend="megastep",
                                                             window=WindowPolicy.tumbling(pane_batches=6), drift=det),
                          aot_cache=aot)
    with eng:
        for _, p, t in zipf_traffic(**WIN_DRIFT):
            eng.submit(torch.from_numpy(p).to(dev), torch.from_numpy(t).to(dev))
    return det, eng


def window_drift(dev, aot):
    """19(f): the JAX package's seeded label-drift traffic through a tumbling
    megastep engine with a ``DriftDetector`` (6-batch panes): at least one
    raise; two runs on the card and one on the CPU give the same pane
    histories and alarm lists; one evaluation per rotation."""
    det_a, eng_a = drift_run(dev, aot)
    det_b, _ = drift_run(dev, aot)
    det_c, _ = drift_run(torch.device("cpu"))
    alarms = [a.describe() for a in det_a.alarms()]
    check(len(det_a.alarms("raise")) >= 1, f"19(f): no alarm (history {det_a.history()})")
    for other, what in ((det_b, "a second run"), (det_c, "the CPU run")):
        check(other.history() == det_a.history() and [a.describe() for a in other.alarms()] == alarms,
              f"19(f): {what} diverged")
    check(eng_a.stats.drift_evals == eng_a.rotations and eng_a.stats.drift_alarms >= 1,
          f"19(f): drift accounting {eng_a.stats.windows_summary()}")
    return {"alarms": alarms, "history": det_a.history(), "rotations": eng_a.rotations}


def window_ewma(dev, preds, target, aot):
    """19(g): a mean and a sum of phase 7's class-0 scores (rounded to 1/64)
    under ``ewma(alpha=0.5, 8 batches)`` against the hand-decayed float64
    accumulation. A batch's sum is exact in f32; each state rounds once per
    fold and per decay, so the sum holds within (folds + decays) * 2^-24
    relative, the mean within twice that plus one rounding; one decay per
    rotation."""
    from metrics_tpu_torch import MeanMetric, MetricCollection, SumMetric
    from metrics_tpu_torch.engine import WindowPolicy

    batches = ragged_batches(SEED + 2, 16, BUCKET)
    x = torch.round(preds[:, 0] * 64) / 64
    xn = x.cpu().double().numpy()
    eng = windowed_engine(dev, WindowPolicy.ewma(alpha=0.5, pane_batches=WIN_EWMA_PANE), aot,
                          make=lambda d: MetricCollection({"mean": MeanMetric(device=d), "sum": SumMetric(device=d)}))
    s = w = 0.0
    with eng:
        for i, (a, b) in enumerate(batches):
            eng.submit(x[a:b])
            s += float(xn[a:b].sum())
            w += b - a
            if (i + 1) % WIN_EWMA_PANE == 0:
                s, w = s * 0.5, w * 0.5
        got = {k: float(v) for k, v in eng.result().items()}
    want = {"mean": s / w, "sum": s}
    ops = len(batches) + len(batches) // WIN_EWMA_PANE
    tol = {"sum": ops * 2.0 ** -24, "mean": (2 * ops + 1) * 2.0 ** -24}
    for k in want:
        check(abs(got[k] - want[k]) <= tol[k] * abs(want[k]), f"19(g): {k} {got[k]} != {want[k]}")
    check(eng.stats.ewma_decays == eng.rotations == len(batches) // WIN_EWMA_PANE, "19(g): decays")
    return {"value": got, "oracle": want, "rel_err": {k: abs(got[k] - want[k]) / abs(want[k]) for k in want},
            "rel_bound": tol, "decays": eng.stats.ewma_decays}


def window_cost(dev, preds, target, aot, kinds=("cumulative", "windowed", "windowed", "cumulative")):
    """Host ms per warm captured step of phase 7's traffic: a cumulative
    megastep engine and its sliding twin, warm (sharing 19's cache), in the
    turns ``kinds`` gives. With only ``"cumulative"`` turns it runs on a tree
    without windows too (a parent commit's, this file copied over)."""
    batches = ragged_batches(SEED + 2, 16, BUCKET)
    out = {"cumulative": [], "windowed": []}
    for kind in kinds:
        window = None
        if kind == "windowed":
            from metrics_tpu_torch.engine import WindowPolicy

            window = WindowPolicy.sliding(n_panes=WIN_SLIDE, pane_batches=WIN_PANE)
        eng = windowed_engine(dev, window, aot)
        seconds = run_engine(eng, True, batches, lambda e, b: e.submit(preds[b[0]:b[1]], target[b[0]:b[1]]))
        check(eng.stats.warmup_steps == 0, f"19 timing: the warm {kind} engine captured")
        out[kind].append({"ms_per_step": seconds / eng.steps * 1e3, "steps": eng.steps,
                          "ms_per_batch": seconds / len(batches) * 1e3})
    return out


def window_phase(dev, preds, target, preds_np, target_np):
    """Phase 19: windows and drift (module docstring)."""
    from metrics_tpu_torch.engine import AotCache

    aot = AotCache()
    try:
        warm_cache(dev, preds, target, aot)
        out = {"tumbling": window_tumbling(dev, preds, target, aot)}
        sliding, out["sliding"] = window_sliding(dev, preds, target, aot)
        out["resume"] = window_resume(dev, preds, target, aot, sliding)
        out["paged"] = window_paged(dev, preds, target, preds_np, target_np)
        out["drift"] = window_drift(dev, AotCache())
        out["ewma"] = window_ewma(dev, preds, target, AotCache())
        out["cost"] = window_cost(dev, preds, target, aot)
        return out
    finally:
        shutil.rmtree(WIN_DIR, ignore_errors=True)


# ------------------------------------------------------------ phase 20: ragged serving

RAG_DIR = Path(__file__).resolve().parent / "build" / "phase20"  # gitignored; removed after the phase
# 20(a), (b): metrics_tpu/engine/ragged_bench.py's Zipf serving: 512 query groups, 240 batches, buckets (8, 24)
RAG_GROUPS = 512
RAG_BATCHES = 240
RAG_BUCKETS = (8, 24)
RAG_NDCG_K = 10
# 20(c): the bench's aggregate series: G groups, 2 rows a group, capacity 16
RAG_SERIES = (512, 10_000, 100_000)
RAG_SERIES_ROWS = 2
RAG_SERIES_CAPACITY = 16
# 20(d): the bench's million-group paging, with buckets (256, 1024), not its (8, 24): 200 000 rows at 24 a round
# would take ~8 300 routed steps
RAG_PAGED_GROUPS = 1_000_000
RAG_PAGED_ROWS = 200_000
RAG_PAGED_ALPHA = 1.2
RAG_PAGED_RESIDENT = 8_192
RAG_PAGED_CAPACITY = 16
RAG_PAGED_BUCKETS = (256, 1024)
RAG_PAGED_CHUNK = 8_192  # rows a submit, as the bench
RAG_PANE = 40  # 20(e): batches per pane
RAG_WINDOW_BATCHES = 100  # 20(e): batches the windowed engines take (2.5 panes)
RAG_RESIDENT = 64  # 20(e): resident groups of the windowed group_shard engines
RAG_KILL = 120  # 20(e): the batch after which the engine is snapshotted and killed
RAG_TIMED = 5  # device aggregates per median


def rag_dir(name):
    d = RAG_DIR / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return str(d)


def ragged_traffic():
    """The bench's Zipf traffic, its capacity (the power of two at or above
    the hottest group's rows) and the groups it touches."""
    from metrics_tpu_torch.engine import zipf_traffic

    traffic = zipf_traffic(RAG_GROUPS, RAG_BATCHES, alpha=1.05, seed=23)
    rows = np.zeros(RAG_GROUPS, np.int64)
    for gid, p, _ in traffic:
        rows[gid] += p.shape[0]
    return traffic, 1 << int(np.ceil(np.log2(max(2, int(rows.max()))))), int((rows > 0).sum())


def binary_target(p, t):
    return t.astype(np.float32)


def graded_target(p, t):
    """20(b)'s graded relevance, 0-2: the binary label plus one for a high score."""
    return (t + (p > 0.75)).astype(np.float32)


def rag_serve(eng, traffic, target_of):
    """Submit ``traffic`` one scalar-keyed batch at a time and flush: host s."""
    t0 = time.perf_counter()
    for gid, p, t in traffic:
        eng.submit(gid, p, target_of(p, t))
    eng.flush()
    return time.perf_counter() - t0


def rag_rows(traffic, target_of):
    """The traffic's rows in submission order: preds, target, group ids."""
    return (np.concatenate([p for _, p, _ in traffic]), np.concatenate([target_of(p, t) for _, p, t in traffic]),
            np.concatenate([np.full(p.shape[0], gid, np.int64) for gid, p, _ in traffic]))


def rag_eager(dev, make, rows):
    m = make(dev)
    target = rows[1] if m.allow_non_binary_target else rows[1].astype(np.int64)  # the engine's rows carry f32
    m.update(torch.from_numpy(rows[0]), torch.from_numpy(target), indexes=torch.from_numpy(rows[2]))
    return float(m.compute())


def rag_timed(fn, runs=RAG_TIMED):
    """Median host ms of ``fn`` (a read that ends with its value on the host)."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def rel_close(got, want, what, tol=1e-6):
    err = abs(got - want) / max(1.0, abs(want))
    check(err <= tol, f"{what}: {got} vs {want} (relative {err:.3g} > {tol})")
    return err


def ragged_zipf(dev, traffic, capacity, make, per_group, target_of, what):
    """20(a)/(b): the Zipf traffic through the captured engine and its CPU
    twin (plain versions): states bit-equal, per-group values against the
    CPU functional and the twin, the device aggregate against its oracle and
    the eager metric on the card and on the CPU; then a reset and a replay
    that captures nothing."""
    from metrics_tpu_torch.engine import AotCache, EngineConfig, RaggedEngine
    from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda

    cpu = torch.device("cpu")
    aot = AotCache()
    eng = RaggedEngine(make(dev), num_groups=RAG_GROUPS, config=EngineConfig(buckets=RAG_BUCKETS),
                       capacity=capacity, aot_cache=aot)
    twin = RaggedEngine(make(cpu), num_groups=RAG_GROUPS, config=EngineConfig(buckets=RAG_BUCKETS), capacity=capacity)
    with eng, twin:
        ingest_s = rag_serve(eng, traffic, target_of)
        steps = eng.steps
        rag_serve(twin, traffic, target_of)
        state = {k: v.cpu() for k, v in eng.state().items()}
        twin_state = twin.state()
        for k in twin_state:
            check(torch.equal(state[k], twin_state[k]), f"{what}: state {k} differs from the CPU twin")
        per = [float(v) for v in eng.results().values()]
        per_cpu = [float(v) for v in twin.results().values()]
        value = float(eng.aggregate())
        k1 = fold_rows_cuda.launches
        agg_ms = rag_timed(lambda: float(eng.aggregate()))
        k1_per = (fold_rows_cuda.launches - k1) / RAG_TIMED
        t0 = time.perf_counter()
        oracle = float(eng.aggregate(oracle=True))
        oracle_ms = (time.perf_counter() - t0) * 1e3
        cpu_value = float(twin.aggregate())
        misses = aot.misses
        eng.reset()
        warm_s = rag_serve(eng, traffic, target_of)
        warm_steps = eng.steps
        check(aot.misses == misses, f"{what}: the replay after reset() captured {aot.misses - misses} steps")
        summary = eng.stats.ragged_summary()
    rows = rag_rows(traffic, target_of)
    eager_card, eager_cpu = rag_eager(dev, make, rows), rag_eager(cpu, make, rows)
    want = [per_group(rows, g) for g in range(RAG_GROUPS)]
    err_groups = max(abs(a - b) for a, b in zip(per, want))
    check(err_groups <= 1e-6, f"{what}: per-group results() {err_groups} from the CPU functional")
    check(max(abs(a - b) for a, b in zip(per, per_cpu)) <= 1e-6, f"{what}: per-group results() vs the CPU twin")
    errs = {"oracle": rel_close(value, oracle, f"{what}: device aggregate vs its oracle"),
            "eager_card": rel_close(value, eager_card, f"{what}: device aggregate vs the eager metric on the card"),
            "eager_cpu": rel_close(value, eager_cpu, f"{what}: device aggregate vs the eager metric on the CPU"),
            "cpu_engine": rel_close(value, cpu_value, f"{what}: device aggregate vs the CPU twin's")}
    check(k1_per == 4, f"{what}: {k1_per} K1 launches per aggregate, not 4")
    rows_n = int(rows[0].shape[0])
    return {"value": value, "rel_err": errs, "per_group_max_abs_err": err_groups, "rows": rows_n,
            "capacity": capacity, "steps": steps, "warm_steps": warm_steps, "ingest_rows_per_s": rows_n / ingest_s,
            "host_ms_per_step": ingest_s / steps * 1e3, "host_ms_per_warm_step": warm_s / warm_steps * 1e3,
            "aggregate_ms": agg_ms, "oracle_ms": oracle_ms, "k1_per_aggregate": k1_per,
            "captures": aot.misses, "ragged": summary}, state, value


def ragged_series(dev):
    """20(c): the device aggregate against the oracle at G groups of two rows."""
    import metrics_tpu_torch as mp
    from metrics_tpu_torch.engine import AotCache, RaggedEngine
    from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda

    rng = np.random.default_rng(31)
    out = {}
    for g in RAG_SERIES:
        n = g * RAG_SERIES_ROWS
        gids = (np.arange(n, dtype=np.int64) % g).astype(np.int32)
        preds = rng.random(n).astype(np.float32)
        target = (rng.random(n) < 0.4).astype(np.float32)
        eng = RaggedEngine(mp.RetrievalMAP(device=dev), num_groups=g, capacity=RAG_SERIES_CAPACITY,
                           aot_cache=AotCache())
        with eng:
            for lo in range(0, n, 32_768):
                eng.submit(gids[lo:lo + 32_768], preds[lo:lo + 32_768], target[lo:lo + 32_768])
            eng.flush()
            value = float(eng.aggregate())
            k1 = fold_rows_cuda.launches
            device_ms = rag_timed(lambda: float(eng.aggregate()))
            k1_per = (fold_rows_cuda.launches - k1) / RAG_TIMED
            t0 = time.perf_counter()
            oracle = float(eng.aggregate(oracle=True))
            oracle_ms = (time.perf_counter() - t0) * 1e3
        check(k1_per == 4, f"20(c) G={g}: {k1_per} K1 launches per aggregate, not 4")
        out[str(g)] = {"device_ms": device_ms, "oracle_ms": oracle_ms, "k1_per_aggregate": k1_per,
                       "rel_err": rel_close(value, oracle, f"20(c) G={g}: device aggregate vs its oracle")}
    return out


def paged_ragged_rows():
    """20(d)'s rows: Zipf(1.2) group ids over a million groups, each group
    clipped to capacity at the source (the bench's draw, seed 37)."""
    rng = np.random.default_rng(37)
    raw = rng.zipf(RAG_PAGED_ALPHA, RAG_PAGED_ROWS).astype(np.int64) - 1
    raw = raw[raw < RAG_PAGED_GROUPS]
    order = np.argsort(raw, kind="stable")
    sorted_g = raw[order]
    start = np.r_[True, sorted_g[1:] != sorted_g[:-1]]
    idx = np.arange(sorted_g.size)
    keep = np.zeros(raw.size, bool)
    keep[order] = (idx - np.maximum.accumulate(np.where(start, idx, 0))) < RAG_PAGED_CAPACITY
    gids = raw[keep].astype(np.int32)
    preds = rng.random(gids.size).astype(np.float32)
    target = (rng.random(gids.size) < 0.4).astype(np.float32)
    return preds, target, gids


def ragged_paging(dev):
    """20(d): a million groups through ``group_shard`` with 8192 resident:
    the sweep's blocks are one per 1024 touched groups, its value the eager
    segment path's over the same rows."""
    import metrics_tpu_torch as mp
    from metrics_tpu_torch.engine import AotCache, EngineConfig, RaggedEngine
    from metrics_tpu_torch.engine.ragged import _AGG_BLOCK_ROWS
    from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda
    from metrics_tpu_torch.ops.kernels.segment_cuda import segment_reduce_cuda

    preds, target, gids = paged_ragged_rows()
    n, touched = int(gids.size), int(np.unique(gids).size)
    eng = RaggedEngine(mp.RetrievalMAP(device=dev), num_groups=RAG_PAGED_GROUPS, capacity=RAG_PAGED_CAPACITY,
                       config=EngineConfig(buckets=RAG_PAGED_BUCKETS), group_shard=True,
                       resident_groups=RAG_PAGED_RESIDENT, aot_cache=AotCache())
    with eng:
        t0 = time.perf_counter()
        for lo in range(0, n, RAG_PAGED_CHUNK):
            eng.submit(gids[lo:lo + RAG_PAGED_CHUNK], preds[lo:lo + RAG_PAGED_CHUNK], target[lo:lo + RAG_PAGED_CHUNK])
        eng.flush()
        ingest_s = time.perf_counter() - t0
        check(eng.aggregate_path()[0] == "device", "20(d): the paged aggregate did not take the device sweep")
        blocks0 = eng.stats.ragged_summary()["agg_blocks"]
        k1, k4 = fold_rows_cuda.launches, segment_reduce_cuda.launches
        t0 = time.perf_counter()
        value = float(eng.aggregate())
        first_ms = (time.perf_counter() - t0) * 1e3
        blocks = eng.stats.ragged_summary()["agg_blocks"] - blocks0
        k1_first, k4_first = fold_rows_cuda.launches - k1, segment_reduce_cuda.launches - k4
        sweep_ms = rag_timed(lambda: float(eng.aggregate()), runs=3)
        st = eng.stats
        paging = {"routed_steps": st.routed_steps, "page_outs": st.page_outs, "page_ins": st.page_ins,
                  "spilled_groups": st.spilled_streams}
    per_sweep = -(-touched // _AGG_BLOCK_ROWS)
    check(blocks == per_sweep, f"20(d): the sweep ran {blocks} blocks for {touched} touched groups, not {per_sweep}")
    check(k4_first == blocks and k1_first == blocks + 3, f"20(d): {k4_first} K4 and {k1_first} K1 launches a sweep")
    eager = rag_eager(dev, lambda d: mp.RetrievalMAP(device=d), (preds, target, gids.astype(np.int64)))
    return {"rows": n, "touched_groups": touched, "blocks": blocks, "k4_per_sweep": k4_first,
            "k1_per_sweep": k1_first, "ingest_s": ingest_s, "ingest_rows_per_s": n / ingest_s,
            "first_sweep_ms": first_ms, "sweep_ms": sweep_ms, "value": value,
            "rel_err": rel_close(value, eager, "20(d): the paged aggregate vs the eager segment path"),
            "paging": paging}


def ragged_windows(dev, traffic, capacity, straight_state, straight_value):
    """20(e): tumbling and sliding rings, unsharded and ``group_shard``,
    against the oracle and the eager metric over the window's batches; a
    kill/resume mid-plan against the straight-through run; the refusals of
    a non-ragged snapshot and of a capacity mismatch."""
    import metrics_tpu_torch as mp
    from metrics_tpu_torch.engine import EngineConfig, RaggedEngine, StreamingEngine, WindowPolicy
    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

    def make(d):
        return mp.RetrievalMAP(device=d)

    out = {}
    head = traffic[:RAG_WINDOW_BATCHES]
    # the live window after 100 batches: the open pane [80, 100), or the two panes [40, 100)
    for kind, policy, live in (("tumbling", WindowPolicy.tumbling(pane_batches=RAG_PANE), head[2 * RAG_PANE:]),
                               ("sliding", WindowPolicy.sliding(n_panes=2, pane_batches=RAG_PANE), head[RAG_PANE:])):
        want = rag_eager(dev, make, rag_rows(live, binary_target))
        for shard in (False, True):
            kw = {"group_shard": True, "resident_groups": RAG_RESIDENT} if shard else {}
            eng = RaggedEngine(make(dev), num_groups=RAG_GROUPS, capacity=capacity,
                               config=EngineConfig(buckets=RAG_BUCKETS, window=policy), **kw)
            with eng:
                rag_serve(eng, head, binary_target)
                path = eng.aggregate_path()[0]
                value, oracle = float(eng.aggregate()), float(eng.aggregate(oracle=True))
                rotations = eng.rotations
            check(path == ("oracle" if (shard and kind == "sliding") else "device"), f"20(e) {kind}: path {path}")
            name = f"{kind}{'_group_shard' if shard else ''}"
            out[name] = {"path": path, "rotations": rotations, "value": value,
                         "rel_err": {"oracle": rel_close(value, oracle, f"20(e) {name} vs its oracle"),
                                     "eager": rel_close(value, want, f"20(e) {name} vs the eager window")}}
    snapdir = rag_dir("resume")
    cfg = EngineConfig(buckets=RAG_BUCKETS, snapshot_dir=snapdir)
    first = RaggedEngine(make(dev), num_groups=RAG_GROUPS, capacity=capacity, config=cfg)
    with first:
        rag_serve(first, traffic[:RAG_KILL], binary_target)
        first.snapshot()
    resumed = RaggedEngine(make(dev), num_groups=RAG_GROUPS, capacity=capacity, config=cfg)
    with resumed:
        meta = resumed.restore()
        rag_serve(resumed, traffic[RAG_KILL:], binary_target)
        state = {k: v.cpu() for k, v in resumed.state().items()}
        value = float(resumed.aggregate())
    for k in straight_state:
        check(torch.equal(state[k], straight_state[k]), f"20(e) resume: state {k} differs from straight through")
    check(value == straight_value, f"20(e) resume: {value} != straight-through {straight_value}")
    out["resume"] = {"cursor": int(meta.get("cursor", RAG_KILL)), "ragged_seq": int(meta["ragged_seq"]),
                     "value": value}
    refusals = {}
    plain_dir = rag_dir("plain")
    plain = StreamingEngine(mp.MeanMetric(device=dev), EngineConfig(buckets=(8,), snapshot_dir=plain_dir))
    with plain:
        plain.submit(np.ones(4, np.float32))
        plain.flush()
        plain.snapshot()
    for name, snap, cap in (("non_ragged", plain_dir, capacity), ("capacity", snapdir, 2 * capacity)):
        eng = RaggedEngine(make(dev), num_groups=RAG_GROUPS, capacity=cap,
                           config=EngineConfig(buckets=RAG_BUCKETS, snapshot_dir=snap))
        with eng:
            try:
                eng.restore()
                refusals[name] = None
            except MetricsTPUUserError as e:
                refusals[name] = str(e)[:80]
    check(refusals["non_ragged"] and "not written by a ragged" in refusals["non_ragged"], "20(e): non-ragged restore")
    check(refusals["capacity"] and f"capacity={capacity}" in refusals["capacity"], "20(e): capacity mismatch")
    out["refusals"] = refusals
    return out


def ragged_phase(dev):
    """Phase 20: retrieval and ragged serving (module docstring)."""
    import metrics_tpu_torch as mp
    from metrics_tpu_torch.functional import retrieval_average_precision, retrieval_normalized_dcg

    def group_value(fn):
        def one(rows, g):
            sel = rows[2] == g
            if not sel.any():
                return 0.0
            return float(fn(torch.from_numpy(rows[0][sel]), torch.from_numpy(rows[1][sel])))
        return one

    traffic, capacity, touched = ragged_traffic()
    out = {"groups_touched": touched}
    try:
        out["zipf_map"], state, value = ragged_zipf(
            dev, traffic, capacity, lambda d: mp.RetrievalMAP(device=d),
            group_value(lambda p, t: retrieval_average_precision(p, t.long())), binary_target, "20(a)")
        out["zipf_ndcg"], _, _ = ragged_zipf(
            dev, traffic, capacity, lambda d: mp.RetrievalNormalizedDCG(k=RAG_NDCG_K, device=d),
            group_value(lambda p, t: retrieval_normalized_dcg(p, t, k=RAG_NDCG_K)), graded_target, "20(b)")
        out["series"] = ragged_series(dev)
        out["paging"] = ragged_paging(dev)
        out["windows"] = ragged_windows(dev, traffic, capacity, state, value)
        return out
    finally:
        shutil.rmtree(RAG_DIR, ignore_errors=True)


def ragged_kernel_entries(dev, rng):
    """20(f): K1 at the aggregate's ``()`` <- ``(G,)`` folds for G in {512,
    10^5, 10^6} and K4 at the paged sweep's ``(10^6, 3)`` <- 1024 rows, each
    against its plain version and its library call (``torch.sum`` of the
    masked vector, ``Tensor.index_add`` of the masked rows), on 0/1 data so
    all three agree exactly."""
    from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda, fold_rows_plain
    from metrics_tpu_torch.ops.kernels.segment_cuda import segment_reduce_cuda, segment_reduce_plain

    entries = []
    for g in (512, 100_000, RAG_PAGED_GROUPS):
        rows = torch.from_numpy(rng.randint(0, 2, (g, 1)).astype(np.float32)).to(dev)
        m = torch.from_numpy((rng.rand(g) > 0.3).astype(np.int32)).to(dev)
        state = torch.zeros((1,), dtype=torch.float32, device=dev)
        masked = rows[:, 0] * m.float()
        got = fold_rows_cuda(state, rows, m, "sum")
        err = max_abs_err(got, fold_rows_plain(state, rows, m, "sum"))
        check(err == 0.0, f"K1 ({g},): kernel disagrees with its plain version")
        check(max_abs_err(got[0], torch.sum(masked)) == 0.0, f"K1 ({g},): kernel disagrees with torch.sum")
        live = int(m.sum())
        entry = {"name": "fold_rows", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/fold.cu",
                 "replaces": "metrics_tpu/ops/kernels/pallas_fold.py:48", "max_abs_err": err,
                 "max_abs_err_bf16": None, "shape": f"state (), rows ({g},) f32, sum (the ragged aggregate's fold)",
                 "ms": gpu_ms(lambda: fold_rows_cuda(state, rows, m, "sum")),
                 "plain_ms": gpu_ms(lambda: fold_rows_plain(state, rows, m, "sum")),
                 "library_ms": gpu_ms(lambda: torch.sum(masked)),
                 "device_us": device_us(lambda: fold_rows_cuda(state, rows, m, "sum"))}
        entry["bound_ms"], entry["bound_by"] = bound_ms(4 * live + 4 * g + 2 * 4, live)
        entries.append(entry)
    g, n, f = RAG_PAGED_GROUPS, 1024, 3
    acc = torch.from_numpy(rng.randint(0, 2, (g, f)).astype(np.float32)).to(dev)
    cols = torch.from_numpy(rng.randint(0, 2, (n, f)).astype(np.float32)).to(dev)
    m = torch.from_numpy((rng.rand(n) > 0.2).astype(np.int32)).to(dev)
    ids = torch.from_numpy(rng.choice(g, n, replace=False).astype(np.int32)).to(dev)  # one row per touched group
    masked_cols, ids64 = cols * m[:, None].float(), ids.long()
    got = segment_reduce_cuda(acc, cols, m, ids, "sum")
    err = max_abs_err(got, segment_reduce_plain(acc, cols, m, ids, g, "sum"))
    check(err == 0.0, "K4 (10^6, 3): kernel disagrees with its plain version")
    check(max_abs_err(got, acc.index_add(0, ids64, masked_cols)) == 0.0, "K4 (10^6, 3): kernel disagrees with index_add")
    live = int(m.sum())
    entry = {"name": "segment_reduce", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/segment.cu",
             "replaces": "metrics_tpu/ops/kernels/pallas_segment.py:57", "max_abs_err": err, "max_abs_err_bf16": None,
             "shape": f"state ({g}, {f}), rows ({n}, {f}) f32, sum (the paged aggregate sweep's block)",
             "traffic": "one row per touched group",
             "ms": gpu_ms(lambda: segment_reduce_cuda(acc, cols, m, ids, "sum")),
             "plain_ms": gpu_ms(lambda: segment_reduce_plain(acc, cols, m, ids, g, "sum")),
             "library_ms": gpu_ms(lambda: acc.index_add(0, ids64, masked_cols)),
             "device_us": device_us(lambda: segment_reduce_cuda(acc, cols, m, ids, "sum"))}
    # unmasked rows, the mask and the ids read once; the state read and written once
    entry["bound_ms"], entry["bound_by"] = bound_ms(4 * live * f + 8 * n + 2 * 4 * g * f, live * f)
    entries.append(entry)
    return entries


# --------------------------------------------------------------------------- phase 21: text

TEXT_PAIRS = 2000  # a WMT newstest set's size
TEXT_VOCAB = 5000
TEXT_ZIPF = 1.1
TEXT_EDIT = 0.15  # share of words substituted, dropped or followed by an inserted word
TEXT_WORDS = (5, 60)
TEXT_BATCH = 64
TEXT_CPU_PAIRS = 500  # 21(a): the prefix the CPU twin takes
TEXT_TER_PAIRS = 200
TEXT_BEAM = 25  # TER's beam width
BERT_MAX_LENGTH = 128
BERT_BATCH = 64
BERT_CPU_PAIRS = 8
# the published bert-base-uncased config
BERT_BASE = {"vocab": 30522, "hidden": 768, "layers": 12, "heads": 12, "ffn": 3072, "positions": 512,
             "token_types": 2, "eps": 1e-12}


def text_corpus(seed=SEED + 21):
    """2 000 seeded MT pairs: references of 5-60 words drawn from a Zipf(1.1)
    vocabulary of 5 000 words (some carrying punctuation, digits or an
    apostrophe, so the tokenizers differ), hypotheses with about 15 % of the
    words edited."""
    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = []
    while len(vocab) < TEXT_VOCAB:
        w = "".join(letters[rng.randint(0, 26, int(rng.randint(2, 10)))])
        r = rng.rand()
        w = w + "," if r < 0.06 else w + "." if r < 0.1 else w + "'s" if r < 0.12 else \
            str(rng.randint(0, 1000)) if r < 0.14 else w.capitalize() if r < 0.2 else w
        if w not in vocab:
            vocab.append(w)
    p = 1.0 / np.arange(1, TEXT_VOCAB + 1) ** TEXT_ZIPF
    p /= p.sum()
    hyps, refs = [], []
    for _ in range(TEXT_PAIRS):
        ref = [vocab[i] for i in rng.choice(TEXT_VOCAB, int(rng.randint(TEXT_WORDS[0], TEXT_WORDS[1] + 1)), p=p)]
        hyp = []
        for w in ref:
            if rng.rand() >= TEXT_EDIT:
                hyp.append(w)
                continue
            op = rng.randint(3)
            if op == 0:
                hyp.append(vocab[rng.choice(TEXT_VOCAB, p=p)])
            elif op == 2:
                hyp += [w, vocab[rng.choice(TEXT_VOCAB, p=p)]]
        hyps.append(" ".join(hyp))
        refs.append(" ".join(ref))
    return hyps, refs


def squad_corpus(hyps, refs, seed=SEED + 22):
    """2 000 SQuAD pairs from the corpus: 1-3 answers, each a 1-5 word span
    of the reference, and a prediction that is the first answer (40 %), a
    span of the hypothesis, or a shifted span."""
    rng = np.random.RandomState(seed)
    preds, targets = [], []
    for i, (h, r) in enumerate(zip(hyps, refs)):
        words, hw = r.split(), h.split() or ["x"]
        answers = []
        for _ in range(int(rng.randint(1, 4))):
            a = int(rng.randint(0, len(words)))
            answers.append(" ".join(words[a:a + int(rng.randint(1, 6))]))
        u = rng.rand()
        if u < 0.4:
            pred = answers[0]
        else:
            a = int(rng.randint(0, len(hw)))
            pred = " ".join(hw[a:a + int(rng.randint(1, 6))])
        preds.append({"prediction_text": pred, "id": f"q{i}"})
        targets.append({"answers": {"text": answers, "answer_start": [0] * len(answers)}, "id": f"q{i}"})
    return preds, targets


def text_collection(device):
    import metrics_tpu_torch as mp
    from metrics_tpu_torch.utils.imports import _NLTK_AVAILABLE

    return mp.MetricCollection({
        "wer": mp.WordErrorRate(device=device), "cer": mp.CharErrorRate(device=device),
        "mer": mp.MatchErrorRate(device=device), "wil": mp.WordInfoLost(device=device),
        "wip": mp.WordInfoPreserved(device=device), "bleu": mp.BLEUScore(n_gram=4, device=device),
        "sacre_bleu": mp.SacreBLEUScore(tokenize="13a", device=device),
        "chrf": mp.CHRFScore(n_word_order=2, device=device),
        "rouge": mp.ROUGEScore(rouge_keys=("rouge1", "rouge2", "rougeL", "rougeLsum"),
                               use_stemmer=_NLTK_AVAILABLE, device=device),
    })


def text_batches(lo, hi, batch=TEXT_BATCH):
    return [(i, min(i + batch, hi)) for i in range(lo, hi, batch)]


def text_update(members, a, b, spans, host_s):
    """Each member updated over ``spans`` of ``(a, b)``; host seconds per member added to ``host_s``."""
    for lo, hi in spans:
        for name, m in members.items():
            t0 = time.perf_counter()
            m.update(a[lo:hi], b[lo:hi])
            host_s[name] = host_s.get(name, 0.0) + time.perf_counter() - t0


def text_state(members):
    return {k: {s: ([t.detach().cpu() for t in v] if isinstance(v, list) else v.detach().cpu())
                for s, v in m._pack_state().items()} for k, m in members.items()}


def same_text_states(got, want, what):
    """Every leaf bit-equal, of one dtype, list states element by element."""
    for name, st in want.items():
        for k, w in st.items():
            g = got[name][k]
            pairs = list(zip(g, w)) if isinstance(w, list) else [(g, w)]
            check(not isinstance(w, list) or len(g) == len(w), f"{what}: {name}.{k} list length")
            for a, b in pairs:
                check(a.dtype == b.dtype and torch.equal(a, b), f"{what}: {name}.{k} differs")


def text_values_close(got, want, what, tol=1e-6):
    def flat(v):
        if isinstance(v, dict):
            return torch.cat([flat(v[k]).reshape(-1) for k in sorted(v)])
        if isinstance(v, (tuple, list)):
            return torch.cat([flat(x).reshape(-1) for x in v])
        return v.detach().double().cpu().reshape(-1)

    e = max_abs_err(flat(got), flat(want))
    check(e <= tol, f"{what}: values differ by {e}")
    return e


def text_corpus_phase(dev, hyps, refs):
    """21(a): the collection, SQuAD and TER on the card against CPU twins."""
    import metrics_tpu_torch as mp

    t_start = time.perf_counter()
    coll, twin = text_collection(dev), text_collection(torch.device("cpu"))
    members = dict(coll.items(keep_base=True))
    twin_members = dict(twin.items(keep_base=True))
    squad_p, squad_t = squad_corpus(hyps, refs)
    squad, squad_twin = mp.SQuAD(device=dev), mp.SQuAD(device="cpu")
    ter, ter_twin = mp.TranslationEditRate(device=dev), mp.TranslationEditRate(device="cpu")
    host_s, twin_s = {}, {}
    # the first 500 pairs on both; the card's states then, held against the twin's
    head = text_batches(0, TEXT_CPU_PAIRS)
    text_update(members, hyps, refs, head, host_s)
    text_update({"squad": squad}, squad_p, squad_t, head, host_s)
    text_update(twin_members, hyps, refs, head, twin_s)
    text_update({"squad": squad_twin}, squad_p, squad_t, head, twin_s)
    card_state = text_state({**members, "squad": squad})
    cpu_state = text_state({**twin_members, "squad": squad_twin})
    same_text_states(card_state, cpu_state, "21(a) card vs CPU at 500 pairs")
    for k, m in members.items():
        check(all(t.device.type == "cuda" for t in state_leaves(m._pack_state())), f"21(a): {k} state off the card")
    err_500 = text_values_close({**coll.compute(), "squad": squad.compute()},
                                {**twin.compute(), "squad": squad_twin.compute()}, "21(a) values at 500 pairs")
    # the rest of the corpus on the card
    tail = text_batches(TEXT_CPU_PAIRS, TEXT_PAIRS)
    text_update(members, hyps, refs, tail, host_s)
    text_update({"squad": squad}, squad_p, squad_t, tail, host_s)
    values = text_flat({**coll.compute(), "squad": squad.compute()})
    # TER on the first 200 pairs, card and CPU
    ter_spans = text_batches(0, TEXT_TER_PAIRS)
    text_update({"ter": ter}, hyps, refs, ter_spans, host_s)
    text_update({"ter": ter_twin}, hyps, refs, ter_spans, twin_s)
    same_text_states(text_state({"ter": ter}), text_state({"ter": ter_twin}), "21(a) TER card vs CPU")
    values["ter"] = ter.compute()
    check(float(values["ter"]) == float(ter_twin.compute()), "21(a): TER value card vs CPU")
    for k, v in values.items():
        check(torch.isfinite(v).all() and v.device.type == "cuda", f"21(a): {k} not finite on the card")
    n_updates = {k: len(text_batches(0, TEXT_PAIRS)) for k in host_s}
    n_updates["ter"] = len(ter_spans)
    return {
        "pairs": TEXT_PAIRS, "words": int(sum(len(r.split()) for r in refs)),
        "hyp_words": int(sum(len(h.split()) for h in hyps)), "batch": TEXT_BATCH,
        "host_ms_per_update": {k: s / n_updates[k] * 1e3 for k, s in sorted(host_s.items())},
        "cpu_twin_host_ms_per_update": {k: s / (len(ter_spans) if k == "ter" else len(head)) * 1e3
                                        for k, s in sorted(twin_s.items())},
        "values": {k: (float(v) if v.numel() == 1 else [float(x) for x in v]) for k, v in sorted(values.items())},
        "max_err_vs_cpu_at_500": err_500, "states_bit_equal_at_500": True,
        "seconds": time.perf_counter() - t_start,
    }


def text_flat(values, prefix=""):
    """A collection's value tree as ``{"rouge.rouge1_fmeasure": tensor, ...}``."""
    out = {}
    for k, v in values.items():
        if isinstance(v, dict):
            out.update(text_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def state_leaves(state):
    """The tensors of a state dict (list states' elements included)."""
    out = []
    for v in state.values():
        out += list(v) if isinstance(v, list) else [v]
    return out


def native_phase(hyps, refs):
    """21(b): the edit-distance library against its plain Python DPs."""
    from metrics_tpu_torch.functional.text import helper
    from metrics_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    helper.native_library()
    load_s = time.perf_counter() - t0
    path = helper.native_library_path()
    check(path.parent == build.BUILD_DIR and "metrics_tpu/native" not in path.as_posix(),
          f"21(b): the library {path} is not the port's build")
    a, b = [h.split() for h in hyps], [r.split() for r in refs]
    t0 = time.perf_counter()
    native = helper._edit_distance_batch(a, b)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = [helper._edit_distance_py(x, y) for x, y in zip(a, b)]
    plain_s = time.perf_counter() - t0
    check(native.tolist() == plain, "21(b): batch distances differ from the plain DP")
    ids = [helper._tokens_to_ids([x], [y]) for x, y in zip(a, b)]
    t0 = time.perf_counter()
    beam = [helper._edit_distance_ids(x, y, beam=TEXT_BEAM) for x, _, y, _ in ids]
    beam_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    beam_plain = [helper._edit_distance_beam_py(list(x), list(y), TEXT_BEAM) for x, _, y, _ in ids]
    beam_plain_s = time.perf_counter() - t0
    check(beam == beam_plain, "21(b): beam distances differ from the plain beam DP")
    return {
        "library": str(path.relative_to(build.BUILD_DIR.parents[1])), "build_s": build.last_host_build_seconds,
        "first_use_s": load_s, "pairs": len(a), "edits": int(native.sum()),
        "native_pairs_per_s": len(a) / native_s, "plain_pairs_per_s": len(a) / plain_s,
        "native_beam_pairs_per_s": len(a) / beam_s, "plain_beam_pairs_per_s": len(a) / beam_plain_s,
    }


class BertBase(torch.nn.Module):
    """BERT-base at its published width as a caller writes it in plain torch:
    post-LN, GELU, HF ``BertModel``'s parameter names, ``(ids, mask)`` in and
    the last hidden state out."""

    def __init__(self, cfg):
        super().__init__()
        nn = torch.nn
        h, f = cfg["hidden"], cfg["ffn"]
        self.cfg = cfg

        def ln():
            return nn.LayerNorm(h, eps=cfg["eps"])

        self.embeddings = nn.ModuleDict({
            "word_embeddings": nn.Embedding(cfg["vocab"], h), "position_embeddings": nn.Embedding(cfg["positions"], h),
            "token_type_embeddings": nn.Embedding(cfg["token_types"], h), "LayerNorm": ln()})
        self.encoder = nn.ModuleDict({"layer": nn.ModuleList([nn.ModuleDict({
            "attention": nn.ModuleDict({
                "self": nn.ModuleDict({"query": nn.Linear(h, h), "key": nn.Linear(h, h), "value": nn.Linear(h, h)}),
                "output": nn.ModuleDict({"dense": nn.Linear(h, h), "LayerNorm": ln()})}),
            "intermediate": nn.ModuleDict({"dense": nn.Linear(h, f)}),
            "output": nn.ModuleDict({"dense": nn.Linear(f, h), "LayerNorm": ln()}),
        }) for _ in range(cfg["layers"])])})
        self.pooler = nn.ModuleDict({"dense": nn.Linear(h, h)})

    def forward(self, ids, mask):
        e, heads = self.embeddings, self.cfg["heads"]
        n, length = ids.shape
        x = e["word_embeddings"](ids.long()) + e["position_embeddings"].weight[:length] \
            + e["token_type_embeddings"].weight[0]
        x = e["LayerNorm"](x)
        bias = (1.0 - mask[:, None, None, :].to(x.dtype)) * torch.finfo(x.dtype).min
        for layer in self.encoder["layer"]:
            att = layer["attention"]["self"]
            q, k, v = (att[name](x).view(n, length, heads, -1).transpose(1, 2) for name in ("query", "key", "value"))
            probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]) + bias, dim=-1)
            ctx = (probs @ v).transpose(1, 2).reshape(n, length, -1)
            out = layer["attention"]["output"]
            x = out["LayerNorm"](out["dense"](ctx) + x)
            inter = torch.nn.functional.gelu(layer["intermediate"]["dense"](x))
            out = layer["output"]
            x = out["LayerNorm"](out["dense"](inter) + x)
        return x


def bert_flax_params(cfg, seed=SEED + 23):
    """Seeded numpy weights in the Flax BERT layout (kernels (in, out),
    ``embedding``, LayerNorm ``scale``): the tree the JAX package scores with."""
    rng = np.random.default_rng(seed)
    h, f = cfg["hidden"], cfg["ffn"]

    def normal(*shape, std=0.02):
        return (rng.standard_normal(shape, dtype=np.float32) * std).astype(np.float32)

    def dense(i, o):
        return {"kernel": normal(i, o), "bias": normal(o)}

    def norm():
        return {"scale": 1.0 + normal(h), "bias": normal(h)}

    layers = {str(i): {
        "attention": {"self": {"query": dense(h, h), "key": dense(h, h), "value": dense(h, h)},
                      "output": {"dense": dense(h, h), "LayerNorm": norm()}},
        "intermediate": {"dense": dense(h, f)},
        "output": {"dense": dense(f, h), "LayerNorm": norm()},
    } for i in range(cfg["layers"])}
    return {
        "embeddings": {"word_embeddings": {"embedding": normal(cfg["vocab"], h)},
                       "position_embeddings": {"embedding": normal(cfg["positions"], h)},
                       "token_type_embeddings": {"embedding": normal(cfg["token_types"], h)},
                       "LayerNorm": norm()},
        "encoder": {"layer": layers},
        "pooler": {"dense": dense(h, h)},
    }


class TimedEncoder:
    """The caller's encoder with its batches counted and timed (synchronised),
    keeping each batch's ids, mask and output when ``keep``."""

    def __init__(self, model, dev, keep=False):
        self.model, self.dev, self.keep = model, dev, keep
        self.calls, self.seconds, self.kept = 0, 0.0, []

    def __call__(self, ids, mask):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        t0 = time.perf_counter()
        out = self.model(ids, mask)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        if self.keep:
            self.kept.append((ids.cpu().numpy(), mask.cpu().numpy(), out))
        return out


def bert_phase(dev, hyps, refs):
    """21(c): BERTScore at BERT-base width through ``bert_score``."""
    from metrics_tpu_torch.functional import bert_score
    from metrics_tpu_torch.functional.text import bert as fbert

    check(not torch.backends.cuda.matmul.allow_tf32, "21(c): TF32 matmuls must be off")
    t0 = time.perf_counter()
    params = bert_flax_params(BERT_BASE)
    state = fbert.bert_state_dict_from_flax(params)
    encoder = BertBase(BERT_BASE).eval()
    encoder.load_state_dict(state, strict=True)
    cpu_encoder = encoder
    card_encoder = BertBase(BERT_BASE).eval().to(dev)
    card_encoder.load_state_dict(state, strict=True)
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in encoder.parameters())

    runs = {}
    for idf in (False, True):
        timed = TimedEncoder(card_encoder, dev, keep=not idf)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = bert_score(hyps, refs, model=timed, idf=idf, max_length=BERT_MAX_LENGTH, batch_size=BERT_BATCH,
                         device=dev)
        total_s = time.perf_counter() - t0
        for k in ("precision", "recall", "f1"):
            check(len(out[k]) == len(hyps) and np.isfinite(out[k]).all(), f"21(c): {k} not finite (idf={idf})")
        runs[idf] = (out, timed, total_s)
    uniq = list(dict.fromkeys(list(hyps) + list(refs)))
    t0 = time.perf_counter()
    fbert._simple_whitespace_tokenizer(uniq, BERT_MAX_LENGTH)
    tokenize_s = time.perf_counter() - t0

    # the matching of the card's embeddings, on the card and on the CPU
    out, timed, _ = runs[False]
    tok_p = fbert._simple_whitespace_tokenizer(hyps, BERT_MAX_LENGTH)
    tok_t = fbert._simple_whitespace_tokenizer(refs, BERT_MAX_LENGTH)
    rows, pos = {}, 0  # each encoded row's position among the encoder's outputs
    for ids, mask, _ in timed.kept:
        for i in range(ids.shape[0]):
            rows.setdefault((ids[i].tobytes(), mask[i].tobytes()), pos)
            pos += 1
    inverse = np.asarray([rows[(i.tobytes(), m.tobytes())] for tok in (tok_p, tok_t)
                          for i, m in zip(tok["input_ids"], tok["attention_mask"])], np.int64)
    embs = [e for _, _, e in timed.kept]
    card_args = (embs, torch.from_numpy(inverse).to(dev), torch.from_numpy(tok_p["attention_mask"]).to(dev),
                 torch.from_numpy(tok_t["attention_mask"]).to(dev), None, None)
    match_ms = gpu_ms(lambda: fbert._score_embeddings(*card_args), runs=5)
    card_prf = fbert._score_embeddings(*card_args).cpu()
    cpu_args = ([e.cpu() for e in embs], *(a.cpu() if isinstance(a, torch.Tensor) else a for a in card_args[1:]))
    t0 = time.perf_counter()
    cpu_prf = fbert._score_embeddings(*cpu_args)
    cpu_match_s = time.perf_counter() - t0
    match_err = max_abs_err(card_prf, cpu_prf)
    check(match_err <= 1e-5, f"21(c): matching card vs CPU err {match_err}")
    functional_err = max_abs_err(card_prf, torch.tensor([out["precision"], out["recall"], out["f1"]]))
    check(functional_err == 0.0, f"21(c): bert_score differs from its own matching by {functional_err}")
    embs = cpu_args = card_args = None
    timed.kept = []

    # the first 8 pairs on the CPU, the same encoder and weights
    t0 = time.perf_counter()
    cpu_out = bert_score(hyps[:BERT_CPU_PAIRS], refs[:BERT_CPU_PAIRS], model=cpu_encoder,
                         max_length=BERT_MAX_LENGTH, batch_size=BERT_BATCH, device="cpu")
    cpu_s = time.perf_counter() - t0
    cpu_err = max(abs(a - b) for k in ("precision", "recall", "f1")
                  for a, b in zip(out[k][:BERT_CPU_PAIRS], cpu_out[k]))
    check(cpu_err <= 1e-4, f"21(c): the first {BERT_CPU_PAIRS} pairs card vs CPU err {cpu_err}")

    summary = {}
    for idf, (o, t, total_s) in runs.items():
        summary["idf" if idf else "plain"] = {
            "encoder_batches": t.calls, "encoder_ms": t.seconds * 1e3, "total_ms": total_s * 1e3,
            "mean_f1": float(np.mean(o["f1"])), "mean_precision": float(np.mean(o["precision"])),
            "mean_recall": float(np.mean(o["recall"])),
        }
    return {
        "config": {**BERT_BASE, "max_length": BERT_MAX_LENGTH, "batch_size": BERT_BATCH, "params": n_params,
                   "tf32": bool(torch.backends.cuda.matmul.allow_tf32)},
        "runs": summary, "tokenize_ms": tokenize_s * 1e3, "matching_ms": match_ms,
        "cpu_matching_ms": cpu_match_s * 1e3, "matching_err_card_vs_cpu": match_err,
        "first_pairs_err_card_vs_cpu": cpu_err, "cpu_first_pairs_ms": cpu_s * 1e3, "setup_s": setup_s,
        "encoded_rows": pos, "distinct_rows": len(rows),
    }


def text_phase(dev):
    """Phase 21: the text domain on the card (module docstring)."""
    t0 = time.perf_counter()
    hyps, refs = text_corpus()
    corpus_s = time.perf_counter() - t0
    out = {"corpus_build_s": corpus_s}
    out["native"] = native_phase(hyps, refs)
    out["corpus"] = text_corpus_phase(dev, hyps, refs)
    out["bert"] = bert_phase(dev, hyps, refs)
    return out


# --------------------------------------------------------------------------- phase 22: audio and images

SIG_MIXTURES = 512  # WSJ0-2mix's evaluation form: 2 speakers, 8 kHz, 4-second clips
SIG_FS = 8000
SIG_SECONDS = 4
SIG_BATCH = 16  # 32 updates of 16 mixtures
SIG_CPU_MIXTURES = 64  # 22(a): the prefix the CPU twin takes
SIG_FILTER = 512
SIG_PIN_MIXTURES = 16  # 22(c)
# K8's float64 recursion: the H100 SXM's FP64 rate outside the tensor cores (NVIDIA's data sheet). Its dot
# products and element updates are vector work with no matrix product, so the tensor cores' 67 TFLOP/s
# (DMMA), the card's FP64 peak, would halve a bound that no form of the recursion can reach
FP64_OPS_PER_S = 34e12
SIG_LONG_FILTER = 8192  # 22(e): past the 6144 whose vectors fit in shared memory: K8's global-scratch form
SIG_LONG_MIXTURES = 4  # 22(e): mixtures through SDR at that length, card and CPU (8 systems)
IMG_COUNT = 50  # DIV2K's validation set has 100 images: half of them
IMG_SHAPE = (3, 1356, 2040)
IMG_BATCH = 10
IMG_CPU = 2  # 22(b), (c): the images the CPU twin and the precision pin take
SIG_DB_TOL = 1e-3  # SNR, SI-SNR, SI-SDR per signal, card vs CPU (dB)
SIG_SDR_TOL = 1e-2  # SDR, as JAX's own test holds it to the reference (dB)
SIG_STOI_TOL = 1e-4
# SSIM's mean over 2 DIV2K-sized images in f32: E[x^2] - mu^2 cancels, and each device's f32 result lies
# ~2e-5 from the same arithmetic in float64, on either side (measured on an H100: card -1.6e-5, CPU +2.0e-5);
# each is held to float64 within IMG_SSIM_F64_TOL, card vs CPU within their sum. PSNR and MS-SSIM within 1e-5.
IMG_SSIM_F64_TOL = 5e-5
IMG_SSIM_CPU_TOL = 1e-4


def speech_mixtures(dev, seed=SEED + 22):
    """``(preds, target, swapped)`` for phase 22(a): ``(SIG_MIXTURES, 2, n)``
    f32 on ``dev``. Each source is white noise shaped by three formant bumps
    (centres drawn around 500, 1500 and 2500 Hz) under a syllable-rate
    envelope (3-6 Hz), with one 0.8-second stretch (a fifth) silent; each
    estimate is its source plus 10-20 % of the other speaker plus white
    noise at 5-25 dB. The estimates' speaker order is swapped where
    ``swapped`` (half the mixtures)."""
    n = SIG_FS * SIG_SECONDS
    rng = np.random.default_rng(seed)
    shape = (SIG_MIXTURES, 2)
    noise = torch.from_numpy(rng.standard_normal(shape + (n,), dtype=np.float32)).to(dev)
    centres = torch.from_numpy(np.array([500.0, 1500.0, 2500.0]) * rng.uniform(0.8, 1.2, shape + (3,))).to(dev)
    f = torch.fft.rfftfreq(n, 1.0 / SIG_FS, device=dev, dtype=torch.float64)
    gain = torch.exp(-0.5 * ((f[None, None, None] - centres[..., None]) / 150.0) ** 2).sum(2) + 0.02
    x = torch.fft.irfft(torch.fft.rfft(noise.double(), dim=-1) * gain, n=n, dim=-1)
    t = torch.arange(n, device=dev, dtype=torch.float64) / SIG_FS
    rate = torch.from_numpy(rng.uniform(3.0, 6.0, shape + (1,))).to(dev)
    phase = torch.from_numpy(rng.uniform(0.0, np.pi, shape + (1,))).to(dev)
    env = torch.abs(torch.sin(np.pi * rate * t + phase)) ** 1.5
    start = torch.from_numpy(rng.integers(0, n - n // 5, shape + (1,))).to(dev)
    env = torch.where((t * SIG_FS >= start) & (t * SIG_FS < start + n // 5), 0.0, env)
    src = x * env
    src = (src / src.abs().amax(-1, keepdim=True)).float()
    leak = torch.from_numpy(rng.uniform(0.10, 0.20, shape + (1,)).astype(np.float32)).to(dev)
    snr_db = torch.from_numpy(rng.uniform(5.0, 25.0, shape + (1,)).astype(np.float32)).to(dev)
    white = torch.from_numpy(rng.standard_normal(shape + (n,), dtype=np.float32)).to(dev)
    power = src.pow(2).mean(-1, keepdim=True)
    est = src + leak * src.flip(1) + white * torch.sqrt(power / 10 ** (snr_db / 10))
    swapped = torch.from_numpy(rng.permutation(SIG_MIXTURES) < SIG_MIXTURES // 2).to(dev)
    est = torch.where(swapped[:, None, None], est.flip(1), est)
    return est.contiguous(), src.contiguous(), swapped


def signal_collection(device):
    import metrics_tpu_torch as mp
    from metrics_tpu_torch.functional import scale_invariant_signal_noise_ratio, signal_distortion_ratio

    return mp.MetricCollection({
        "snr": mp.SignalNoiseRatio(device=device),
        "si_snr": mp.ScaleInvariantSignalNoiseRatio(device=device),
        "si_sdr": mp.ScaleInvariantSignalDistortionRatio(device=device),
        "sdr": mp.SignalDistortionRatio(filter_length=SIG_FILTER, device=device),
        "pit_si_snr": mp.PermutationInvariantTraining(scale_invariant_signal_noise_ratio, device=device),
        "pit_sdr": mp.PermutationInvariantTraining(signal_distortion_ratio, filter_length=SIG_FILTER, device=device),
        "stoi": mp.STOI(SIG_FS, device=device),
        "estoi": mp.STOI(SIG_FS, extended=True, device=device),
    })


def signal_per_signal(p, t):
    """Every per-signal score of 22(a)'s members on ``(p, t)``, by name."""
    from metrics_tpu_torch import functional as F_

    out = {"snr": F_.signal_noise_ratio(p, t), "si_snr": F_.scale_invariant_signal_noise_ratio(p, t),
           "si_sdr": F_.scale_invariant_signal_distortion_ratio(p, t),
           "sdr": F_.signal_distortion_ratio(p, t, filter_length=SIG_FILTER),
           "stoi": F_.stoi(p, t, SIG_FS), "estoi": F_.stoi(p, t, SIG_FS, extended=True)}
    out["pit_si_snr"], out["perm_si_snr"] = F_.pit(p, t, F_.scale_invariant_signal_noise_ratio)
    out["pit_sdr"], out["perm_sdr"] = F_.pit(p, t, F_.signal_distortion_ratio, filter_length=SIG_FILTER)
    return out


SIG_TOLS = {"snr": SIG_DB_TOL, "si_snr": SIG_DB_TOL, "si_sdr": SIG_DB_TOL, "pit_si_snr": SIG_DB_TOL,
            "sdr": SIG_SDR_TOL, "pit_sdr": SIG_SDR_TOL, "stoi": SIG_STOI_TOL, "estoi": SIG_STOI_TOL}


def signal_speech(dev):
    """22(a): the speech-separation collection over 512 mixtures, its CPU twin
    over the first 64, per-signal scores, PIT's permutations, the forward
    (every member captured, SDR's solve by K8), then K8 against its plain
    version and PyTorch's LU."""
    from metrics_tpu_torch.metric import forward_entry_kinds, keep_forward_eager
    from metrics_tpu_torch.ops.kernels.toeplitz_cuda import toeplitz_solve_cuda

    toeplitz_solve_cuda.launches = 0
    t0 = time.perf_counter()
    preds, target, swapped = speech_mixtures(dev)
    torch.cuda.synchronize()
    out = {"data_s": time.perf_counter() - t0, "mixtures": SIG_MIXTURES, "speakers": 2, "fs": SIG_FS,
           "samples": preds.shape[-1], "batch": SIG_BATCH, "filter_length": SIG_FILTER,
           "bytes_per_tensor": preds.numel() * 4}
    coll = signal_collection(dev)
    members = dict(coll.items(keep_base=True))
    host, device = {k: [] for k in members}, {k: [] for k in members}
    t0 = time.perf_counter()
    for lo in range(0, SIG_MIXTURES, SIG_BATCH):
        p, t = preds[lo:lo + SIG_BATCH], target[lo:lo + SIG_BATCH]
        for k, m in members.items():
            # an empty queue before each update: its host ms is its own enqueueing, never back-pressure
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            start.record()
            m.update(p, t)
            end.record()
            host[k].append((time.perf_counter() - h0) * 1e3)
            device[k].append((start, end))
    torch.cuda.synchronize()
    out["updates_s"] = time.perf_counter() - t0
    out["update_ms"] = {k: {"host_ms": float(np.median(host[k])),
                            "device_ms": float(np.median([s.elapsed_time(e) for s, e in device[k]]))}
                        for k in members}
    values = {k: float(v) for k, v in coll.compute().items()}
    for k, m in members.items():
        check(m.total.dtype == torch.int32 and int(m.total) == SIG_MIXTURES * (1 if k.startswith("pit") else 2),
              f"22(a): {k}.total {m.total}")
        check(math.isfinite(values[k]), f"22(a): {k} = {values[k]}")
    out["values"] = values

    # the CPU twin over the first 64 mixtures: totals bit-equal and int32, sums within the tolerances
    cpu = torch.device("cpu")
    head_p, head_t = preds[:SIG_CPU_MIXTURES].cpu(), target[:SIG_CPU_MIXTURES].cpu()
    card_head, twin = signal_collection(dev), signal_collection(cpu)
    t0 = time.perf_counter()
    for lo in range(0, SIG_CPU_MIXTURES, SIG_BATCH):
        card_head.update(preds[lo:lo + SIG_BATCH], target[lo:lo + SIG_BATCH])
        twin.update(head_p[lo:lo + SIG_BATCH], head_t[lo:lo + SIG_BATCH])
    out["cpu_twin_s"] = time.perf_counter() - t0
    got, want = card_head.compute(), twin.compute()
    for (k, m), (_, w) in zip(card_head.items(keep_base=True), twin.items(keep_base=True)):
        check(m.total.dtype == w.total.dtype == torch.int32 and torch.equal(m.total.cpu(), w.total),
              f"22(a): {k}.total card {m.total} vs CPU {w.total}")
        check(abs(float(got[k]) - float(want[k])) <= SIG_TOLS[k], f"22(a): {k} card {got[k]} vs CPU {want[k]}")
    # per signal, card vs CPU over the same 64 mixtures
    card_sig = signal_per_signal(preds[:SIG_CPU_MIXTURES], target[:SIG_CPU_MIXTURES])
    t0 = time.perf_counter()
    cpu_sig = signal_per_signal(head_p, head_t)
    out["cpu_per_signal_s"] = time.perf_counter() - t0
    errs = {}
    for k, tol in SIG_TOLS.items():
        errs[k] = max_abs_err(card_sig[k], cpu_sig[k])
        check(errs[k] <= tol, f"22(a): per-signal {k} card vs CPU err {errs[k]} > {tol}")
    for k in ("perm_si_snr", "perm_sdr"):
        check(torch.equal(card_sig[k].cpu(), cpu_sig[k]), f"22(a): PIT {k} card vs CPU")
    out["per_signal_max_abs_err"] = errs
    # PIT finds the swapped half, over all 512 mixtures
    from metrics_tpu_torch.functional import pit, scale_invariant_signal_noise_ratio

    found = pit(preds, target, scale_invariant_signal_noise_ratio)[1][:, 0] == 1
    check(torch.equal(found, swapped) and int(swapped.sum()) == SIG_MIXTURES // 2, "22(a): PIT missed a swap")
    out["pit_swaps_found"] = int(found.sum())

    # one forward of the collection, the compiled path (captured from the 2nd call of a signature) and eager,
    # three calls each: the 3rd is warm
    p, t = preds[:SIG_BATCH], target[:SIG_BATCH]
    fwd, eager = signal_collection(dev), keep_forward_eager(signal_collection(dev))
    vals, host = {}, {"compiled": [], "eager": []}
    for name, owner in (("compiled", fwd), ("eager", eager)):
        for _ in range(3):
            h0 = time.perf_counter()
            vals[name] = owner(p, t)
            torch.cuda.synchronize()
            host[name].append((time.perf_counter() - h0) * 1e3)
    for k, v in vals["eager"].items():
        check(abs(float(vals["compiled"][k]) - float(v)) <= SIG_TOLS[k],
              f"22(a): forward {k} compiled {vals['compiled'][k]} vs eager {v}")
    kinds = {}
    for k, m in signal_collection(dev).items(keep_base=True):
        for _ in range(2):
            m(p, t)
        kinds[k] = forward_entry_kinds(m)
    # SDR's (and PIT-over-SDR's) 512-wide solve is K8, which a graph captures: every member and the
    # collection's fused step take the compiled path
    want = {k: ["compiled"] for k in kinds}
    check(kinds == want, f"22(a): forward entry kinds {kinds}, expected {want}")
    check(forward_entry_kinds(fwd) == ["compiled"], f"22(a): the collection's fused step {forward_entry_kinds(fwd)}")
    out["forward"] = {"collection_kinds": forward_entry_kinds(fwd), "member_kinds": kinds,
                      "compiled_host_ms": host["compiled"], "eager_host_ms": host["eager"],
                      "warm_compiled_over_eager": host["compiled"][-1] / host["eager"][-1]}
    out["k8_launches"] = toeplitz_solve_cuda.launches
    check(out["k8_launches"] > 0, "22(a): K8 was not launched by the speech path")
    out["solve"] = signal_solve_timing(p, t, out["k8_launches"])
    return out, preds, target


def signal_solve_timing(p, t, launches):
    """K8's ``kernels`` entry at one update's SDR solve (``SIG_BATCH`` x 2
    Toeplitz systems of ``SIG_FILTER``): the kernel against its plain version,
    both timed, beside PyTorch's own LU of the full matrices (its pick of
    backend, MAGMA's batched LU at this size: ``library_ms``) and cuSOLVER's
    LU (the one that captures), with the SDR each solve gives; and K8 at PIT
    over SDR's shape (one (estimate, source) pair's ``SIG_BATCH`` systems,
    ``pit_pair_ms``), held against its plain version there too."""
    from metrics_tpu_torch.functional.audio.sdr import _compute_autocorr_crosscorr, _normalize, _toeplitz
    from metrics_tpu_torch.ops.kernels.toeplitz_cuda import toeplitz_solve_cuda, toeplitz_solve_plain

    acf, xcorr = _compute_autocorr_crosscorr(_normalize(t), _normalize(p), SIG_FILTER)
    acf, xcorr = acf.contiguous(), xcorr.contiguous()
    a, b = _toeplitz(acf), xcorr[..., None]
    got, plain = toeplitz_solve_cuda(acf, xcorr), toeplitz_solve_plain(acf, xcorr)

    def sdr_of(sol):
        coh = (xcorr.double() * sol.double()).sum(-1)
        return 10 * torch.log10(coh / (1 - coh))

    lu = {}
    saved = torch.backends.cuda.preferred_linalg_library()
    try:
        for backend in ("default", "cusolver"):
            torch.backends.cuda.preferred_linalg_library(backend)
            lu[backend] = (gpu_ms(lambda: torch.linalg.solve_ex(a, b, check_errors=False)[0], runs=5),
                           torch.linalg.solve_ex(a, b, check_errors=False)[0][..., 0])
    finally:
        torch.backends.cuda.preferred_linalg_library(saved)
    systems, length = acf.numel() // SIG_FILTER, SIG_FILTER
    # PIT over SDR solves each (estimate, source) pair's systems apart: SIG_BATCH of them a launch
    pit_acf, pit_xcorr = _compute_autocorr_crosscorr(_normalize(t[:, 0]), _normalize(p[:, 1]), SIG_FILTER)
    pit_acf, pit_xcorr = pit_acf.contiguous(), pit_xcorr.contiguous()
    pit_plain = toeplitz_solve_plain(pit_acf, pit_xcorr)
    pit_err = max_abs_err(toeplitz_solve_cuda(pit_acf, pit_xcorr), pit_plain)
    check(pit_err <= 1e-4 * float(pit_plain.abs().max()), f"22(a): K8 vs its plain version at PIT's pair {pit_err}")
    entry = {"name": "toeplitz_solve", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/toeplitz.cu",
             "replaces": "metrics_tpu/functional/audio/sdr.py:77 (jnp.linalg.solve through XLA; no Pallas kernel)",
             "shape": f"({systems}, {length}) f32 systems, float64 inside", "launches": launches,
             "max_abs_err": max_abs_err(got, plain),
             "ms": gpu_ms(lambda: toeplitz_solve_cuda(acf, xcorr)),
             "plain_ms": gpu_ms(lambda: toeplitz_solve_plain(acf, xcorr), runs=3),
             "library_ms": lu["default"][0], "cusolver_lu_ms": lu["cusolver"][0],
             "pit_pair_shape": f"({pit_acf.shape[0]}, {length}) f32 systems", "pit_pair_max_abs_err": pit_err,
             "pit_pair_ms": gpu_ms(lambda: toeplitz_solve_cuda(pit_acf, pit_xcorr)),
             "sdr_max_abs_diff_db": {"plain": max_abs_err(sdr_of(got), sdr_of(plain)),
                                     "magma_lu": max_abs_err(sdr_of(got), sdr_of(lu["default"][1])),
                                     "cusolver_lu": max_abs_err(sdr_of(got), sdr_of(lu["cusolver"][1]))}}
    check(entry["max_abs_err"] <= 1e-4 * float(plain.abs().max()), f"22(a): K8 vs its plain version {entry['max_abs_err']}")
    check(entry["sdr_max_abs_diff_db"]["magma_lu"] <= SIG_SDR_TOL, f"22(a): K8's SDR vs the LU's {entry}")
    # r and b read once, x written once; the work a symmetric Toeplitz solve by Levinson needs,
    # 4 L^2 flops a system (Golub & Van Loan, section 4.7), in FP64
    entry["bound_ms"], entry["bound_by"] = bound_ms(3 * 4 * systems * length, 0)
    ops_ms = systems * 4 * length * length / FP64_OPS_PER_S * 1e3
    if ops_ms > entry["bound_ms"]:
        entry["bound_ms"], entry["bound_by"] = ops_ms, "operations"
    return entry


def div2k_images(dev, seed=SEED + 23):
    """``(preds, target)`` for 22(b): ``(IMG_COUNT,) + IMG_SHAPE`` f32 in [0, 1]
    on ``dev``: a smooth field (seeded coarse noise upsampled bicubically)
    plus a sinusoidal texture, and a copy blurred (5x5 Gaussian, sigma 1)
    with Gaussian noise of sigma 0.02-0.10 added."""
    import torch.nn.functional as F_

    g = torch.Generator(device=dev).manual_seed(seed)
    c, h, w = IMG_SHAPE
    coarse = torch.rand((IMG_COUNT, c, h // 40, w // 40), generator=g, device=dev)
    smooth = F_.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False)
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    freq = 0.05 + 0.3 * torch.rand((IMG_COUNT, 1, 1, 1), generator=g, device=dev)
    texture = 0.1 * torch.sin(freq * xx + 0.7 * freq * yy)
    target = (0.8 * smooth + 0.1 + texture).clamp_(0.0, 1.0)
    del coarse, smooth, texture
    k = torch.exp(-0.5 * torch.arange(-2.0, 3.0, device=dev) ** 2)
    k = (k[:, None] * k[None, :]) / k.sum() ** 2
    blur = F_.conv2d(F_.pad(target, (2, 2, 2, 2), mode="reflect"), k.expand(c, 1, 5, 5).contiguous(), groups=c)
    sigma = 0.02 + 0.08 * torch.rand((IMG_COUNT, 1, 1, 1), generator=g, device=dev)
    preds = blur.add_(sigma * torch.randn(blur.shape, generator=g, device=dev))
    return preds, target


def image_metrics(device):
    import metrics_tpu_torch as mp

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # SSIM's and MS-SSIM's warning of their buffers
        return {"psnr": mp.PSNR(data_range=1.0, device=device), "psnr_inferred": mp.PSNR(device=device),
                "psnr_per_image": mp.PSNR(data_range=1.0, dim=(1, 2, 3), reduction="none", device=device),
                "ssim": mp.SSIM(data_range=1.0, device=device),
                "ms_ssim": mp.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device=device)}


def signal_images(dev):
    """22(b): PSNR three ways, SSIM and MS-SSIM over 50 DIV2K-sized images;
    the first two against the CPU."""
    from metrics_tpu_torch import functional as F_

    t0 = time.perf_counter()
    preds, target = div2k_images(dev)
    torch.cuda.synchronize()
    out = {"data_s": time.perf_counter() - t0, "images": IMG_COUNT, "shape": list(IMG_SHAPE), "batch": IMG_BATCH,
           "reduced": "50 of DIV2K's 100 validation images", "bytes_per_tensor": preds.numel() * 4}
    metrics = image_metrics(dev)
    for lo in range(0, IMG_COUNT, IMG_BATCH):
        for m in metrics.values():
            m.update(preds[lo:lo + IMG_BATCH], target[lo:lo + IMG_BATCH])
    torch.cuda.synchronize()
    computes, values = {}, {}
    for k, m in metrics.items():
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        v = m.compute()
        end.record()
        host_ms = (time.perf_counter() - h0) * 1e3
        end.synchronize()
        # elapsed between the events: the device's work and any stall of the caching allocator in it
        computes[k] = {"host_ms": host_ms, "elapsed_ms": start.elapsed_time(end),
                       "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                       "above_inputs_gb": (torch.cuda.max_memory_allocated(dev) - base) / 1e9}
        values[k] = v
        check(torch.isfinite(v).all(), f"22(b): {k} not finite")
    # SSIM and MS-SSIM once more on the same 50 images, the allocator warm: device ms alone
    for k, fn in (("ssim", F_.ssim), ("ms_ssim", F_.multiscale_structural_similarity_index_measure)):
        computes[k]["warm_device_ms"] = gpu_ms(lambda: fn(preds, target, data_range=1.0), runs=1)
    check(values["psnr_per_image"].shape == (IMG_COUNT,), "22(b): per-image PSNR shape")
    check(20.0 < float(values["psnr"]) < 45.0 and 0.0 < float(values["ssim"]) < 1.0
          and 0.0 < float(values["ms_ssim"]) < 1.0, f"22(b): implausible {values}")
    out["compute"] = computes
    out["values"] = {k: (v.tolist() if k == "psnr_per_image" else float(v)) for k, v in values.items()}
    # the first two images on the card and on the CPU; SSIM and MS-SSIM also against float64 (the
    # functions' own arithmetic in float64 on the card: the functionals would narrow a float64 input)
    from metrics_tpu_torch.functional.image.ms_ssim import _multiscale_ssim_compute
    from metrics_tpu_torch.functional.image.ssim import _ssim_compute

    head_p, head_t = preds[:IMG_CPU], target[:IMG_CPU]
    cpu_p, cpu_t = head_p.cpu(), head_t.cpu()
    t0 = time.perf_counter()
    errs, f64_errs = {}, {}
    for name, fn in (("psnr", lambda p, t: F_.psnr(p, t, data_range=1.0)), ("psnr_inferred", F_.psnr),
                     ("psnr_per_image", lambda p, t: F_.psnr(p, t, data_range=1.0, dim=(1, 2, 3), reduction="none")),
                     ("ssim", lambda p, t: _ssim_compute(p, t, data_range=1.0)),
                     ("ms_ssim", lambda p, t: _multiscale_ssim_compute(p, t, data_range=1.0))):
        got, want = fn(head_p, head_t).cpu().double(), fn(cpu_p, cpu_t).double()
        errs[name] = float(((got - want).abs() / want.abs()).max())
        tol = IMG_SSIM_CPU_TOL if name == "ssim" else 1e-5
        check(errs[name] <= tol, f"22(b): {name} card vs CPU relative err {errs[name]} > {tol}")
        if name in ("ssim", "ms_ssim"):
            ref = fn(head_p.double(), head_t.double()).cpu()
            f64_errs[name] = {"card": float((got - ref).abs().max() / ref.abs()),
                              "cpu": float((want - ref).abs().max() / ref.abs())}
            check(max(f64_errs[name].values()) <= IMG_SSIM_F64_TOL, f"22(b): {name} f32 vs float64 {f64_errs[name]}")
    for a, b in zip(F_.image_gradients(head_p), F_.image_gradients(cpu_p)):
        check(torch.equal(a.cpu(), b), "22(b): image_gradients card vs CPU")
    out["cpu_twin_s"] = time.perf_counter() - t0
    out["cpu_max_rel_err"] = errs
    out["f32_vs_f64_rel_err"] = f64_errs
    return out, head_p.clone(), head_t.clone()


def signal_pin(dev, preds, target, img_p, img_t):
    """22(c): STOI (at 8 and at 20 kHz) and SSIM (over RGB and over one
    channel) with the process's TF32 settings most permissive, then strict:
    the scores must be bit-equal; the settings are restored. For the record,
    the same pair of runs with the pin taken out (``full_f32`` a null
    context in the two modules for the call): how far each score moves
    where nothing pins it."""
    from metrics_tpu_torch import functional as F_

    p, t = preds[:SIG_PIN_MIXTURES], target[:SIG_PIN_MIXTURES]
    names = ("stoi", "estoi", "stoi_decimated", "ssim", "ssim_gray")

    def scores():
        # STOI's rational-rate path and, declared at 20 kHz, its decimation path (a strided cuDNN conv1d);
        # SSIM over RGB (PyTorch's own depthwise kernel) and over one channel (a cuDNN convolution)
        return [F_.stoi(p, t, SIG_FS), F_.stoi(p, t, SIG_FS, extended=True), F_.stoi(p, t, 20000),
                F_.ssim(img_p, img_t, data_range=1.0), F_.ssim(img_p[:, :1], img_t[:, :1], data_range=1.0)]

    def permissive_then_strict():
        runs = []
        for permissive in (True, False):
            torch.backends.cudnn.allow_tf32 = permissive
            torch.set_float32_matmul_precision("medium" if permissive else "highest")
            runs.append(scores())
            check(torch.backends.cudnn.allow_tf32 == permissive
                  and torch.get_float32_matmul_precision() == ("medium" if permissive else "highest"),
                  "22(c): a metric left the caller's precision settings changed")
        return runs

    saved = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    modules = [sys.modules[f"metrics_tpu_torch.functional.{m}"] for m in ("audio.stoi", "image.ssim")]
    try:
        pinned = permissive_then_strict()
        with contextlib.ExitStack() as stack:
            for mod in modules:
                stack.callback(setattr, mod, "full_f32", mod.full_f32)
                mod.full_f32 = contextlib.nullcontext
            unpinned = permissive_then_strict()
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    for name, a, b in zip(names, *pinned):
        check(torch.equal(a, b), f"22(c): {name} depends on the TF32 settings")
    return {"bit_equal": list(names),
            "unpinned_max_abs_diff": {n: float((a - b).abs().max()) for n, a, b in zip(names, *unpinned)},
            "restored": [torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()]}


def signal_pesq(dev, preds, target):
    """22(d): PESQ needs the native ``pesq`` package, which this machine lacks:
    the class and the functional must raise ``ModuleNotFoundError``."""
    import metrics_tpu_torch as mp
    from metrics_tpu_torch.functional import pesq

    raised = []
    for name, fn in (("PESQ", lambda: mp.PESQ(8000, "nb", device=dev)),
                     ("pesq", lambda: pesq(preds[0, 0], target[0, 0], 8000, "nb"))):
        try:
            fn()
        except ModuleNotFoundError as e:
            raised.append(f"{name}: {e}")
        else:
            check(False, f"22(d): {name} ran without the pesq package")
    return raised


def signal_long_filter(dev, preds, target):
    """22(e): SDR at ``filter_length=8192`` over the first ``SIG_LONG_MIXTURES``
    mixtures on the card (K8's global-scratch form, past the 6144 whose
    vectors fit in shared memory) against the CPU port (the float64 Levinson
    loop), within ``SIG_SDR_TOL``; then K8's ``kernels`` entry at those
    ``(8, 8192)`` systems, held against its plain version (float64) there
    and timed beside PyTorch's LU of the full matrices."""
    import metrics_tpu_torch as mp
    from metrics_tpu_torch.functional.audio.sdr import _compute_autocorr_crosscorr, _normalize, _toeplitz
    from metrics_tpu_torch.ops.kernels.toeplitz_cuda import toeplitz_solve_cuda, toeplitz_solve_plain

    p, t = preds[:SIG_LONG_MIXTURES], target[:SIG_LONG_MIXTURES]
    toeplitz_solve_cuda.launches = 0
    card, cpu = mp.SignalDistortionRatio(filter_length=SIG_LONG_FILTER, device=dev), \
        mp.SignalDistortionRatio(filter_length=SIG_LONG_FILTER, device="cpu")
    t0 = time.perf_counter()
    card.update(p, t)
    got = float(card.compute())
    torch.cuda.synchronize(dev)
    card_s = time.perf_counter() - t0
    launches = toeplitz_solve_cuda.launches
    check(launches > 0, "22(e): SDR at filter_length=8192 did not launch K8")
    t0 = time.perf_counter()
    cpu.update(p.cpu(), t.cpu())
    want = float(cpu.compute())
    cpu_s = time.perf_counter() - t0
    check(math.isfinite(want) and abs(got - want) <= SIG_SDR_TOL, f"22(e): SDR(8192) card {got} vs CPU {want}")
    from metrics_tpu_torch.functional import signal_distortion_ratio

    per_card = signal_distortion_ratio(p, t, filter_length=SIG_LONG_FILTER)
    per_cpu = signal_distortion_ratio(p.cpu(), t.cpu(), filter_length=SIG_LONG_FILTER)
    per_err = max_abs_err(per_card, per_cpu)
    check(per_err <= SIG_SDR_TOL, f"22(e): per-signal SDR(8192) card vs CPU err {per_err}")
    out = {"mixtures": SIG_LONG_MIXTURES, "filter_length": SIG_LONG_FILTER, "sdr_card": got, "sdr_cpu": want,
           "per_signal_max_abs_err_db": per_err, "card_s": card_s, "cpu_s": cpu_s, "k8_launches": launches}

    acf, xcorr = _compute_autocorr_crosscorr(_normalize(t), _normalize(p), SIG_LONG_FILTER)
    acf, xcorr = acf.reshape(-1, SIG_LONG_FILTER).contiguous(), xcorr.reshape(-1, SIG_LONG_FILTER).contiguous()
    systems, length = acf.shape
    sol = toeplitz_solve_cuda(acf, xcorr)
    plain = toeplitz_solve_plain(acf, xcorr)
    err = max_abs_err(sol, plain)
    check(err <= 1e-4 * float(plain.abs().max()), f"22(e): K8 vs its plain version at L={length}: {err}")
    a, b = _toeplitz(acf), xcorr[..., None]
    entry = {"name": "toeplitz_solve", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/toeplitz.cu",
             "replaces": "metrics_tpu/functional/audio/sdr.py:77 (jnp.linalg.solve through XLA; no Pallas kernel)",
             "shape": f"({systems}, {length}) f32 systems, float64 inside, the global-scratch form",
             "launches": launches, "max_abs_err": err,
             "ms": gpu_ms(lambda: toeplitz_solve_cuda(acf, xcorr), runs=5),
             "device_us": device_us(lambda: toeplitz_solve_cuda(acf, xcorr), runs=3),
             "plain_ms": gpu_ms(lambda: toeplitz_solve_plain(acf, xcorr), runs=1),
             "library_ms": gpu_ms(lambda: torch.linalg.solve_ex(a, b, check_errors=False)[0], runs=2)}
    del a, b
    entry["bound_ms"], entry["bound_by"] = bound_ms(3 * 4 * systems * length, 0)
    ops_ms = systems * 4 * length * length / FP64_OPS_PER_S * 1e3
    if ops_ms > entry["bound_ms"]:
        entry["bound_ms"], entry["bound_by"] = ops_ms, "operations"
    out["solve"] = entry
    return out


def signal_phase(dev):
    """Phase 22: audio and the signal-level image metrics on the card (module docstring)."""
    speech, preds, target = signal_speech(dev)
    long_filter = signal_long_filter(dev, preds, target)
    images, img_p, img_t = signal_images(dev)
    pin = signal_pin(dev, preds, target, img_p, img_t)
    pesq_raised = signal_pesq(dev, preds, target)
    return {"speech": speech, "long_filter": long_filter, "images": images, "precision_pin": pin,
            "pesq": pesq_raised}


# --------------------------------------------------------------------------- phase 23: embedded-model image metrics

EMB_IMAGES = 2048  # a side; FID's usual protocol compares 50 000 a side: the one cut
EMB_SIZE = 299
EMB_BATCH = 64
EMB_CPU_IMAGES = 8  # 23(a): the images a side the CPU twin takes
EMB_KID = {"subsets": 100, "subset_size": 1000}  # KID's defaults
EMB_IS_SPLITS = 10
EMB_FEATURE_TOL = 1e-4  # card vs CPU features, relative to the largest (94 f32 convolutions in another order)
EMB_FID_TOL = 1e-5  # FID against scipy's float64 sqrtm, relative
EMB_KID_TOL = 1e-4  # KID's mean against float64 numpy on the same subsets, relative
EMB_IS_TOL = 1e-4  # list-mode IS against float64 numpy on the same permutation, relative
EMB_HOST_IMAGES = 256  # 23(b): a side, through FID and KID sharing one host, and again directly
LPIPS_PAIRS = 1000  # 23(c): BAPPS 2AFC's patch size, 64 x 64
LPIPS_SIZE = 64
LPIPS_BATCH = 50
LPIPS_LARGE = 8  # pairs at 256 x 256
LPIPS_CPU = 8
LPIPS_TOL = 1e-4  # card vs CPU per-pair distance, relative


def emb_images(dev, lo, hi, fake, seed=SEED + 24):
    """Images ``[lo, hi)`` of one side, ``(n, 3, 299, 299)`` uint8 on ``dev``,
    each batch from its own seeded generator: "real" uniform noise over a
    smooth per-image gradient, "fake" the same form darker, with lower
    contrast, so the two distributions differ."""
    out = []
    for start in range(lo, hi, EMB_BATCH):
        stop = min(start + EMB_BATCH, hi)
        g = torch.Generator(device=dev).manual_seed(seed * 100_003 + 2 * start + int(fake))
        n = stop - start
        noise = torch.rand((n, 3, EMB_SIZE, EMB_SIZE), generator=g, device=dev)
        ramp = torch.linspace(0.0, 1.0, EMB_SIZE, device=dev)
        tilt = torch.rand((n, 3, 1, 1), generator=g, device=dev)
        base = tilt * ramp[None, None, :, None] + (1 - tilt) * ramp[None, None, None, :]
        img = 0.5 * noise + 0.5 * base if not fake else 0.3 * noise + 0.4 * base + 0.05
        out.append((img.clamp(0, 1) * 255).to(torch.uint8))
    return torch.cat(out)


def emb_weights():
    from metrics_tpu_torch.models.inception import random_inception_params

    return random_inception_params(input_size=EMB_SIZE, seed=SEED + 24)


def timed_updates(dev, metric, sides):
    """Update ``metric`` over ``sides`` (``[(real_flag or None, lo, hi)]``) in
    ``EMB_BATCH`` updates; host and device ms per update (medians)."""
    host, device = [], []
    t0 = time.perf_counter()
    for real, lo, hi in sides:
        for start in range(lo, hi, EMB_BATCH):
            imgs = emb_images(dev, start, min(start + EMB_BATCH, hi), fake=real is False)
            torch.cuda.synchronize()
            start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            start_ev.record()
            metric.update(imgs) if real is None else metric.update(imgs, real=real)
            end_ev.record()
            host.append((time.perf_counter() - h0) * 1e3)
            end_ev.synchronize()
            device.append(start_ev.elapsed_time(end_ev))
    seconds = time.perf_counter() - t0
    images = sum(hi - lo for _, lo, hi in sides)
    return {"images": images, "seconds": seconds, "images_per_s": images / seconds,
            "host_ms_per_update": float(np.median(host)), "device_ms_per_update": float(np.median(device))}


def timed_compute(dev, metric):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    h0 = time.perf_counter()
    value = metric.compute()
    torch.cuda.synchronize()
    return value, {"ms": (time.perf_counter() - h0) * 1e3,
                   "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def kid_oracle(real, fake, seed, subsets, subset_size, degree=3, coef=1.0):
    """KID's (mean, std) in float64 numpy on the subsets ``np.random.RandomState(seed)``
    draws in JAX's order, from whole-set Gram matrices."""
    gamma = 1.0 / real.shape[1]
    k_rr = (real @ real.T * gamma + coef) ** degree
    k_ff = (fake @ fake.T * gamma + coef) ** degree
    k_rf = (real @ fake.T * gamma + coef) ** degree
    rng = np.random.RandomState(seed)
    m = subset_size
    scores = []
    for _ in range(subsets):
        r = rng.permutation(real.shape[0])[:m]
        f = rng.permutation(fake.shape[0])[:m]
        xx, yy, xy = k_rr[np.ix_(r, r)], k_ff[np.ix_(f, f)], k_rf[np.ix_(r, f)]
        scores.append((xx.sum() - np.trace(xx) + yy.sum() - np.trace(yy)) / (m * (m - 1)) - 2 * xy.sum() / m**2)
    return float(np.mean(scores)), float(np.std(scores))


def is_oracle(logits, seed, splits):
    """List-mode IS in float64 numpy: the same permutation, ``array_split``, ddof 1."""
    logits = logits[np.random.RandomState(seed).permutation(logits.shape[0])]
    z = logits - logits.max(axis=1, keepdims=True)
    log_p = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    p = np.exp(log_p)
    kl = [np.exp(np.mean(np.sum(pc * (lc - np.log(pc.mean(axis=0, keepdims=True))), axis=1)))
          for pc, lc in zip(np.array_split(p, splits), np.array_split(log_p, splits))]
    return float(np.mean(kl)), float(np.std(kl, ddof=1))


def rel_err(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def embedded_inception(dev, params):
    """23(a): FID, KID and IS at 299 x 299 over 2 048 images a side, against
    float64 oracles on the card's features and a CPU twin on 8 a side."""
    import scipy.linalg

    import metrics_tpu_torch as mp
    from metrics_tpu_torch.models import inception as inc

    out = {"images_per_side": EMB_IMAGES, "size": EMB_SIZE, "batch": EMB_BATCH, "kid": EMB_KID,
           "is_splits": EMB_IS_SPLITS, "reduced": "2 048 images a side, not 50 000"}
    sides = [(True, 0, EMB_IMAGES), (False, 0, EMB_IMAGES)]
    torch.cuda.reset_peak_memory_stats(dev)
    fid = mp.FID(feature=2048, params=params, device=dev)
    out["fid_update"] = timed_updates(dev, fid, sides)
    out["fid_state_mb"] = sum(v.numel() * v.element_size() for v in fid._pack_state().values()) / 1e6
    kid = mp.KID(feature=2048, params=params, seed=SEED + 25, device=dev, **EMB_KID)
    out["kid_update"] = timed_updates(dev, kid, sides)
    is_list = mp.IS(params=params, splits=EMB_IS_SPLITS, seed=SEED + 26, device=dev)
    out["is_update"] = timed_updates(dev, is_list, [(None, 0, EMB_IMAGES)])
    is_stream = mp.IS(params=params, splits=EMB_IS_SPLITS, seed=SEED + 26, streaming=True, device=dev)
    out["is_streaming_update"] = timed_updates(dev, is_stream, [(None, 0, EMB_IMAGES)])
    out["updates_max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9

    values, computes = {}, {}
    for name, m in (("fid", fid), ("kid", kid), ("is", is_list), ("is_streaming", is_stream)):
        values[name], computes[name] = timed_compute(dev, m)
    out["compute"] = computes
    out["values"] = {k: ([float(x) for x in v] if isinstance(v, tuple) else float(v)) for k, v in values.items()}

    # the oracles, in float64 on the host, from the card's own features (KID's and IS's lists)
    real = torch.cat(kid.real_features).double().cpu().numpy()
    fake = torch.cat(kid.fake_features).double().cpu().numpy()
    t0 = time.perf_counter()
    mu1, mu2 = real.mean(0), fake.mean(0)
    s1, s2 = np.cov(real, rowvar=False), np.cov(fake, rowvar=False)
    covmean = scipy.linalg.sqrtm(s1 @ s2)
    fid_want = float(((mu1 - mu2) ** 2).sum() + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean).real)
    kid_want = kid_oracle(real, fake, SEED + 25, **EMB_KID)
    is_want = is_oracle(torch.cat(is_list.features).double().cpu().numpy(), SEED + 26, EMB_IS_SPLITS)
    out["oracle_s"] = time.perf_counter() - t0
    errs = {"fid": rel_err(values["fid"], fid_want), "kid_mean": rel_err(values["kid"][0], kid_want[0]),
            "is_mean": rel_err(values["is"][0], is_want[0]), "is_std": rel_err(values["is"][1], is_want[1])}
    out["oracle"] = {"fid": fid_want, "kid": kid_want, "is": is_want, "rel_err": errs}
    check(math.isfinite(values["fid"]) and values["fid"] > 0, f"23(a): FID {values['fid']}")
    check(errs["fid"] <= EMB_FID_TOL, f"23(a): FID vs scipy's sqrtm {errs['fid']}")
    check(errs["kid_mean"] <= EMB_KID_TOL, f"23(a): KID vs float64 on the same subsets {errs['kid_mean']}")
    check(abs(float(values["kid"][1]) - kid_want[1]) <= EMB_KID_TOL * abs(kid_want[0]) + 1e-7,
          f"23(a): KID std {values['kid'][1]} vs {kid_want[1]}")
    check(errs["is_mean"] <= EMB_IS_TOL and errs["is_std"] <= 10 * EMB_IS_TOL, f"23(a): IS vs float64 {errs}")

    # streaming IS: its split counts equal a CPU twin's for the same seed and update sizes
    twin = mp.IS(feature=lambda x: torch.zeros((x.shape[0], 1008)), feature_dim=1008, splits=EMB_IS_SPLITS,
                 seed=SEED + 26, streaming=True, device="cpu")
    for start in range(0, EMB_IMAGES, EMB_BATCH):
        twin.update(torch.zeros((min(EMB_BATCH, EMB_IMAGES - start), 1)))
    check(torch.equal(is_stream.split_n.cpu(), twin.split_n), f"23(a): streaming IS splits {is_stream.split_n}")
    out["is_streaming_split_n"] = [int(v) for v in is_stream.split_n.tolist()]

    # the CPU twin: the first 8 images a side, every tap on the card and on the CPU
    cpu_errs = {}
    t0 = time.perf_counter()
    for fake_side in (False, True):
        imgs = emb_images(dev, 0, EMB_CPU_IMAGES, fake=fake_side)
        for tap in ("2048", "logits_unbiased"):
            got = inc.InceptionFeatureExtractor(tap, params=params, device=dev)(imgs)
            want = inc.InceptionFeatureExtractor(tap, params=params, device="cpu")(imgs.cpu())
            e = max_abs_err(got, want) / float(want.abs().max())
            cpu_errs[f"{tap}_{'fake' if fake_side else 'real'}"] = e
            check(e <= EMB_FEATURE_TOL, f"23(a): {tap} card vs CPU {e}")
    out["cpu_twin_s"] = time.perf_counter() - t0
    out["cpu_rel_err"] = cpu_errs

    # the move of the features with the pin taken out (full_f32 a null context, TF32 allowed)
    imgs = emb_images(dev, 0, EMB_BATCH, fake=False)
    ext = inc.InceptionFeatureExtractor("2048", params=params, device=dev)
    pinned = ext(imgs)
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        check(torch.equal(ext(imgs), pinned), "23(a): pinned features depend on the TF32 setting")
        inc.full_f32 = contextlib.nullcontext
        unpinned = ext(imgs)
    finally:
        inc.full_f32 = sys.modules["metrics_tpu_torch.utils.precision"].full_f32
        torch.backends.cudnn.allow_tf32 = saved
    out["unpinned_max_rel_diff"] = max_abs_err(unpinned, pinned) / float(pinned.abs().max())
    return out


def embedded_host(dev, params):
    """23(b): FID and KID on one resident host; captures per bucket; f32 bit-equal
    to the direct forward at the same shape; bf16 and int8 within JAX's bounds;
    images/s direct and hosted."""
    import metrics_tpu_torch as mp
    from metrics_tpu_torch.engine.model_host import ModelHostConfig, inception_host, reset_host_registry
    from metrics_tpu_torch.models.inception import InceptionFeatureExtractor
    from metrics_tpu_torch.parallel.collectives import q8_sum_error_bound

    out = {}
    reset_host_registry()
    try:
        fid = mp.FID(feature=2048, params=params, model_host=True, device=dev)
        kid = mp.KID(feature=2048, params=params, subsets=10, subset_size=100, model_host=True, device=dev)
        host = fid.model_host
        check(host is kid.model_host and host.counters()["shared_by"] == 2, "23(b): FID and KID do not share a host")
        out["buckets"] = list(host.config.buckets)
        # cold: one capture per bucket (5 images take the 8-bucket, 32 the 32-bucket)
        imgs = emb_images(dev, 0, 32, fake=False)
        direct = InceptionFeatureExtractor("2048", params=params, device=dev)
        got32, got5 = host.infer(imgs), host.infer(imgs[:5])
        check(host.aot.misses == 2, f"23(b): cold captures {host.aot.misses}")
        padded = torch.zeros((8,) + tuple(imgs.shape[1:]), dtype=imgs.dtype, device=dev)
        padded[:5] = imgs[:5]
        check(torch.equal(got32, direct(imgs)) and torch.equal(got5, direct(padded)[:5]),
              "23(b): f32 host features differ from the direct forward at the same shape")
        out["padded_vs_unpadded_max_rel_diff"] = max_abs_err(got5, direct(imgs[:5])) / float(got5.abs().max())
        # hosted run: FID and KID over the same images a side through the one model, and directly
        sides = [(True, 0, EMB_HOST_IMAGES), (False, 0, EMB_HOST_IMAGES)]
        hosted = {"fid": timed_updates(dev, fid, sides), "kid": timed_updates(dev, kid, sides)}
        check(host.aot.misses == 2, f"23(b): the warm pass captured {host.aot.misses - 2}")
        plain_fid = mp.FID(feature=2048, params=params, device=dev)
        direct_run = timed_updates(dev, plain_fid, sides)
        check(rel_err(fid.compute(), plain_fid.compute()) <= 1e-6, "23(b): hosted FID differs from the direct one")
        out["hosted"] = hosted
        out["direct_fid"] = direct_run
        out["host_counters"] = host.counters()
        out["host_items_per_s"] = host.stats.items_per_s()
        # the reduced paths, on the 32 images
        for precision in ("bf16", "int8"):
            h = inception_host("2048", params, config=ModelHostConfig(precision=precision), device=dev)
            g = h.infer(imgs)
            if precision == "bf16":
                ok = bool(torch.allclose(g, got32, rtol=5e-2, atol=5e-2)) and not torch.equal(g, got32)
                err = max_abs_err(g, got32)
            else:
                # the codec's bound, plus the one f32 rounding of the decode's code * scale
                bound = torch.from_numpy(q8_sum_error_bound(got32.cpu().numpy()[None]))
                slack = torch.finfo(torch.float32).eps * got32.abs().cpu()
                err = float(((g - got32).abs().cpu() - bound - slack).max())
                ok = err <= 0.0
            out[f"{precision}_err"] = err
            check(ok, f"23(b): {precision} path outside its bound ({err})")
    finally:
        reset_host_registry()
    return out


def lpips_pairs_on(dev, n, size, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand((n, 3, size, size), generator=g, device=dev) * 2 - 1
    return a, (a + 0.2 * torch.randn(a.shape, generator=g, device=dev)).clamp(-1, 1)


def embedded_lpips(dev):
    """23(c): LPIPS with VGG16 and AlexNet on 1 000 seeded 64 x 64 pairs in
    batches of 50, and 8 pairs at 256 x 256; the first 8 pairs against the CPU."""
    import metrics_tpu_torch as mp
    from metrics_tpu_torch.image.lpip_similarity import _lpips_from_features

    out = {}
    for net_type in ("vgg", "alex"):
        channels = (64, 128, 256, 512, 512) if net_type == "vgg" else (64, 192, 384, 256, 256)
        g = np.random.RandomState(SEED + 27)
        weights = [torch.from_numpy(g.uniform(0, 1, c).astype(np.float32)) for c in channels]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the seeded backbone's warning
            card = mp.LPIPS(net_type=net_type, weights=[w.to(dev) for w in weights], device=dev)
            cpu = mp.LPIPS(net_type=net_type, weights=weights, device="cpu")
        a, b = lpips_pairs_on(dev, LPIPS_PAIRS, LPIPS_SIZE, SEED + 28)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        host, device = [], []
        t0 = time.perf_counter()
        for lo in range(0, LPIPS_PAIRS, LPIPS_BATCH):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            s.record()
            card.update(a[lo:lo + LPIPS_BATCH], b[lo:lo + LPIPS_BATCH])
            e.record()
            host.append((time.perf_counter() - h0) * 1e3)
            e.synchronize()
            device.append(s.elapsed_time(e))
        seconds = time.perf_counter() - t0
        value = float(card.compute())
        check(math.isfinite(value) and value > 0, f"23(c): {net_type} LPIPS {value}")
        la, lb = lpips_pairs_on(dev, LPIPS_LARGE, 256, SEED + 29)
        large = _lpips_from_features(card.net(la), card.net(lb), card.weights)
        check(bool(torch.isfinite(large).all()), f"23(c): {net_type} at 256 x 256")
        got = _lpips_from_features(card.net(a[:LPIPS_CPU]), card.net(b[:LPIPS_CPU]), card.weights)
        want = _lpips_from_features(cpu.net(a[:LPIPS_CPU].cpu()), cpu.net(b[:LPIPS_CPU].cpu()), cpu.weights)
        err = float(((got.cpu() - want).abs() / want.abs()).max())
        check(err <= LPIPS_TOL, f"23(c): {net_type} card vs CPU {err}")
        out[net_type] = {"pairs": LPIPS_PAIRS, "size": LPIPS_SIZE, "batch": LPIPS_BATCH, "value": value,
                         "pairs_per_s": LPIPS_PAIRS / seconds, "host_ms_per_update": float(np.median(host)),
                         "device_ms_per_update": float(np.median(device)),
                         "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                         "large_256": [float(v) for v in large.tolist()], "cpu_max_rel_err": err}
    return out


def embedded_phase(dev):
    """Phase 23: the embedded-model image metrics on the card (module docstring)."""
    torch.cuda.synchronize(dev)  # the context first: the memory counters need it
    t0 = time.perf_counter()
    params = emb_weights()
    out = {"weights_s": time.perf_counter() - t0}
    out["inception"] = embedded_inception(dev, params)
    out["host"] = embedded_host(dev, params)
    out["lpips"] = embedded_lpips(dev)
    return out


# --------------------------------------------------------------------------- phase 24: detection

DET_IMAGES = 5000  # COCO val2017's image count
DET_WH = (640, 480)  # COCO's most common image size
DET_CLASSES = 80
DET_CLASS_ZIPF = 1.0  # class frequency proportional to 1 / rank: a long tail, the head class ~20 %
DET_GT_PER_IMAGE = 7.3  # val2017 holds 36 781 boxes over 5 000 images (Poisson mean)
DET_AREA_SHARES = (0.41, 0.34, 0.25)  # COCO's small / medium / large shares (41 %, 34 %, 24 %), normalised
DET_SIDES = ((2.0, 32.0), (32.0, 96.0), (96.0, 400.0))  # sqrt(area) range of each size class
DET_PER_IMAGE = 100  # maxDets=100: the detections COCO's evaluation reads an image
DET_RECALLED = 0.75  # share of ground-truth boxes a detection copies, jittered
DET_FLIPPED = 0.10  # share of those copies given another class
DET_JITTER = 0.08  # the copies' corner jitter, a fraction of the box's width or height (normal sigma)
DET_BATCH = 50  # 24(a): 100 updates of 50 images
DET_CPU_IMAGES = 500  # 24(a): the prefix the CPU twin takes
DET_HOST_IMAGES = 100  # 24(b): the prefix the host matcher takes
DET_RAGGED_IMAGES = 64  # 24(c)
DET_RAGGED_CAPACITY = 256
DET_TIMED = 5  # ragged aggregates per median
DET_CROWD_IMAGES = 8  # 24(e): images of a crowd corpus, the first a crowd of one class
DET_CROWD_GTS = 1025  # 24(e): the eager crowd, one past the warp path's 1024 (G = 1032 packed): K9's block path
DET_RAGGED_CROWD_GTS = 1100  # 24(e): the ragged engine's crowd, its rows within ...
DET_CROWD_CAPACITY = 2048  # ... a capacity of 2048: the aggregate's K9 call takes G = 2048


def coco_corpus(seed=SEED + 24):
    """``(preds, targets, shape)``: 5 000 seeded images of COCO val2017's
    make-up (module docstring, phase 24), numpy per image as a data loader
    gives them; ``shape`` counts boxes and the size classes' shares."""
    rng = np.random.RandomState(seed)
    w_img, h_img = DET_WH
    p_cls = 1.0 / np.arange(1, DET_CLASSES + 1) ** DET_CLASS_ZIPF
    p_cls /= p_cls.sum()
    lo_side = np.log(np.asarray([s[0] for s in DET_SIDES]))
    hi_side = np.log(np.asarray([s[1] for s in DET_SIDES]))

    def boxes(n):
        kind = rng.choice(3, n, p=DET_AREA_SHARES)
        side = np.exp(rng.uniform(lo_side[kind], hi_side[kind]))
        aspect = np.sqrt(np.exp(rng.uniform(-0.7, 0.7, n)))
        w, h = np.minimum(side * aspect, w_img - 1), np.minimum(side / aspect, h_img - 1)
        x, y = rng.uniform(0, w_img - w), rng.uniform(0, h_img - h)
        return np.stack([x, y, x + w, y + h], axis=1).astype(np.float32)

    preds, targets = [], []
    for _ in range(DET_IMAGES):
        n_gt = int(rng.poisson(DET_GT_PER_IMAGE))
        gt = boxes(n_gt)
        gl = rng.choice(DET_CLASSES, n_gt, p=p_cls)
        src = np.flatnonzero(rng.rand(n_gt) < DET_RECALLED)[:DET_PER_IMAGE]
        wh = np.concatenate([gt[src, 2:] - gt[src, :2]] * 2, axis=1)
        tp = (gt[src] + rng.normal(0.0, DET_JITTER, (src.size, 4)) * wh).astype(np.float32)
        tl = gl[src].copy()
        flip = rng.rand(src.size) < DET_FLIPPED
        tl[flip] = (tl[flip] + rng.randint(1, DET_CLASSES, int(flip.sum()))) % DET_CLASSES
        n_fp = DET_PER_IMAGE - src.size
        db = np.concatenate([tp, boxes(n_fp)])
        dl = np.concatenate([tl, rng.choice(DET_CLASSES, n_fp, p=p_cls)])
        sc = np.round(np.concatenate([rng.beta(5.0, 2.0, src.size), rng.beta(1.0, 5.0, n_fp)]), 3)  # ties
        order = rng.permutation(DET_PER_IMAGE)  # a detector's output order
        preds.append({"boxes": db[order], "scores": sc[order].astype(np.float32), "labels": dl[order]})
        targets.append({"boxes": gt, "labels": gl})
    areas = np.concatenate([(t["boxes"][:, 2] - t["boxes"][:, 0]) * (t["boxes"][:, 3] - t["boxes"][:, 1])
                            for t in targets])
    shape = {"images": DET_IMAGES, "classes": DET_CLASSES, "gt_boxes": int(areas.size),
             "detections": DET_IMAGES * DET_PER_IMAGE,
             "area_shares": [float(np.mean(areas < 32.0 ** 2)), float(np.mean((areas >= 32.0 ** 2) & (areas <= 96.0 ** 2))),
                             float(np.mean(areas > 96.0 ** 2))]}
    return preds, targets, shape


def det_values(values):
    """A ``MAP`` result on the host, key by key."""
    return {k: v.detach().cpu() for k, v in values.items()}


def same_det_values(got, want, what):
    check(sorted(got) == sorted(want), f"{what}: keys {sorted(got)} != {sorted(want)}")
    for k in want:
        check(torch.equal(got[k].cpu(), want[k].cpu()), f"{what}: {k} {got[k]} != {want[k]}")


def det_metric(dev, preds, targets, **kw):
    """``MAP(class_metrics=True)`` on ``dev`` fed ``preds``/``targets`` in
    ``DET_BATCH``-image updates; also the host seconds the updates took."""
    from metrics_tpu_torch.detection import MAP

    m = MAP(class_metrics=True, device=dev, **kw)
    t0 = time.perf_counter()
    for i in range(0, len(preds), DET_BATCH):
        m.update(preds[i:i + DET_BATCH], targets[i:i + DET_BATCH])
    return m, time.perf_counter() - t0


def det_card(dev, preds, targets):
    """24(a): the corpus through ``MAP(class_metrics=True)`` on the card, its
    ``compute()`` timed whole and split, K9 against its plain version at the
    packed shape, the first ``DET_CPU_IMAGES`` images against the CPU."""
    from metrics_tpu_torch.detection.map import _match_all_pairs, _pair_geometry
    from metrics_tpu_torch.ops.kernels.match_cuda import greedy_match_cuda, greedy_match_plain

    m, update_s = det_metric(dev, preds, targets)
    check(all(isinstance(x, np.ndarray) for x in m.detection_boxes), "24(a): update moved a state to the device")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    before = greedy_match_cuda.launches
    t0 = time.perf_counter()
    values = m.compute()
    torch.cuda.synchronize(dev)
    compute_ms = (time.perf_counter() - t0) * 1e3
    launches = greedy_match_cuda.launches - before
    peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    check(launches == 1, f"24(a): compute launched K9 {launches} times")
    values = det_values(values)
    check(all(bool(torch.isfinite(v).all()) for v in values.values()), "24(a): a value is not finite")
    check(values["map_per_class"].shape == (DET_CLASSES,), f"24(a): map_per_class {values['map_per_class'].shape}")

    # the same compute, stage by stage: host packing, upload, device (IoU + K9 + pack), the copy, the host finish
    classes = m._get_classes()
    split = {}
    t0 = time.perf_counter()
    pairs = m._pack_pairs(classes, m.max_detection_thresholds[-1])
    split["host_pack_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    args = m._upload_pairs(pairs)
    torch.cuda.synchronize(dev)
    split["upload_ms"] = (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    packed = _match_all_pairs(*args)[: pairs.rows]
    end.record()
    end.synchronize()
    split["device_ms"] = start.elapsed_time(end)
    t0 = time.perf_counter()
    host = packed.cpu().numpy()
    split["copy_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ev = m._unpack_evals(pairs, host)
    staged = m._finish_compute(*m._accumulate(m._device_cells(ev, len(classes)), len(classes)), len(classes))
    split["host_finish_ms"] = (time.perf_counter() - t0) * 1e3
    same_det_values(det_values(staged), values, "24(a): the staged compute vs compute()")

    # K9 at the full packed shape against its plain version, on the card
    ious, gt_ign, _ = _pair_geometry(args[0], args[1], args[2], args[3], args[5])
    index = torch.arange(ious.shape[0], dtype=torch.int32, device=dev)
    k9_args = (ious, index, args[1], args[3], gt_ign, args[4])
    dm, mi = greedy_match_cuda(*k9_args)
    pdm, pmi = greedy_match_plain(*k9_args)
    check(torch.equal(dm, pdm) and torch.equal(mi, pmi), "24(a): K9 differs from its plain version")

    # the first DET_CPU_IMAGES images: the card against the CPU, key for key
    card, _ = det_metric(dev, preds[:DET_CPU_IMAGES], targets[:DET_CPU_IMAGES])
    cpu, _ = det_metric(torch.device("cpu"), preds[:DET_CPU_IMAGES], targets[:DET_CPU_IMAGES])
    t0 = time.perf_counter()
    cpu_values = det_values(cpu.compute())
    cpu_s = time.perf_counter() - t0
    same_det_values(det_values(card.compute()), cpu_values, "24(a): card vs CPU")
    p, d, g = pairs.det_boxes.shape[0], pairs.det_boxes.shape[1], pairs.gt_boxes.shape[1]
    out = {"images": len(preds), "updates": -(-len(preds) // DET_BATCH), "update_host_ms": update_s * 1e3,
           "compute_ms": compute_ms, "split": split, "packed": {"P": p, "D": d, "G": g, "live_pairs": pairs.rows},
           "k9_launches": launches, "peak_device_gb": peak_gb, "cpu_twin_images": DET_CPU_IMAGES,
           "cpu_twin_compute_s": cpu_s, "map": float(values["map"]), "map_50": float(values["map_50"]),
           "mar_100": float(values["mar_100"]), "map_small": float(values["map_small"]),
           "map_large": float(values["map_large"])}
    return out, k9_args


def det_host(dev, preds, targets):
    """24(b): ``matching="host"`` (per-image numpy, the oracle) against the
    device path on the first ``DET_HOST_IMAGES`` images."""
    card, _ = det_metric(dev, preds, targets)
    host, _ = det_metric(dev, preds, targets, matching="host")
    t0 = time.perf_counter()
    want = det_values(host.compute())
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = det_values(card.compute())
    device_s = time.perf_counter() - t0
    same_det_values(got, want, "24(b): device path vs host matching")
    return {"images": len(preds), "host_matching_s": host_s, "device_matching_s": device_s, "map": float(got["map"])}


def det_ragged(dev, preds, targets):
    """24(c): ``RaggedEngine(MAP(class_metrics=True))`` over the first
    ``DET_RAGGED_IMAGES`` images, each in two rounds (the first half of its
    detections and ground truths, then the rest): the corpus aggregate on
    the device against the oracle and the eager metric, key for key."""
    from metrics_tpu_torch.detection import MAP
    from metrics_tpu_torch.engine import RaggedEngine
    from metrics_tpu_torch.ops.kernels.match_cuda import greedy_match_cuda

    eng = RaggedEngine(MAP(class_metrics=True, device=dev), num_groups=len(preds), capacity=DET_RAGGED_CAPACITY)
    with eng:
        for half in (0, 1):
            for i, (p, t) in enumerate(zip(preds, targets)):
                nd, ng = len(p["labels"]), len(t["labels"])
                ds = slice(0, nd // 2) if half == 0 else slice(nd // 2, nd)
                gs = slice(0, ng // 2) if half == 0 else slice(ng // 2, ng)
                eng.submit_update([{k: v[ds] for k, v in p.items()}], [{k: v[gs] for k, v in t.items()}], [i])
        eng.flush()
        path = eng.aggregate_path()
        before = greedy_match_cuda.launches
        got = det_values(eng.aggregate())
        torch.cuda.synchronize(dev)
        launches = greedy_match_cuda.launches - before
        times = []
        for _ in range(DET_TIMED):
            t0 = time.perf_counter()
            eng.aggregate()
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        oracle = det_values(eng.aggregate(oracle=True))
        oracle_ms = (time.perf_counter() - t0) * 1e3
        stats = eng.stats.ragged_summary()
        split, k9_args = det_ragged_split(eng, dev)
    check(path[0] == "device", f"24(c): the aggregate takes {path}")
    check(launches == 1, f"24(c): the device aggregate launched K9 {launches} times")
    check(stats["agg_device_reads"] == 1 + DET_TIMED and stats["agg_oracle_reads"] == 1, f"24(c): {stats}")
    same_det_values(got, oracle, "24(c): device aggregate vs oracle")
    eager, _ = det_metric(dev, preds, targets)
    same_det_values(got, det_values(eager.compute()), "24(c): device aggregate vs the eager metric")
    out = {"images": len(preds), "rounds": 2, "capacity": DET_RAGGED_CAPACITY, "path": path[0],
           "k9_launches": launches, "aggregate_ms": float(np.median(times)), "aggregate_ms_runs": times,
           "split": split, "oracle_ms": oracle_ms, "map": float(got["map"])}
    return out, k9_args


def det_ragged_split(eng, dev):
    """24(c)'s device aggregate stage by stage, as ``_aggregate_corpus`` runs
    it: the host plan off the counts and labels, ``grouped_corpus_device``
    between CUDA events, the bundle's one copy, the host finish; and K9's
    arguments at the aggregate's shape."""
    from metrics_tpu_torch.engine.ragged import _bundle_to_host

    user, split = eng.user_metric, {}
    with eng._device_section():
        t0 = time.perf_counter()
        tree = eng._stacked_tree()
        counts = tree["count"].cpu().numpy()
        plan = user.grouped_corpus_plan(counts, {"label": tree["buf_label"].cpu().numpy()})
        classes = torch.from_numpy(plan["classes_padded"]).to(dev)
        cls_valid = torch.arange(classes.shape[0], device=dev) < plan["n_classes"]
        fields = eng._metric.seq_ordered_fields(tree)
        torch.cuda.synchronize(dev)
        split["plan_ms"] = (time.perf_counter() - t0) * 1e3
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        bundle = user.grouped_corpus_device(tree["count"], fields, classes, cls_valid, eng.capacity)
        end.record()
        end.synchronize()
        split["device_ms"] = start.elapsed_time(end)
        t0 = time.perf_counter()
        host = _bundle_to_host(bundle)
        split["copy_ms"] = (time.perf_counter() - t0) * 1e3
        split["bundle_mb"] = sum(v.nbytes for v in host.values()) / 1e6
        problems = user._corpus_problems(tree["count"], fields, classes, cls_valid, eng.capacity)
    t0 = time.perf_counter()
    user.grouped_corpus_finish(host, plan)
    split["host_finish_ms"] = (time.perf_counter() - t0) * 1e3
    split["classes_padded"] = int(classes.shape[0])
    return split, problems.match_args


def k9_iou_reads(ious, index, dvalid, gvalid):
    """The IoUs K9's function needs on this data: per IoU block, each (d, g)
    pair that some problem on the block holds as a valid detection against a
    valid ground truth. The padding around them is never read."""
    b, d, g = ious.shape
    idx = index.to(torch.int64)
    ok = (idx >= 0) & (idx < b)
    pairs = (dvalid.to(torch.bool)[:, :, None] & gvalid.to(torch.bool)[:, None, :] & ok[:, None, None])
    need = torch.zeros((b, d * g), dtype=torch.int32, device=ious.device)
    need.index_add_(0, torch.where(ok, idx, 0), pairs.reshape(-1, d * g).to(torch.int32))
    return int((need > 0).sum())


def det_kernel_entry(k9_args, launches, what):
    """24(d): a ``kernels`` entry of K9 at one of its main-path shapes, held
    against its plain version there. Bound: the IoUs this data needs
    (``k9_iou_reads``), every other input read once and both outputs written
    once over the HBM rate, against the compares this data needs (each valid
    detection of a problem against each of its valid ground truths, for
    every area range and threshold) over 67 T/s."""
    from metrics_tpu_torch.ops.kernels.match_cuda import greedy_match_cuda, greedy_match_plain

    ious, index, dvalid, gvalid, gt_ign, thr = k9_args
    b, d, g = ious.shape
    p, a, t = index.shape[0], gt_ign.shape[1], thr.shape[0]
    dm, mi = greedy_match_cuda(*k9_args)
    pdm, pmi = greedy_match_plain(*k9_args)
    err = max(max_abs_err(dm, pdm), max_abs_err(mi, pmi))
    iou_reads = k9_iou_reads(ious, index, dvalid, gvalid)
    nbytes = 4 * iou_reads + 4 * p + p * d + p * g + p * a * g + 4 * t + 5 * p * a * t * d
    compares = a * t * int((dvalid.sum(dim=1, dtype=torch.int64) * gvalid.sum(dim=1, dtype=torch.int64)).sum())
    entry = {"name": "greedy_match", "route": "cuda", "source": "metrics_tpu_torch/ops/kernels/csrc/match.cu",
             "replaces": "metrics_tpu/detection/map.py:200 (_greedy_match_single, a lax.scan; no Pallas kernel)",
             "shape": f"{what}: P={p} problems on {b} IoU blocks, D={d}, G={g}, A={a}, T={t}",
             "launches": launches, "max_abs_err": err,
             "ms": gpu_ms(lambda: greedy_match_cuda(*k9_args), runs=10),
             "device_us": device_us(lambda: greedy_match_cuda(*k9_args), runs=5),
             "plain_ms": gpu_ms(lambda: greedy_match_plain(*k9_args), runs=2), "library_ms": None,
             "compares": compares, "iou_reads": iou_reads, "bytes": nbytes}
    check(err == 0, f"24(d): K9 vs its plain version at {what}: {err}")
    entry["bound_ms"], entry["bound_by"] = bound_ms(nbytes, compares)
    return entry


def crowd_corpus(seed, crowd):
    """``DET_CROWD_IMAGES`` seeded 640 x 480 images on the host, the first a
    crowd of ``crowd`` ground truths of class 0 (a stadium, a flock), the
    rest 3-30 of 3 classes; detections copy 80 % of the boxes with a
    jittered corner, plus 10 false positives an image; scores rounded to
    1/1000."""
    rng = np.random.RandomState(seed)
    preds, targets = [], []
    for i in range(DET_CROWD_IMAGES):
        ng = crowd if i == 0 else int(rng.randint(3, 31))
        xy = np.round(rng.uniform(0, 600, (ng, 2))).astype(np.float32)
        gt = np.concatenate([xy, xy + rng.choice(np.asarray([6, 20, 40, 90], np.float32), (ng, 2))], axis=1)
        gl = np.zeros(ng, np.int64) if i == 0 else rng.randint(0, 3, ng)
        keep = rng.rand(ng) < 0.8
        fp = np.round(rng.uniform(0, 600, (10, 2))).astype(np.float32)
        db = np.concatenate([gt[keep] + rng.choice(np.asarray([0, 1, -1, 3], np.float32), (int(keep.sum()), 4)),
                             np.concatenate([fp, fp + 25], axis=1)])
        dl = np.concatenate([gl[keep], rng.randint(0, 3, 10)])
        preds.append({"boxes": torch.from_numpy(db), "labels": torch.from_numpy(dl),
                      "scores": torch.from_numpy(np.round(rng.rand(len(db)), 3).astype(np.float32))})
        targets.append({"boxes": torch.from_numpy(gt), "labels": torch.from_numpy(gl)})
    return preds, targets


def on_card(items, dev):
    return [{k: v.to(dev) for k, v in d.items()} for d in items]


def det_crowds(dev):
    """24(e): past the warp path's 1024 ground truths. An eager ``MAP`` whose
    crowd pair holds ``DET_CROWD_GTS`` (the packed G), and a
    ``RaggedEngine(MAP(), capacity=2048)`` over a crowd of
    ``DET_RAGGED_CROWD_GTS`` in two rounds (its aggregate's K9 call at G =
    2048), each on the card against the CPU port's eager ``MAP``, key for
    key; K9's ``kernels`` entries at both shapes. The eager pair's G pads to
    a multiple of 8 (1032), as JAX's packing does."""
    from metrics_tpu_torch.detection import MAP
    from metrics_tpu_torch.detection.map import _pair_geometry
    from metrics_tpu_torch.engine import RaggedEngine
    from metrics_tpu_torch.ops.kernels.match_cuda import greedy_match_cuda

    out, entries = {}, []
    preds, targets = crowd_corpus(SEED + 25, DET_CROWD_GTS)
    card, cpu = MAP(device=dev), MAP(device="cpu")
    card.update(on_card(preds, dev), on_card(targets, dev))
    cpu.update(preds, targets)
    before = greedy_match_cuda.launches
    got = det_values(card.compute())
    launches = greedy_match_cuda.launches - before
    check(launches == 1, f"24(e): the crowd's compute launched K9 {launches} times")
    same_det_values(got, det_values(cpu.compute()), "24(e): the eager crowd, card vs CPU")
    pairs = card._pack_pairs(card._get_classes(), card.max_detection_thresholds[-1])
    args = card._upload_pairs(pairs)
    ious, gt_ign, _ = _pair_geometry(args[0], args[1], args[2], args[3], args[5])
    k9_args = (ious, torch.arange(ious.shape[0], dtype=torch.int32, device=dev), args[1], args[3], gt_ign, args[4])
    check(ious.shape[2] > 1024, f"24(e): the packed G is {ious.shape[2]}: not past the warp path's 1024")
    entries.append(det_kernel_entry(k9_args, launches, "24(e) eager crowd, the block path"))
    out["eager"] = {"images": DET_CROWD_IMAGES, "crowd_gts": DET_CROWD_GTS, "G": int(ious.shape[2]),
                    "k9_launches": launches, "map": float(got["map"])}

    preds, targets = crowd_corpus(SEED + 26, DET_RAGGED_CROWD_GTS)
    eng = RaggedEngine(MAP(device=dev), num_groups=len(preds), capacity=DET_CROWD_CAPACITY)
    with eng:
        for half in (0, 1):
            for i, (p, t) in enumerate(zip(preds, targets)):
                nd, ng = len(p["labels"]), len(t["labels"])
                ds = slice(0, nd // 2) if half == 0 else slice(nd // 2, nd)
                gs = slice(0, ng // 2) if half == 0 else slice(ng // 2, ng)
                eng.submit_update(on_card([{k: v[ds] for k, v in p.items()}], dev),
                                  on_card([{k: v[gs] for k, v in t.items()}], dev), [i])
        eng.flush()
        path = eng.aggregate_path()
        before = greedy_match_cuda.launches
        t0 = time.perf_counter()
        got = det_values(eng.aggregate())
        torch.cuda.synchronize(dev)
        aggregate_ms = (time.perf_counter() - t0) * 1e3
        launches = greedy_match_cuda.launches - before
        split, k9_args = det_ragged_split(eng, dev)
    check(path[0] == "device" and launches == 1, f"24(e): the ragged crowd took {path}, {launches} K9 launches")
    cpu = MAP(device="cpu")
    cpu.update(preds, targets)
    same_det_values(got, det_values(cpu.compute()), "24(e): the ragged crowd at capacity 2048, card vs CPU")
    check(k9_args[0].shape[2] == DET_CROWD_CAPACITY, f"24(e): the aggregate's G is {k9_args[0].shape[2]}")
    entries.append(det_kernel_entry(k9_args, launches, "24(e) ragged aggregate at capacity 2048, the block path"))
    out["ragged"] = {"images": DET_CROWD_IMAGES, "crowd_gts": DET_RAGGED_CROWD_GTS, "capacity": DET_CROWD_CAPACITY,
                     "path": path[0], "k9_launches": launches, "aggregate_ms": aggregate_ms, "split": split,
                     "map": float(got["map"])}
    return out, entries


def detection_phase(dev):
    """Phase 24: detection at COCO val2017's size (module docstring). Returns
    the phase's line and K9's ``kernels`` entries, one per main-path shape."""
    from metrics_tpu_torch.ops.kernels.match_cuda import greedy_match_cuda

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    preds, targets, shape = coco_corpus()
    out = {"corpus": dict(shape, seconds=time.perf_counter() - t0)}
    out["card"], k9_args = det_card(dev, preds, targets)
    out["host"] = det_host(dev, preds[:DET_HOST_IMAGES], targets[:DET_HOST_IMAGES])
    out["ragged"], k9_corpus_args = det_ragged(dev, preds[:DET_RAGGED_IMAGES], targets[:DET_RAGGED_IMAGES])
    entries = [det_kernel_entry(k9_args, out["card"]["k9_launches"], "24(a) packed pairs"),
               det_kernel_entry(k9_corpus_args, out["ragged"]["k9_launches"], "24(c) corpus aggregate")]
    out["crowds"], crowd_entries = det_crowds(dev)
    entries += crowd_entries
    out["k9_launches_total"] = greedy_match_cuda.launches
    return out, entries


# --------------------------------------------------------- K8 and K9 alone, for a parent's kernels against the tree's

TOEPLITZ_LENGTHS = (2, 32, 256, 512, 1024)  # redesign_times: K8's step time at 1, 8 and 16 elements a lane, and above
TOEPLITZ_BATCHES = (2 * SIG_BATCH, 1000)  # one SDR update's systems, and enough to fill every SM


def redesign_inputs(dev):
    """K8's and K9's inputs at every shape the main path gives them, from the
    phases' seeds: 22(a)'s one update (``SIG_BATCH`` x 2 SDR systems of
    ``SIG_FILTER``, and PIT over SDR's ``SIG_BATCH`` systems of one pair),
    24(a)'s packed pairs and 24(c)'s corpus aggregate."""
    from metrics_tpu_torch.detection.map import _pair_geometry
    from metrics_tpu_torch.functional.audio.sdr import _compute_autocorr_crosscorr, _normalize

    preds, target, _ = speech_mixtures(dev)
    acf, xcorr = _compute_autocorr_crosscorr(_normalize(target[:SIG_BATCH]), _normalize(preds[:SIG_BATCH]),
                                             SIG_FILTER)
    k8 = {"22(a) one update": (acf.contiguous(), xcorr.contiguous())}
    # PIT over SDR solves each (estimate, source) pair's SIG_BATCH systems apart
    acf, xcorr = _compute_autocorr_crosscorr(_normalize(target[:SIG_BATCH, 0]), _normalize(preds[:SIG_BATCH, 1]),
                                             SIG_FILTER)
    k8["22(a) PIT over SDR, one pair"] = (acf.contiguous(), xcorr.contiguous())
    det_p, det_t, _ = coco_corpus()
    m, _ = det_metric(dev, det_p, det_t)
    pairs = m._pack_pairs(m._get_classes(), m.max_detection_thresholds[-1])
    args = m._upload_pairs(pairs)
    ious, gt_ign, _ = _pair_geometry(args[0], args[1], args[2], args[3], args[5])
    index = torch.arange(ious.shape[0], dtype=torch.int32, device=dev)
    k9 = {"24(a) packed pairs": (ious, index, args[1], args[3], gt_ign, args[4])}
    _, k9["24(c) corpus aggregate"] = det_ragged(dev, det_p[:DET_RAGGED_IMAGES], det_t[:DET_RAGGED_IMAGES])
    return k8, k9


def redesign_times(dev):
    """``{kernel: {shape: ms}}``: K8's and K9's median device ms at each
    main-path shape, each first held against its plain version as phases 22
    and 24 hold it, and K8's ms at ``TOEPLITZ_LENGTHS`` x ``TOEPLITZ_BATCHES``
    systems. Run it in a parent's unpacked tree (with this file copied
    over the parent's own) and in the tree, in turns, in one call."""
    from metrics_tpu_torch.ops.kernels.match_cuda import greedy_match_cuda, greedy_match_plain
    from metrics_tpu_torch.ops.kernels.toeplitz_cuda import toeplitz_solve_cuda, toeplitz_solve_plain

    k8, k9 = redesign_inputs(dev)
    out = {"toeplitz_solve": {}, "greedy_match": {}}
    for what, (r, b) in k8.items():
        got, want = toeplitz_solve_cuda(r, b), toeplitz_solve_plain(r, b)
        check(max_abs_err(got, want) <= 1e-4 * float(want.abs().max()), f"K8 vs its plain version at {what}")
        out["toeplitz_solve"][what] = gpu_ms(lambda: toeplitz_solve_cuda(r, b))
    for what, args in k9.items():
        dm, mi = greedy_match_cuda(*args)
        pdm, pmi = greedy_match_plain(*args)
        check(torch.equal(dm, pdm) and torch.equal(mi, pmi), f"K9 differs from its plain version at {what}")
        out["greedy_match"][what] = gpu_ms(lambda: greedy_match_cuda(*args), runs=10)
    # K8 at seeded SPD systems of each length and batch: (ms(L) - ms(2)) / (L - 2) is the time of one of the
    # recursion's sequential steps at that length
    out["toeplitz_solve_by_length"] = {}
    for batch in TOEPLITZ_BATCHES:
        g, by_length = torch.Generator().manual_seed(SEED + 25), {}
        for length in TOEPLITZ_LENGTHS:
            sig = torch.randn(batch, 4 * length, generator=g, dtype=torch.float64)
            spec = torch.fft.rfft(sig, n=8 * length)
            r = torch.fft.irfft(spec * spec.conj(), n=8 * length)[..., :length]
            r = (r / r[..., :1]).float().contiguous().to(dev)
            b = torch.randn(batch, length, generator=g).to(dev)
            by_length[length] = gpu_ms(lambda: toeplitz_solve_cuda(r, b))
        out["toeplitz_solve_by_length"][batch] = by_length
    return out


# --------------------------------------------------------- phase 25: serving on a mesh
MESH_WORLD = 4  # JAX's mesh engines run at W = 8 on a TPU host: the one cut
MESH_BENCH_BATCHES = 192  # metrics_tpu/engine/mesh_bench.py's protocol
MESH_BENCH_TRIALS = 3  # interleaved (step, deferred) pairs after one warm-up stream each (JAX: 5)
MESH_PAGED_BATCHES = 320  # metrics_tpu/engine/stream_bench.py's protocol, over phase 9's traffic
MESH_RESIDENT = RESIDENT // MESH_WORLD  # 32 slots a shard (JAX's 16 at W = 8): 128 in all
MESH_SCAN_BATCHES = 40  # 25(e): the prefix of phase 7's traffic the scan members take
MESH_SHARD_LOSS_AT = 40  # 25(d): the shard_loss occurrence that kills a shard
MESH_DIR = Path(__file__).resolve().parent / "build" / "phase25"  # gitignored; removed after the phase


def mesh_layout(dev):
    """The phase's W = 4 mesh: cuda:0..3 when the machine has four cards
    (the NCCL transport), else four shards on ``dev`` (one device)."""
    from metrics_tpu_torch.parallel.mesh import MeshConfig

    n = torch.cuda.device_count() if dev.type == "cuda" else 0
    devs = [torch.device("cuda", i) for i in range(MESH_WORLD)] if n >= MESH_WORLD else [dev] * MESH_WORLD
    return MeshConfig(shape=(MESH_WORLD,), devices=devs).make_mesh()


def mesh_engine(dev, mesh, mode, make=make_collection, **cfg):
    from metrics_tpu_torch.engine import EngineConfig, StreamingEngine

    cfg = dict(dict(buckets=(256, BUCKET), kernel_backend="megastep"), **cfg)
    return StreamingEngine(make(dev), EngineConfig(mesh=mesh, mesh_sync=mode, **cfg))


def submit_rows(preds, target):
    return lambda e, b: e.submit(preds[b[0]:b[1]], target[b[0]:b[1]])


def sync_devices(mesh):
    for d in set(mesh.device_list()):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def mesh_flagship(dev, preds, target, gpu_state, mesh):
    """25(a): phase 7's engine and traffic (125 ragged batches, buckets 256
    and 1024, K5 on every shard) at W = 4 under step and deferred sync. The
    states equal phase 7's world-1 engine (the one-shot state) bit for bit:
    every float state of the flagship is a count. A step-sync step issues
    ``fused_sync_plan``'s collectives, a deferred one none; the boundary
    merge issues the plan's. Host ms a step, and the merge's ms."""
    from metrics_tpu_torch.parallel.collectives import collective_counts, fused_sync_plan, reset_collective_counts

    batches = ragged_batches(SEED + 2, 16, BUCKET)
    plan = fused_sync_plan(make_collection(dev).sync_leaf_info(), MESH_WORLD)["collectives"]
    out = {"plan_collectives": plan}
    for mode in ("step", "deferred"):
        eng = mesh_engine(dev, mesh, mode)
        reset_collective_counts()
        before = counts()
        seconds = run_engine(eng, True, batches, submit_rows(preds, target))
        steady = sum(collective_counts().values())
        d = delta(before)
        per_shard = MESH_WORLD * eng.steps + eng.stats.warmup_steps
        check(d["megastep_fold"] == 2 * per_shard and d["fold_rows"] == 0 and d["histogram"] == per_shard,
              f"25(a) {mode}: {d} in {eng.steps} steps of {MESH_WORLD} shards")
        check(steady == (plan * eng.steps if mode == "step" else 0),
              f"25(a) {mode}: {steady} collectives in {eng.steps} steps (plan {plan} a step-sync step)")
        reset_collective_counts()
        t0 = time.perf_counter()
        state = eng.state()
        sync_devices(mesh)
        read_ms = (time.perf_counter() - t0) * 1e3
        merge = sum(collective_counts().values())
        check(merge == (plan if mode == "deferred" else 0), f"25(a) {mode}: the read issued {merge} collectives")
        compare_states(state, gpu_state, f"25(a) {mode} sync vs phase 7 (world 1)")
        st = eng.stats.summary()["mesh_sync"]
        check(st["transport"] == mesh.transport, f"25(a): transport {st['transport']}")
        out[mode] = {"seconds": seconds, "steps": eng.steps, "warmup_steps": eng.stats.warmup_steps,
                     "host_ms_per_step": seconds / eng.steps * 1e3, "collectives_per_step": steady / eng.steps,
                     "launches": d, "merge_collectives": merge, "state_read_ms": read_ms,
                     "merges": st["merges"], "merge_ms_total": st["merge_us_total"] / 1e3,
                     "sync_payload_bytes": st.get("sync_payload_bytes")}
    return out


def mesh_bench(dev, mesh):
    """25(b): ``mesh_bench.py``'s protocol at W = 4: 192 seeded batches of
    64-256 rows, buckets (256,), ``Accuracy + MeanSquaredError``,
    ``coalesce=1``, ``in_flight=1``; one warm-up stream per mode, then
    interleaved (step, deferred) streams through ``reset()``, each ended by
    flush and a host fetch of the value (the deferred merge inside the timed
    region), with no capture after the warm-up in either mode (JAX's
    zero-compile pin). Steps/s per mode and the step/deferred time ratio."""
    from metrics_tpu_torch import Accuracy, MeanSquaredError, MetricCollection

    rng = np.random.RandomState(20260803)
    sizes = rng.randint(64, 257, size=MESH_BENCH_BATCHES)
    batches = [(rng.rand(n).astype(np.float32), (rng.rand(n) > 0.5).astype(np.int32)) for n in sizes]
    make = lambda d: MetricCollection([Accuracy(device=d), MeanSquaredError(device=d)])  # noqa: E731
    engines = {mode: mesh_engine(dev, mesh, mode, make, buckets=(256,), kernel_backend=None, coalesce=1, in_flight=1,
                                 max_queue=MESH_BENCH_BATCHES + 1) for mode in ("step", "deferred")}

    def stream(eng):
        t0 = time.perf_counter()
        for b in batches:
            eng.submit(*b)
        value = {k: float(v) for k, v in eng.result().items()}
        return time.perf_counter() - t0, value

    times = {mode: [] for mode in engines}
    values = {}
    for eng in engines.values():
        eng.start()
        stream(eng)  # the warm-up: every capture
    warm_misses = {m: e.aot_cache.misses for m, e in engines.items()}
    for _ in range(MESH_BENCH_TRIALS):
        for mode, eng in engines.items():
            eng.reset()
            t, values[mode] = stream(eng)
            times[mode].append(t)
    for eng in engines.values():
        eng.stop()
    p = np.concatenate([b[0] for b in batches])
    t = np.concatenate([b[1] for b in batches])
    want = {"Accuracy": float(np.mean((p >= 0.5) == t)), "MeanSquaredError": float(np.mean((p - t) ** 2))}
    for mode, v in values.items():
        for k, w in want.items():
            check(abs(v[k] - w) <= 1e-6 * max(1.0, abs(w)), f"25(b) {mode}: {k} {v[k]} != {w}")
    # mesh_bench.py's pin: no program is captured after the warm-up, in either mode
    steady_misses = {m: e.aot_cache.misses - warm_misses[m] for m, e in engines.items()}
    for mode, n in steady_misses.items():
        check(n == 0, f"25(b) {mode}: {n} captures in the timed streams")
    steps = {mode: len(batches) for mode in engines}
    total = {mode: sum(ts) for mode, ts in times.items()}
    return {"batches": len(batches), "trials": MESH_BENCH_TRIALS, "stream_s": times,
            "steps_per_s": {m: steps[m] * len(times[m]) / total[m] for m in total},
            "step_over_deferred_time": total["step"] / total["deferred"],
            "warmup_misses": warm_misses, "steady_misses": steady_misses}


def mesh_paged(dev, preds, target, mesh):
    """25(c): ``stream_bench.py``'s tenancy over the first 320 batches of
    phase 9's traffic (10 000 streams, Zipf 1.05, buckets 64 and 256): the
    stream-sharded engine at W = 4 with 32 slots a shard against phase 9's
    world-1 engine with 128, exact and q8-staged. Counts equal stream for
    stream; the q8 policy's float counts within the codec's bound (each
    encode moves an element by at most its block's absmax / 254 <= n_s /
    254, and the two runs encode a stream's row at most 2 b_s + 2 times
    between them, b_s its batches). Page-ins and page-outs per shard."""
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine

    batches = ragged_batches(SEED + 4, 8, 64)
    sids = zipf_stream_ids(PAGED_STREAMS, len(batches), ALPHA, SEED + 4)[:MESH_PAGED_BATCHES]
    traffic = list(zip(sids, batches[:MESH_PAGED_BATCHES]))
    submit = lambda e, b: e.submit(int(b[0]), preds[b[1][0]:b[1][1]], target[b[1][0]:b[1][1]])  # noqa: E731
    rows, hits = {}, {}
    for sid, (lo, hi) in traffic:
        rows[int(sid)] = rows.get(int(sid), 0) + hi - lo
        hits[int(sid)] = hits.get(int(sid), 0) + 1
    touched = sorted(rows)
    out = {"streams": PAGED_STREAMS, "batches": len(traffic), "touched": len(touched)}
    for q8 in (False, True):
        engs = {}
        for name, world in (("world_1", 1), ("mesh", MESH_WORLD)):
            cfg = dict(buckets=PAGED_BUCKETS, kernel_backend="megastep", compress_payloads=q8, coalesce=1)
            if world > 1:
                cfg.update(mesh=mesh, mesh_sync="deferred")
            engs[name] = MultiStreamEngine(make_collection(dev, ap_precision="q8_block" if q8 else None),
                                           PAGED_STREAMS, EngineConfig(**cfg), stream_shard=True,
                                           resident_streams=RESIDENT // world)
        before = counts()
        seconds = run_engine(engs["mesh"], True, traffic, submit)
        d = delta(before)
        w1_seconds = run_engine(engs["world_1"], True, traffic, submit)
        mesh_eng = engs["mesh"]
        key = "megastep_segment_q8" if q8 else "megastep_segment"
        check(d[key] > 0 and d["segment_reduce"] == 0, f"25(c) q8={q8}: {d}")
        x, y = stacked_host(mesh_eng), stacked_host(engs["world_1"])
        idx = np.asarray(touched + [s for s in range(0, PAGED_STREAMS, 97) if s not in rows][:20], np.int64)
        bound = np.asarray([(2 * hits.get(int(s), 0) + 2) * rows.get(int(s), 0) / 254.0 for s in idx])
        worst = 0.0
        for k in x:
            for s in x[k]:
                g, w = x[k][s][idx], y[k][s][idx]
                check(g.dtype == w.dtype and g.shape == w.shape, f"25(c) q8={q8}: {k}.{s} dtype/shape")
                if not (q8 and w.dtype.kind == "f"):
                    check(np.array_equal(g, w), f"25(c) q8={q8}: {k}.{s} differs from the world-1 engine")
                    continue
                err = np.abs(g.astype(np.float64) - w).reshape(len(idx), -1).max(axis=1)
                worst = max(worst, float(err.max()))
                check(bool(np.all(err <= bound + 1e-3)), f"25(c) q8={q8}: {k}.{s} past the q8 bound")
        st = mesh_eng.stats
        check(st.page_outs > 0 and st.routed_steps > 0, f"25(c) q8={q8}: nothing spilled at W = {MESH_WORLD}")
        if q8:
            check(st.q8_staged_rows > 0, "25(c): no row was staged for K7 at W = 4")
        out["q8" if q8 else "exact"] = {
            "seconds": seconds, "steps": mesh_eng.steps, "host_ms_per_step": seconds / mesh_eng.steps * 1e3,
            "world_1_seconds": w1_seconds, "world_1_steps": engs["world_1"].steps, "launches": d,
            "pages_by_shard": mesh_eng.pages_by_shard(), "page_ins": st.page_ins, "page_outs": st.page_outs,
            "world_1_page_ins": engs["world_1"].stats.page_ins, "world_1_page_outs": engs["world_1"].stats.page_outs,
            "q8_staged_rows": st.q8_staged_rows, "q8_max_abs_err": worst}
    # the unsharded form under deferred sync: phase 8's 64 streams, K4 on every shard
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine

    ms_batches = ragged_batches(SEED + 3, 16, BUCKET)
    ms_traffic = list(zip(zipf_stream_ids(MS_STREAMS, len(ms_batches), ALPHA, SEED + 3), ms_batches))
    engs = {name: MultiStreamEngine(make_collection(dev), MS_STREAMS, EngineConfig(buckets=(256, BUCKET), **cfg))
            for name, cfg in (("world_1", {}), ("mesh", dict(mesh=mesh, mesh_sync="deferred")))}
    before = counts()
    seconds = run_engine(engs["mesh"], True, ms_traffic, submit)
    d = delta(before)
    run_engine(engs["world_1"], True, ms_traffic, submit)
    n_leaves = engs["world_1"].arena_layout.num_leaves
    per_shard = MESH_WORLD * engs["mesh"].steps + engs["mesh"].stats.warmup_steps
    check(d["segment_reduce"] == n_leaves * per_shard, f"25(c) unsharded: {d} in {engs['mesh'].steps} steps")
    engine_states_equal(engs["mesh"], engs["world_1"], range(MS_STREAMS), "25(c) unsharded deferred vs world 1")
    out["unsharded"] = {"streams": MS_STREAMS, "seconds": seconds, "steps": engs["mesh"].steps,
                        "host_ms_per_step": seconds / engs["mesh"].steps * 1e3, "launches": d,
                        "merge_ms": engs["mesh"].stats.merge_us_total / 1e3}
    return out


def elastic_injector(pe):
    """JAX's canonical ``elastic`` plan (``chaos_smoke.chaos_injectors``, seed 37)."""
    return pe.FaultInjector(37, {"admission": pe.FaultSpec(schedule=(1,)), "shard_loss": pe.FaultSpec(schedule=(2,)),
                                 "reshard_snapshot": pe.FaultSpec(schedule=(0,)),
                                 "reshard_restore": pe.FaultSpec(schedule=(0,))})


def mesh_reshard(dev, preds, target, gpu_state, mesh):
    """25(d): under (a)'s traffic on the deferred engine: ``reshard(world=2)``
    at the half, then back to 4; JAX's ``elastic`` plan (an admission and a
    transient shard-loss retry, both reshard sites firing once under a
    manual reshard); a non-transient ``shard_loss`` with
    ``elastic_min_world=2``, after which the engine serves on at world 2.
    Each ends equal to the fault-free state (the one-shot). Then the
    snapshot matrix of the 4-shard deferred engine: verbatim at 4, merged
    into a world-1 engine."""
    import metrics_tpu_torch.engine as pe

    batches = ragged_batches(SEED + 2, 16, BUCKET)
    submit = submit_rows(preds, target)
    half = len(batches) // 2
    out = {}
    # the live reshard, 4 -> 2 -> 4
    eng = mesh_engine(dev, mesh, "deferred", snapshot_dir=str(mesh_dir("d")))
    with eng:
        for b in batches[:half]:
            submit(eng, b)
        eng.flush()
        ms = []
        for w in (2, MESH_WORLD):
            t0 = time.perf_counter()
            info = eng.reshard(world=w)
            sync_devices(mesh)
            ms.append((time.perf_counter() - t0) * 1e3)
            check(info["to_world"] == w, f"25(d): reshard gave {info}")
        for b in batches[half:]:
            submit(eng, b)
    compare_states(eng.state(), gpu_state, "25(d) reshard 4 -> 2 -> 4 vs uninterrupted")
    out["reshard"] = {"ms_4_to_2": ms[0], "ms_2_to_4": ms[1], "reshards": eng.stats.reshards}
    # the snapshot matrix
    path = eng.snapshot()
    twin = mesh_engine(dev, mesh, "deferred")
    meta = twin.restore(path)
    check(meta["world"] == MESH_WORLD and meta["mesh_sync"] == "deferred", f"25(d): snapshot meta {meta}")
    a, b = twin._stacked_carried(), eng._stacked_carried()
    check(all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a), "25(d): the world-4 restore is not verbatim")
    single = pe.StreamingEngine(make_collection(dev), pe.EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep"))
    single.restore(path)
    compare_states(single.state(), gpu_state, "25(d): deferred W = 4 snapshot merged into a world-1 engine")
    # JAX's elastic plan: every site fires once, the result is the fault-free one
    inj = elastic_injector(pe)
    eng = mesh_engine(dev, mesh, "deferred", coalesce=1, fault_injector=inj,
                      admission=pe.AdmissionPolicy(rows_per_s=1e9, burst_rows=1e9))
    with eng:
        for i, b in enumerate(batches):
            submit(eng, b)
            if i < 4:
                eng.flush()  # the plan's occurrences stay producer-timing-independent
            if i == half:
                eng.flush()
                eng.reshard(world=2)
    compare_states(eng.state(), gpu_state, "25(d) elastic plan vs fault-free")
    check(all(inj.fired.get(k, 0) == 1 for k in ("admission", "shard_loss", "reshard_snapshot", "reshard_restore")),
          f"25(d): elastic sites fired {dict(inj.fired)}")
    out["elastic"] = {"fired": dict(inj.fired), "retries": eng.stats.retries, "rollbacks": eng.stats.rollbacks,
                      "world": eng._world}
    # a shard lost for good: the engine serves on at world 2
    for mode in ("step", "deferred"):
        inj = pe.FaultInjector(0, {"shard_loss": pe.FaultSpec(schedule=(MESH_SHARD_LOSS_AT,), transient=False)})
        eng = mesh_engine(dev, mesh, mode, fault_injector=inj, elastic_min_world=2)
        seconds = run_engine(eng, True, batches, submit)
        compare_states(eng.state(), gpu_state, f"25(d) {mode}: shard loss vs fault-free")
        check(eng._world == 2 and eng.stats.shard_losses == 1, f"25(d) {mode}: world {eng._world} after the loss")
        walls = [r["wall_us"] for r in eng.stats.recent()]
        out[f"shard_loss_{mode}"] = {"seconds": seconds, "steps": eng.steps, "world_after": eng._world,
                                     "recovery_step_ms": max(walls) / 1e3,
                                     "median_step_ms": float(np.median(walls)) / 1e3,
                                     "reshard": eng.stats.reshard_summary()}
    return out


def mesh_scan(dev, preds, target, preds_np, target_np, mesh):
    """25(e): ``AUROC(capacity=N)`` and ``AveragePrecision(capacity=N)`` served
    under deferred sync at W = 4 over the first 40 batches of phase 7's
    traffic, capacity per shard; the boundary merge gathers the shards'
    buffers, and the values equal phase 11's eager capacity update over the
    same rows. The 4-shard snapshot refuses to restore into a 2-shard engine
    (the cat buffers scale with the world), and a live ``reshard(world=2)``
    refuses and rolls back: the engine serves on at 4, its state unchanged."""
    from metrics_tpu_torch import AUROC, AveragePrecision, MetricCollection
    from metrics_tpu_torch.parallel.collectives import collective_counts, reset_collective_counts
    from metrics_tpu_torch.utils.exceptions import MetricsTPUUserError

    batches = ragged_batches(SEED + 2, 16, BUCKET)[:MESH_SCAN_BATCHES]
    rows = batches[-1][1]
    make = lambda d: MetricCollection({  # noqa: E731
        "auroc": AUROC(num_classes=NUM_CLASSES, capacity=rows, device=d),
        "ap": AveragePrecision(num_classes=NUM_CLASSES, capacity=rows, device=d)})
    eng = mesh_engine(dev, mesh, "deferred", make, snapshot_dir=str(mesh_dir("e")))
    before = counts()
    seconds = run_engine(eng, True, batches, submit_rows(preds, target))
    d = delta(before)
    reset_collective_counts()
    values = eng.result()
    gathers = collective_counts()["all_gather"]
    check(gathers == 1, f"25(e): the merge issued {gathers} gathers")
    eager = make(dev)
    eager.update(preds[:rows], target[:rows])
    want = eager.compute()
    errs = {}
    for k in want:
        errs[k] = float((values[k].double().cpu() - want[k].double().cpu()).abs().max())
        check(errs[k] <= 1e-6, f"25(e): {k} {float(values[k])} != eager {float(want[k])}")
    state = eng.state()
    check(state["auroc"]["preds_buf"].shape[0] == MESH_WORLD * rows, "25(e): the merged buffer is not W x capacity")
    path = eng.snapshot()
    other = mesh_engine(dev, mesh_of(mesh, 2), "deferred", make)
    refused = None
    try:
        other.restore(path)
    except MetricsTPUUserError as e:
        refused = str(e)
    check(refused is not None and "cat" in refused, "25(e): a 4-shard cat snapshot restored into 2 shards")
    before_state = {k: v.clone() for k, v in eng._stacked_carried().items()}
    try:
        eng.reshard(world=2)
        resharded = True
    except MetricsTPUUserError:
        resharded = False
    check(not resharded and eng._world == MESH_WORLD, "25(e): reshard of cat states did not refuse")
    after = eng._stacked_carried()
    check(all(torch.equal(before_state[k], after[k]) for k in after), "25(e): the refused reshard moved the state")
    again = eng.result()
    check(all(torch.equal(again[k], values[k]) for k in values), "25(e): the engine no longer serves its value")
    return {"batches": len(batches), "rows": rows, "seconds": seconds, "steps": eng.steps,
            "host_ms_per_step": seconds / eng.steps * 1e3, "launches": d, "merge_ms": eng.stats.merge_us_total / 1e3,
            "max_abs_err": errs, "refusal": refused}


def mesh_of(mesh, world):
    """A ``world``-shard mesh on the same layout."""
    from metrics_tpu_torch.parallel.mesh import MeshConfig

    devs = mesh.device_list()
    return MeshConfig(shape=(world,), devices=devs[:world] if mesh.transport == "nccl" else devs[:1] * world).make_mesh()


def mesh_dir(name):
    d = MESH_DIR / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def mesh_phase(dev, preds, target, preds_np, target_np, gpu_state):
    """Phase 25: serving on a mesh at W = 4, (a)-(e); the line names the
    layout and the transport."""
    mesh = mesh_layout(dev)
    out = {"world": MESH_WORLD, "layout": [str(d) for d in mesh.device_list()], "transport": mesh.transport}
    try:
        for name, fn in (("flagship", lambda: mesh_flagship(dev, preds, target, gpu_state, mesh)),
                         ("bench", lambda: mesh_bench(dev, mesh)),
                         ("paged", lambda: mesh_paged(dev, preds, target, mesh)),
                         ("reshard", lambda: mesh_reshard(dev, preds, target, gpu_state, mesh)),
                         ("scan", lambda: mesh_scan(dev, preds, target, preds_np, target_np, mesh))):
            t0 = time.perf_counter()
            out[name] = fn()
            out[name]["phase_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    return out


# ------------------------------------------------------------ phase 26: the mesh forms that remain

MESH_WIN_PAGED_BATCHES = 800  # 26(b): 19(d)'s prefix of phase 9's traffic
MESH_WIN_PAGED_PANE = 300  # 26(b): batches per tumbling pane (two rotations: the open pane is [600, 800))
MESH_EMB_TOL = 1e-4  # 26(e): FID, KID and IS at W = 4 against phase 23's world-1 values, relative
MESH_BERT_TOL = 1e-5  # 26(e): BERTScore's P/R/F1 at W = 4 against phase 21's, absolute
MESH_PIPE_TOL = 1e-4  # 26(e): the pipeline host's hidden states against the world-1 encoder's, absolute
MESH_PIPE_PAIRS = 256  # 26(e): the pairs whose token rows go through the pipeline host
MESH_PIPE_BUCKET = 64  # 26(e): the pipeline host's one bucket, four microbatches of 16 rows
MESH_HOST_REPS = 4  # 26(e): requests a turn, the hosts' pieces captured against eager across cards


def on_mesh(mesh):
    """The engine config of deferred sync on ``mesh`` (world 1 without one)."""
    return dict(mesh=mesh, mesh_sync="deferred") if mesh is not None else {}


def mesh_windows(dev, preds, target, mesh):
    """26(a): phase 19's tumbling (16 batches, 3 panes) and sliding (3 panes
    of 16) rings on phase 7's engine and traffic, deferred at W = 4, in
    lockstep with the same rings at world 1: after every rotation the merged
    pane-stacked states equal world 1's bit for bit (every float state of
    the flagship is a count), and the window's value at the end too. A
    cumulative deferred engine warms the cache first; the windowed engines
    replay its graphs (a pane row is the step's target) and capture nothing
    across their rotations. Host ms a warm step, windowed against
    cumulative, at W = 4."""
    from metrics_tpu_torch.engine import AotCache, WindowPolicy

    batches = ragged_batches(SEED + 2, 16, BUCKET)
    submit = submit_rows(preds, target)
    aot_mesh, aot_one = AotCache(), AotCache()
    for aot, m in ((aot_mesh, mesh), (aot_one, None)):
        run_engine(windowed_engine(dev, None, aot, **on_mesh(m)), True, batches, submit)
    warm = aot_mesh.misses
    out = {"warmup_captures": warm}
    policies = {"tumbling": lambda: WindowPolicy.tumbling(pane_batches=WIN_PANE, n_panes=WIN_TUMBLING),
                "sliding": lambda: WindowPolicy.sliding(n_panes=WIN_SLIDE, pane_batches=WIN_PANE)}
    for kind, policy in policies.items():
        eng, ref = windowed_engine(dev, policy(), aot_mesh, **on_mesh(mesh)), windowed_engine(dev, policy(), aot_one)
        before = counts()
        checked = 0
        t0 = time.perf_counter()
        with eng, ref:
            for i, b in enumerate(batches):
                submit(eng, b)
                submit(ref, b)
                if (i + 1) % WIN_PANE == 0:
                    eng.flush()
                    ref.flush()
                    check(eng.rotations == ref.rotations == (i + 1) // WIN_PANE, f"26(a) {kind}: rotations")
                    compare_states(eng.state(), ref.state(), f"26(a) {kind} after rotation {eng.rotations}")
                    checked += 1
            bit_equal_values(eng.result(), ref.result(), f"26(a) {kind}: the window's value")
        seconds = time.perf_counter() - t0
        d = delta(before)
        check(eng.stats.warmup_steps == 0 and aot_mesh.misses == warm,
              f"26(a) {kind}: {eng.stats.warmup_steps} captures across {eng.rotations} rotations")
        check(d["megastep_fold"] > 0 and d["fold_rows"] == 0, f"26(a) {kind}: launches {d}")
        check(eng.stats.kernel_fallbacks_by_reason() == {}, f"26(a) {kind}: the windowed mesh engine fell back")
        out[kind] = {"rotations_checked": checked, "rotations": eng.rotations, "steps": eng.steps,
                     "captures": eng.stats.warmup_steps, "lockstep_s": seconds, "launches": d,
                     "merges": eng.stats.merges}
    # host ms a warm step at W = 4: cumulative, sliding, sliding, cumulative
    cost = {"cumulative": [], "windowed": []}
    for kind in ("cumulative", "windowed", "windowed", "cumulative"):
        eng = windowed_engine(dev, policies["sliding"]() if kind == "windowed" else None, aot_mesh, **on_mesh(mesh))
        seconds = run_engine(eng, True, batches, submit)
        check(eng.stats.warmup_steps == 0, f"26(a) timing: the warm {kind} engine captured")
        cost[kind].append(seconds / eng.steps * 1e3)
    out["host_ms_per_step"] = cost
    return out


def mesh_window_paged(dev, preds, target, mesh):
    """26(b): phase 25(c)'s tenancy (10 000 streams, Zipf 1.05, 32 slots a
    shard, exact) on 19(d)'s 800-batch prefix of phase 9's traffic under
    ``tumbling(300 batches, 2 panes)``, stream-sharded at W = 4 (stream
    ``sid`` on shard ``sid % 4`` at pager row ``(sid // 4) * 2 + pane``)
    against the same ring at world 1 with 128 slots: every stream's two pane
    rows bit-equal; page-ins and page-outs by shard."""
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, WindowPolicy

    batches = ragged_batches(SEED + 4, 8, 64)
    sids = zipf_stream_ids(PAGED_STREAMS, len(batches), ALPHA, SEED + 4)[:MESH_WIN_PAGED_BATCHES]
    traffic = list(zip(sids, batches[:MESH_WIN_PAGED_BATCHES]))
    submit = lambda e, b: e.submit(int(b[0]), preds[b[1][0]:b[1][1]], target[b[1][0]:b[1][1]])  # noqa: E731
    engs, runs = {}, {}
    for name, world in (("mesh", MESH_WORLD), ("world_1", 1)):
        cfg = dict(buckets=PAGED_BUCKETS, kernel_backend="megastep", coalesce=1,
                   window=WindowPolicy.tumbling(pane_batches=MESH_WIN_PAGED_PANE, n_panes=2))
        if world > 1:
            cfg.update(mesh=mesh, mesh_sync="deferred")
        engs[name] = MultiStreamEngine(make_collection(dev), PAGED_STREAMS, EngineConfig(**cfg), stream_shard=True,
                                       resident_streams=RESIDENT // world)
        before = counts()
        runs[name] = (run_engine(engs[name], True, traffic, submit), delta(before))
    eng, one = engs["mesh"], engs["world_1"]
    check(eng.rotations == one.rotations == MESH_WIN_PAGED_BATCHES // MESH_WIN_PAGED_PANE,
          f"26(b): {eng.rotations} rotations")
    check(runs["mesh"][1]["megastep_segment"] > 0 and runs["mesh"][1]["segment_reduce"] == 0,
          f"26(b): launches {runs['mesh'][1]}")
    x, y = stacked_host(eng), stacked_host(one)
    for k in y:
        for s in y[k]:
            check(x[k][s].shape == y[k][s].shape and x[k][s].dtype == y[k][s].dtype
                  and np.array_equal(x[k][s], y[k][s]), f"26(b): {k}.{s} differs from the world-1 ring")
    st = eng.stats
    check(st.page_outs > 0 and st.routed_steps > 0, "26(b): nothing spilled at W = 4")
    return {"batches": len(traffic), "rotations": eng.rotations, "seconds": runs["mesh"][0], "steps": eng.steps,
            "host_ms_per_step": runs["mesh"][0] / eng.steps * 1e3, "world_1_seconds": runs["world_1"][0],
            "world_1_steps": one.steps, "launches": runs["mesh"][1], "pages_by_shard": eng.pages_by_shard(),
            "page_ins": st.page_ins, "page_outs": st.page_outs, "world_1_page_ins": one.stats.page_ins,
            "world_1_page_outs": one.stats.page_outs}


def mesh_window_reshard(dev, preds, target, mesh):
    """26(c): 26(a)'s sliding ring at W = 4 resharded 4 -> 2 -> 4 half a pane
    into its fourth pane (the world axis merged, the panes and the cursor
    kept), then served to the end; and the same ring losing a shard for good
    under ``elastic_min_world=2``, serving on at world 2. Both end bit-equal
    to the uninterrupted world-1 ring."""
    import metrics_tpu_torch.engine as pe
    from metrics_tpu_torch.engine import AotCache

    batches = ragged_batches(SEED + 2, 16, BUCKET)
    submit = submit_rows(preds, target)
    window = lambda: pe.WindowPolicy.sliding(n_panes=WIN_SLIDE, pane_batches=WIN_PANE)  # noqa: E731
    ref = windowed_engine(dev, window(), AotCache())
    run_engine(ref, True, batches, submit)
    want = ref.state()
    at = min(3 * WIN_PANE + WIN_PANE // 2, len(batches) // 2)  # half a pane into the fourth pane
    eng = windowed_engine(dev, window(), AotCache(), **on_mesh(mesh))
    ms = []
    with eng:
        for b in batches[:at]:
            submit(eng, b)
        eng.flush()
        cursor = eng.pane_cursor
        for w in (2, MESH_WORLD):
            t0 = time.perf_counter()
            info = eng.reshard(world=w)
            sync_devices(mesh)
            ms.append((time.perf_counter() - t0) * 1e3)
            check(info["to_world"] == w and info["cursor"] == at and eng.pane_cursor == cursor,
                  f"26(c): reshard gave {info}, cursor {eng.pane_cursor}")
        for b in batches[at:]:
            submit(eng, b)
    compare_states(eng.state(), want, "26(c): the ring resharded 4 -> 2 -> 4 mid-pane vs world 1")
    bit_equal_values(eng.result(), ref.result(), "26(c): the resharded ring's value")
    out = {"at_batch": at, "cursor": cursor, "ms_4_to_2": ms[0], "ms_2_to_4": ms[1]}
    inj = pe.FaultInjector(0, {"shard_loss": pe.FaultSpec(schedule=(MESH_SHARD_LOSS_AT,), transient=False)})
    lost = windowed_engine(dev, window(), AotCache(), fault_injector=inj, elastic_min_world=2, **on_mesh(mesh))
    seconds = run_engine(lost, True, batches, submit)
    check(lost._world == 2 and lost.stats.shard_losses == 1, f"26(c): world {lost._world} after the loss")
    compare_states(lost.state(), want, "26(c): the ring after a lost shard vs world 1")
    out["shard_loss"] = {"seconds": seconds, "steps": lost.steps, "world_after": lost._world,
                         "rotations": lost.rotations}
    return out


def mesh_ragged(dev, mesh):
    """26(d): ``ragged_bench.py``'s protocols at W = 4. (i) 512 Zipf groups,
    240 batches, buckets (8, 24) through the deferred-mesh
    ``RaggedEngine(RetrievalMAP())``: the aggregate (four K1 folds on the
    merged state) equals its oracle and the world-1 engine's, every group's
    value and count too. (ii) the 10^6-group universe (200 000 Zipf(1.2)
    rows, capacity 16) through ``group_shard`` with 8 192 resident groups a
    shard: the capacity-blocked sweep over every shard's touched rows, one
    K4 block per 1 024 touched groups, its value the eager segment path's
    (the world-1 sweep's reference in 20(d)). Ingest, aggregate and sweep ms,
    K1 and K4 launches."""
    import metrics_tpu_torch as mp
    from metrics_tpu_torch.engine import EngineConfig, RaggedEngine
    from metrics_tpu_torch.engine.ragged import _AGG_BLOCK_ROWS
    from metrics_tpu_torch.ops.kernels.fold_cuda import fold_rows_cuda
    from metrics_tpu_torch.ops.kernels.segment_cuda import segment_reduce_cuda

    traffic, capacity, touched = ragged_traffic()
    engs = {name: RaggedEngine(mp.RetrievalMAP(device=dev), num_groups=RAG_GROUPS, capacity=capacity,
                               config=EngineConfig(buckets=RAG_BUCKETS, **cfg))
            for name, cfg in (("mesh", dict(mesh=mesh, mesh_sync="deferred")), ("world_1", {}))}
    out = {}
    with engs["mesh"], engs["world_1"]:
        ingest_s = rag_serve(engs["mesh"], traffic, binary_target)
        rag_serve(engs["world_1"], traffic, binary_target)
        k1 = fold_rows_cuda.launches
        t0 = time.perf_counter()
        value = float(engs["mesh"].aggregate())
        first_ms = (time.perf_counter() - t0) * 1e3
        k1_first = fold_rows_cuda.launches - k1
        agg_ms = rag_timed(lambda: float(engs["mesh"].aggregate()))
        oracle = float(engs["mesh"].aggregate(oracle=True))
        one = float(engs["world_1"].aggregate())
        per = engs["mesh"].results()
        per_one = engs["world_1"].results()
        counts_mesh = engs["mesh"].state()["count"].cpu()
        counts_one = engs["world_1"].state()["count"].cpu()
        steps = engs["mesh"].steps
    check(engs["mesh"].aggregate_path() == ("device", "batched fold over the stacked buffers"), "26(d): the path")
    check(k1_first == 4, f"26(d): {k1_first} K1 launches in the first aggregate, not 4")
    check(torch.equal(counts_mesh, counts_one), "26(d): the merged counts differ from world 1's")
    per_err = max(abs(float(per[g]) - float(per_one[g])) for g in range(RAG_GROUPS))
    check(per_err <= 1e-6, f"26(d): per-group values {per_err} from world 1's")
    out["zipf"] = {"groups": RAG_GROUPS, "batches": len(traffic), "touched": touched, "capacity": capacity,
                   "value": value, "ingest_s": ingest_s, "steps": steps, "host_ms_per_step": ingest_s / steps * 1e3,
                   "first_aggregate_ms": first_ms, "aggregate_ms": agg_ms, "k1_per_aggregate": k1_first,
                   "merges": engs["mesh"].stats.merges, "per_group_max_abs_err": per_err,
                   "rel_err": {"oracle": rel_close(value, oracle, "26(d): the mesh aggregate vs its oracle"),
                               "world_1": rel_close(value, one, "26(d): the mesh aggregate vs world 1's")}}
    # (ii) the million-group universe, group_shard at W = 4
    preds, target, gids = paged_ragged_rows()
    n, touched = int(gids.size), int(np.unique(gids).size)
    eng = RaggedEngine(mp.RetrievalMAP(device=dev), num_groups=RAG_PAGED_GROUPS, capacity=RAG_PAGED_CAPACITY,
                       config=EngineConfig(buckets=RAG_PAGED_BUCKETS, mesh=mesh, mesh_sync="deferred"),
                       group_shard=True, resident_groups=RAG_PAGED_RESIDENT)
    with eng:
        t0 = time.perf_counter()
        for lo in range(0, n, RAG_PAGED_CHUNK):
            eng.submit(gids[lo:lo + RAG_PAGED_CHUNK], preds[lo:lo + RAG_PAGED_CHUNK], target[lo:lo + RAG_PAGED_CHUNK])
        eng.flush()
        ingest_s = time.perf_counter() - t0
        check(eng.aggregate_path()[0] == "device", "26(d): the paged aggregate did not take the device sweep")
        blocks0 = eng.stats.ragged_summary()["agg_blocks"]
        k1, k4 = fold_rows_cuda.launches, segment_reduce_cuda.launches
        t0 = time.perf_counter()
        value = float(eng.aggregate())
        first_ms = (time.perf_counter() - t0) * 1e3
        blocks = eng.stats.ragged_summary()["agg_blocks"] - blocks0
        k1_first, k4_first = fold_rows_cuda.launches - k1, segment_reduce_cuda.launches - k4
        sweep_ms = rag_timed(lambda: float(eng.aggregate()), runs=3)
        st = eng.stats
        paging = {"routed_steps": st.routed_steps, "page_outs": st.page_outs, "page_ins": st.page_ins,
                  "pages_by_shard": eng.pages_by_shard()}
    per_sweep = -(-touched // _AGG_BLOCK_ROWS)
    check(blocks == per_sweep, f"26(d): the sweep ran {blocks} blocks for {touched} touched groups, not {per_sweep}")
    check(k4_first == blocks and k1_first == blocks + 3, f"26(d): {k4_first} K4 and {k1_first} K1 launches a sweep")
    eager = rag_eager(dev, lambda d: mp.RetrievalMAP(device=d), (preds, target, gids.astype(np.int64)))
    out["paged"] = {"rows": n, "touched_groups": touched, "resident_a_shard": RAG_PAGED_RESIDENT, "blocks": blocks,
                    "k4_per_sweep": k4_first, "k1_per_sweep": k1_first, "ingest_s": ingest_s,
                    "ingest_rows_per_s": n / ingest_s, "first_sweep_ms": first_ms, "sweep_ms": sweep_ms,
                    "value": value, "paging": paging,
                    "rel_err": rel_close(value, eager, "26(d): the W = 4 paged aggregate vs the eager segment path")}
    return out


def bert_stage_params(state, stages):
    """BERT-base's 12 layers as ``stages`` stages of 12 / stages, stacked
    ``(S, ...)`` leaf by leaf: stage ``s``'s row holds its layers' weights."""
    per = BERT_BASE["layers"] // stages
    names = sorted({k.split(".", 3)[3] for k in state if k.startswith("encoder.layer.")})
    return {f"l{j}": {name: torch.stack([state[f"encoder.layer.{s * per + j}.{name}"] for s in range(stages)])
                      for name in names} for j in range(per)}


def bert_layer(p, x, bias):
    """One BERT layer as ``BertBase.forward`` computes it, from its weights."""
    F = torch.nn.functional
    n, length, h = x.shape
    heads, eps = BERT_BASE["heads"], BERT_BASE["eps"]
    q, k, v = (F.linear(x, p[f"attention.self.{m}.weight"], p[f"attention.self.{m}.bias"])
               .view(n, length, heads, -1).transpose(1, 2) for m in ("query", "key", "value"))
    probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]) + bias, dim=-1)
    ctx = (probs @ v).transpose(1, 2).reshape(n, length, -1)
    x = F.layer_norm(F.linear(ctx, p["attention.output.dense.weight"], p["attention.output.dense.bias"]) + x, (h,),
                     p["attention.output.LayerNorm.weight"], p["attention.output.LayerNorm.bias"], eps)
    inter = F.gelu(F.linear(x, p["intermediate.dense.weight"], p["intermediate.dense.bias"]))
    return F.layer_norm(F.linear(inter, p["output.dense.weight"], p["output.dense.bias"]) + x, (h,),
                        p["output.LayerNorm.weight"], p["output.LayerNorm.bias"], eps)


def bert_stage(p, x):
    """One pipeline stage: the mask rides the activation's last channel (a
    stage sees only its microbatch), the stage's layers run on the rest."""
    mask, h = x[..., -1], x[..., :-1]
    bias = (1.0 - mask[:, None, None, :]) * torch.finfo(h.dtype).min
    for j in range(len(p)):
        h = bert_layer(p[f"l{j}"], h, bias)
    return torch.cat([h, mask[..., None]], dim=-1)


def bert_embed(encoder):
    """``embed_fn``: BERT-base's embeddings and their LayerNorm, the mask as
    one more channel."""
    e = encoder.embeddings

    def embed(ids, mask):
        length = ids.shape[1]
        x = e["word_embeddings"](ids.long()) + e["position_embeddings"].weight[:length] \
            + e["token_type_embeddings"].weight[0]
        return torch.cat([e["LayerNorm"](x), mask[..., None].to(x.dtype)], dim=-1)

    return embed


def mesh_models(dev, mesh, embedded, text):
    """26(e): the model meshes at W = 4. FID at 299 x 299 over phase 23's
    2 048 images a side through ``FID(mesh=...)`` (the batch layout) and
    through the model host's hybrid stem-tensor layout (FID and KID sharing
    one model); KID and IS at their defaults with ``mesh=``; each value
    against phase 23's world-1 one within :data:`MESH_EMB_TOL`, and one
    batch's features against the world-1 extractor within
    :data:`EMB_FEATURE_TOL`. BERTScore with ``mesh=`` on phase 21's 2 000
    pairs at bert-base width, its means against phase 21's within
    :data:`MESH_BERT_TOL` and the first 64 pairs against a world-1 run
    pair for pair. ``encoder_host(stage_fn=...)`` with bert-base's 12 layers
    as 4 stages of 3 and the embeddings in ``embed_fn``: its hidden states
    against the world-1 encoder's within :data:`MESH_PIPE_TOL`. Images/s and
    pairs/s a layout, gathers and hand-offs a forward, peak memory a device."""
    import metrics_tpu_torch as mp
    from metrics_tpu_torch.engine.model_host import ModelHostConfig, encoder_host, reset_host_registry
    from metrics_tpu_torch.functional import bert_score
    from metrics_tpu_torch.functional.text import bert as fbert
    from metrics_tpu_torch.models.inception import STEM_LAYERS, InceptionFeatureExtractor
    from metrics_tpu_torch.parallel.collectives import collective_counts, reset_collective_counts

    devices = list(dict.fromkeys(mesh.device_list()))
    for d in devices:
        torch.cuda.reset_peak_memory_stats(d)
    params = emb_weights()
    world1 = embedded["inception"]["values"]
    sides = [(True, 0, EMB_IMAGES), (False, 0, EMB_IMAGES)]
    out = {"images_per_side": EMB_IMAGES}
    errs = {}
    # the batch layout
    fid = mp.FID(feature=2048, params=params, mesh=mesh, device=dev)
    out["fid_batch"] = timed_updates(dev, fid, sides)
    value, out["fid_batch"]["compute"] = timed_compute(dev, fid)
    errs["fid_batch"] = rel_err(value, world1["fid"])
    imgs = emb_images(dev, 0, EMB_BATCH, fake=False)
    direct = InceptionFeatureExtractor("2048", params=params, device=dev)(imgs)
    reset_collective_counts()
    sharded = fid.inception(imgs)  # the batch layout runs uncaptured: its gathers counted
    out["fid_batch"]["collectives_per_forward"] = collective_counts()
    errs["features_batch"] = max_abs_err(sharded, direct) / float(direct.abs().max())
    kid = mp.KID(feature=2048, params=params, seed=SEED + 25, mesh=mesh, device=dev, **EMB_KID)
    out["kid"] = timed_updates(dev, kid, sides)
    kv, out["kid"]["compute"] = timed_compute(dev, kid)
    errs["kid_mean"] = rel_err(kv[0], world1["kid"][0])
    is_list = mp.IS(params=params, splits=EMB_IS_SPLITS, seed=SEED + 26, mesh=mesh, device=dev)
    out["is"] = timed_updates(dev, is_list, [(None, 0, EMB_IMAGES)])
    iv, out["is"]["compute"] = timed_compute(dev, is_list)
    errs["is_mean"] = rel_err(iv[0], world1["is"][0])
    fid = kid = is_list = None
    # the model host's hybrid stem-tensor layout
    reset_host_registry()
    try:
        cfg = ModelHostConfig(mesh=mesh)
        hfid = mp.FID(feature=2048, params=params, model_host=cfg, device=dev)
        hkid = mp.KID(feature=2048, params=params, subsets=10, subset_size=100, model_host=cfg, device=dev)
        host = hfid.model_host
        tel = host.telemetry()
        check(host is hkid.model_host and host.counters()["shared_by"] == 2, "26(e): FID and KID do not share a host")
        check(tel["sharding"] == "mesh" and tel["allowed_collectives"] == ["all_gather"], f"26(e): host {tel}")
        hosted = host.infer(imgs[:32])
        reset_collective_counts()  # one forward called directly, outside the bucket's entry: its gathers counted
        with torch.no_grad():
            host._fwd(host.params, imgs[:32])
        out["host_collectives_per_forward"] = collective_counts()
        errs["features_host"] = max_abs_err(hosted, direct[:32]) / float(direct[:32].abs().max())
        out["fid_host"] = timed_updates(dev, hfid, sides)
        hv, out["fid_host"]["compute"] = timed_compute(dev, hfid)
        errs["fid_host"] = rel_err(hv, world1["fid"])
        if mesh.transport == "nccl":
            out["host_images_per_s_captured_eager"] = captured_against_eager(host, (imgs,))
        out["host_counters"] = host.counters()
        out["host_captures"] = host.aot.misses
        out["host_shard_graphs"] = host.shard_graphs.aot.stats()
        check(host.aot.misses <= len(host.config.buckets), f"26(e): the host captured {host.aot.misses} programs")
        # across cards every bucket's forward is its pieces' graphs: five stem layers and the trunk a shard
        pieces = (len(STEM_LAYERS) + 1) * MESH_WORLD * host.aot.misses if mesh.transport == "nccl" else 0
        check(host.shard_graphs.aot.misses == pieces,
              f"26(e): the host captured {host.shard_graphs.aot.misses} shard graphs, not {pieces}")
    finally:
        reset_host_registry()
    hfid = hkid = None
    for k in ("fid_batch", "kid_mean", "is_mean", "fid_host"):
        check(errs[k] <= MESH_EMB_TOL, f"26(e): {k} at W = 4 vs world 1: {errs[k]}")
    for k in ("features_batch", "features_host"):
        check(errs[k] <= EMB_FEATURE_TOL, f"26(e): {k} at W = 4 vs world 1: {errs[k]}")
    out["rel_err_vs_world_1"] = errs
    # BERTScore, batch-sharded
    hyps, refs = text_corpus()
    state = fbert.bert_state_dict_from_flax(bert_flax_params(BERT_BASE))
    encoder = BertBase(BERT_BASE).eval().to(dev)
    encoder.load_state_dict(state, strict=True)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    got = bert_score(hyps, refs, model=encoder, max_length=BERT_MAX_LENGTH, batch_size=BERT_BATCH, device=dev,
                     mesh=mesh)
    torch.cuda.synchronize(dev)
    bert_s = time.perf_counter() - t0
    want = text["bert"]["runs"]["plain"]
    bert_err = max(abs(float(np.mean(got[k])) - want[f"mean_{k}"]) for k in ("precision", "recall", "f1"))
    check(bert_err <= MESH_BERT_TOL, f"26(e): BERTScore means at W = 4 vs phase 21's: {bert_err}")
    first = bert_score(hyps[:64], refs[:64], model=encoder, max_length=BERT_MAX_LENGTH, batch_size=BERT_BATCH,
                       device=dev)
    pair_err = max(abs(a - b) for k in ("precision", "recall", "f1") for a, b in zip(got[k][:64], first[k]))
    check(pair_err <= MESH_BERT_TOL, f"26(e): BERTScore's first 64 pairs at W = 4 vs world 1: {pair_err}")
    out["bert"] = {"pairs": len(hyps), "seconds": bert_s, "pairs_per_s": len(hyps) / bert_s,
                   "mean_abs_err_vs_phase_21": bert_err, "first_pairs_max_abs_err": pair_err}
    # the pipeline host: 4 stages of 3 layers, stage s on shard s
    tok = fbert._simple_whitespace_tokenizer(list(hyps[:MESH_PIPE_PAIRS]) + list(refs[:MESH_PIPE_PAIRS]),
                                             BERT_MAX_LENGTH)
    ids = torch.from_numpy(tok["input_ids"]).to(dev)
    mask = torch.from_numpy(tok["attention_mask"]).to(dev)
    stages = bert_stage_params({k: v.to(dev) for k, v in encoder.state_dict().items()}, MESH_WORLD)
    reset_host_registry()
    try:
        host = encoder_host(stage_fn=bert_stage, stage_params=stages, embed_fn=bert_embed(encoder),
                            config=ModelHostConfig(buckets=(MESH_PIPE_BUCKET,), coalesce_window_ms=0.0, mesh=mesh))
        tel = host.telemetry()
        check(tel["allowed_collectives"] == ["ppermute"] and tel["sharding"] == "mesh", f"26(e): pipeline host {tel}")
        with torch.no_grad():
            host.infer(ids[:MESH_PIPE_BUCKET], mask[:MESH_PIPE_BUCKET])
            reset_collective_counts()  # one forward called directly, outside the bucket's entry: its hand-offs counted
            host._fwd(host.params, ids[:MESH_PIPE_BUCKET], mask[:MESH_PIPE_BUCKET])
            hand_offs = collective_counts()
            check(hand_offs["ppermute"] == (MESH_WORLD + MESH_WORLD - 1) + (MESH_WORLD - 1)
                  and hand_offs["all_gather"] == hand_offs["all_reduce"] == 0, f"26(e): hand-offs {hand_offs}")
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            piped = host.infer(ids, mask)
            torch.cuda.synchronize(dev)
            pipe_s = time.perf_counter() - t0
            plain = torch.cat([encoder(ids[i:i + BERT_BATCH], mask[i:i + BERT_BATCH])
                               for i in range(0, ids.shape[0], BERT_BATCH)])
        pipe_err = max_abs_err(piped[..., :-1], plain)
        check(pipe_err <= MESH_PIPE_TOL, f"26(e): the pipeline host's hidden states vs world 1: {pipe_err}")
        # across cards a bucket's forward is the embeddings' graph and one stage graph a shard
        pieces = (1 + MESH_WORLD) * host.aot.misses if mesh.transport == "nccl" else 0
        check(host.shard_graphs.aot.misses == pieces,
              f"26(e): the pipeline host captured {host.shard_graphs.aot.misses} shard graphs, not {pieces}")
        out["pipeline"] = {"rows": int(ids.shape[0]), "seconds": pipe_s, "rows_per_s": int(ids.shape[0]) / pipe_s,
                           "hand_offs_per_forward": hand_offs["ppermute"], "max_abs_err": pipe_err,
                           "host_captures": host.aot.misses, "shard_graphs": host.shard_graphs.aot.stats()}
        if mesh.transport == "nccl":
            out["pipeline"]["rows_per_s_captured_eager"] = captured_against_eager(host, (ids, mask))
    finally:
        reset_host_registry()
    out["peak_memory_gb"] = {str(d): torch.cuda.max_memory_allocated(d) / 1e9 for d in devices}
    return out


def captured_against_eager(host, args, reps=MESH_HOST_REPS):
    """Rows/s of ``host.infer(*args)`` across cards with its shards' pieces
    replayed as graphs and run eagerly (the host before they were captured),
    in turns: captured, eager, eager, captured; ``reps`` requests a turn."""
    rows = int(args[0].shape[0])
    out = []
    for enabled in (True, False, False, True):
        host.shard_graphs.enabled = enabled
        host.infer(*args)  # the turn's warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            host.infer(*args)
        out.append(reps * rows / (time.perf_counter() - t0))
    host.shard_graphs.enabled = True
    return {"captured": [out[0], out[3]], "eager": [out[1], out[2]]}


def mesh_forms_phase(dev, preds, target, embedded, text):
    """Phase 26: the mesh forms that remain at W = 4, (a)-(e); the line
    names the layout and the transport."""
    mesh = mesh_layout(dev)
    out = {"world": MESH_WORLD, "layout": [str(d) for d in mesh.device_list()], "transport": mesh.transport}
    for name, fn in (("windows", lambda: mesh_windows(dev, preds, target, mesh)),
                     ("window_paged", lambda: mesh_window_paged(dev, preds, target, mesh)),
                     ("window_reshard", lambda: mesh_window_reshard(dev, preds, target, mesh)),
                     ("ragged", lambda: mesh_ragged(dev, mesh)),
                     ("models", lambda: mesh_models(dev, mesh, embedded, text))):
        t0 = time.perf_counter()
        out[name] = fn()
        out[name]["phase_s"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------- phase 27: the fleet

FLEET_HOSTS = 2
FLEET_CUT_A = 16  # 27(a): plan batches a cut
FLEET_STEADY_A = (33, 46)  # 27(a): plan batches between two cuts whose steps the collective count reads
FLEET_KILL_A = 72  # 27(a): host 1 dies after this plan batch, past cut 3 (at 64)
FLEET_PLAN_B = 800  # 27(b): the prefix of phase 9's traffic
FLEET_CUT_B = 100
FLEET_PANE_B = 200  # 27(b): a tumbling pane of two cuts ...
FLEET_PANES_B = 3  # ... three live: a host's live (stream, pane) rows outgrow its 128 slots from batch 417 (366)
FLEET_STEADY_B = (110, 190)
FLEET_AT_B = 440  # 27(b): the hosts' results against the single-process engine, mid-pane, both hosts spilled
FLEET_KILL_B = 450  # 27(b): host 1 dies after this plan batch, past cut 3 (at 400, a rotation too)
FLEET_FOLDS = (5, 2)  # timed folds and barriers a host: (a), (b)
FLEET_EXIT = 17  # the killed host's exit code
FLEET_TIMEOUT_S = 420
FLEET_DIR = Path(__file__).resolve().parent / "build" / "phase27"  # gitignored; removed after the phase


def fleet_layout():
    """Phase 27's representative devices: ``cuda:0`` and ``cuda:1`` when the
    machine has two cards (NCCL), else both hosts on ``cuda:0`` (gloo, which
    the runtime picks when hosts share a card)."""
    if torch.cuda.device_count() >= FLEET_HOSTS:
        return ["cuda:0", "cuda:1"], "two hosts, a card each", "nccl"
    return ["cuda:0", "cuda:0"], "two hosts on one card", "gloo"


def state_digest(tree):
    """sha256 of every leaf of a state tree (dtype, shape and bytes, in
    flatten order): bit-equality across processes without moving the state."""
    import hashlib

    from metrics_tpu_torch.utils.tree import tree_flatten

    h = hashlib.sha256()
    for leaf in tree_flatten(tree)[0]:
        x = leaf.detach().contiguous().cpu()
        h.update(f"{x.dtype}{tuple(x.shape)}".encode())
        h.update(x.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def stacked_values(results):
    """Every stream's values as one ``(S, ...)`` float64 tensor a key."""
    keys = results[0].keys()
    return {k: torch.stack([flat_values({k: results[s][k]})[k] for s in sorted(results)]) for k in keys}


def values_close(got, want, what, tol=1e-6):
    """Each value within ``tol`` of ``want``'s, NaN where it is NaN (a stream
    no batch touched)."""
    for k in want:
        g, w = got[k].double(), want[k].double()
        nan = torch.isnan(w)
        check(g.shape == w.shape and torch.equal(torch.isnan(g), nan), f"{what}: {k} shape or NaN pattern")
        diff = (g - w).abs()[~nan]
        err = float(diff.max()) if diff.numel() else 0.0
        check(err <= tol, f"{what}: {k} err {err}")


def fleet_plans(dev):
    """27's shared plans: (a) phase 7's ragged batches over the main rows, (b)
    phase 9's first ``FLEET_PLAN_B`` (stream, batch) pairs."""
    preds, target, _, _ = main_rows(dev)
    batches = ragged_batches(SEED + 4, 8, 64)
    sids = zipf_stream_ids(PAGED_STREAMS, len(batches), ALPHA, SEED + 4)
    return preds, target, ragged_batches(SEED + 2, 16, BUCKET), list(zip(sids, batches))[:FLEET_PLAN_B]


def fleet_window():
    from metrics_tpu_torch.engine import WindowPolicy

    return WindowPolicy.tumbling(pane_batches=FLEET_PANE_B, n_panes=FLEET_PANES_B)


def fleet_engine_b_config(**kw):
    """27(b)'s engine: phase 9's paged tenancy under the tumbling window."""
    from metrics_tpu_torch.engine import EngineConfig

    return EngineConfig(buckets=PAGED_BUCKETS, kernel_backend="megastep", coalesce=8, window=fleet_window(), **kw)


def fleet_of(dev, pid, spec, form):
    from metrics_tpu_torch.engine import EngineConfig
    from metrics_tpu_torch.engine.fleet import FleetConfig, FleetEngine

    base = dict(num_processes=FLEET_HOSTS, process_id=pid, coordinator_address=spec["coord"],
                snapshot_dir=os.path.join(spec["dir"], form))
    if form == "a":
        cfg = FleetConfig(engine=EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep"),
                          snapshot_every=FLEET_CUT_A, **base)
    else:
        cfg = FleetConfig(engine=fleet_engine_b_config(), num_streams=PAGED_STREAMS, stream_shard=True,
                          resident_streams=RESIDENT, snapshot_every=FLEET_CUT_B, **base)
    return FleetEngine(make_collection(dev), cfg)


def timed_cuts(fleet):
    """Wrap ``fleet.fleet_snapshot`` (which ``ingest`` calls at each cut) to
    record each cut's host ms: the barrier, the piece and the marker."""
    times, write = [], fleet.fleet_snapshot

    def timed(*a, **kw):
        t0 = time.perf_counter()
        path = write(*a, **kw)
        times.append((time.perf_counter() - t0) * 1e3)
        return path

    fleet.fleet_snapshot = timed
    return times


def fleet_numbers(fleet, read, folds):
    """A host's fold ms (the fleet's own fold timer, ``folds`` reads), barrier
    ms (``folds`` bare cut barriers) and per-fold bytes by leg."""
    st = fleet.engine.stats
    fold_ms = []
    for _ in range(folds):
        before = st.fleet_merge_us_total
        read()
        fold_ms.append((st.fleet_merge_us_total - before) / 1e3)
    barrier_ms = []
    for _ in range(folds):
        t0 = time.perf_counter()
        fleet._barrier(fleet._next_cut)
        barrier_ms.append((time.perf_counter() - t0) * 1e3)
    exact, quant = fleet._fleet_payload_split()
    return {"fold_ms": fold_ms, "fold_ms_p50": float(np.median(fold_ms)), "barrier_ms": barrier_ms,
            "barrier_ms_p50": float(np.median(barrier_ms)),
            "fold_bytes": {"intra": fleet._fleet_intra_bytes(), "cross_exact": exact, "cross_q8": quant}}


def steady_window(eng, bounds, since=None):
    """The steady window over plan batches ``bounds`` (inclusive), read the
    same way on a host and on the single-process engine: ``steady_window(eng,
    bounds)`` opens it, ``steady_window(eng, bounds, opened)`` closes it
    with host ms a plan batch, the engine steps and the captures made in it."""
    now = (time.perf_counter(), eng.steps, eng.aot_cache.misses)
    if since is None:
        return now
    return {"host_ms_per_plan_batch": (now[0] - since[0]) * 1e3 / (bounds[1] - bounds[0] + 1),
            "steps": now[1] - since[1], "captures": now[2] - since[2]}


def fleet_serve(dev, pid, spec, out):
    """Round 1 of a host: (a) to ``FLEET_KILL_A`` and (b) to ``FLEET_KILL_B``,
    cuts riding the plan; the steady steps' collectives, a fold's, the
    timings; (b)'s state digest and values at ``FLEET_AT_B``."""
    from metrics_tpu_torch.parallel.collectives import collective_counts, reset_collective_counts

    preds, target, plan_a, plan_b = fleet_plans(dev)
    fa = fleet_of(dev, pid, spec, "a")
    cuts = timed_cuts(fa)
    with fa:
        for i, (lo, hi) in enumerate(plan_a[:FLEET_KILL_A]):
            if i == FLEET_STEADY_A[0]:
                fa.flush()
                reset_collective_counts()
                opened = steady_window(fa.engine, FLEET_STEADY_A)
            fa.ingest(preds[lo:hi], target[lo:hi])
            if i == FLEET_STEADY_A[1]:
                fa.flush()
                steady, window = collective_counts(), steady_window(fa.engine, FLEET_STEADY_A, opened)
        fa.flush()
        reset_collective_counts()
        fa.result()
        fold = collective_counts()
        out["a"] = dict(fleet_numbers(fa, fa.result, FLEET_FOLDS[0]), cut_ms=cuts, steady_collectives=steady,
                        fold_collectives=fold, steps=fa.engine.steps, cursor=fa.global_cursor,
                        cuts=fa.engine.stats.fleet_cuts, steady=window,
                        fleet_block=fa.telemetry()["fleet"])
    fb = fleet_of(dev, pid, spec, "b")
    cuts = timed_cuts(fb)
    with fb:
        for i, (sid, (lo, hi)) in enumerate(plan_b[:FLEET_KILL_B]):
            if i == FLEET_STEADY_B[0]:
                fb.flush()
                reset_collective_counts()
                opened = steady_window(fb.engine, FLEET_STEADY_B)
            fb.ingest(int(sid), preds[lo:hi], target[lo:hi])
            if i == FLEET_STEADY_B[1]:
                fb.flush()
                steady, window = collective_counts(), steady_window(fb.engine, FLEET_STEADY_B, opened)
            if i + 1 == FLEET_AT_B:
                reset_collective_counts()
                values = stacked_values(fb.results())
                fold = collective_counts()
                out["b_at"] = {"digest": state_digest(fb.fleet_state()), "cursor": fb.global_cursor}
                torch.save(values, os.path.join(spec["dir"], f"b_at_host{pid}.pt"))
                numbers = fleet_numbers(fb, fb.results, FLEET_FOLDS[1])
        fb.flush()
        tenancy = fb.engine.pager.tenancy_stats()
        out["b"] = dict(numbers, cut_ms=cuts, steady_collectives=steady, fold_collectives=fold,
                        steps=fb.engine.steps, cursor=fb.global_cursor, cuts=fb.engine.stats.fleet_cuts,
                        page_outs=fb.engine.stats.page_outs,
                        rotations=fb.engine.stats.pane_rotations, tenancy=tenancy, steady=window,
                        fleet_block=fb.telemetry()["fleet"])


def fleet_restore(dev, pid, spec, out):
    """Round 2 of a host: both forms restore from the last consistent cut
    (digest of (b)'s folded state there), replay the rest of the plan, and
    report the final digests and values."""
    preds, target, plan_a, plan_b = fleet_plans(dev)
    fa = fleet_of(dev, pid, spec, "a")
    meta = fa.restore()
    with fa:
        for lo, hi in plan_a[fa.global_cursor:]:
            fa.ingest(preds[lo:hi], target[lo:hi])
        out["a"] = {"cut": int(meta["fleet_cut"]), "cursor": int(meta["fleet_plan_cursor"]),
                    "digest": state_digest(fa.fleet_state()),
                    "values": {k: v.tolist() for k, v in flat_values(fa.result()).items()}}
    fb = fleet_of(dev, pid, spec, "b")
    meta = fb.restore()
    with fb:
        at_cut = state_digest(fb.fleet_state())
        for sid, (lo, hi) in plan_b[fb.global_cursor:]:
            fb.ingest(int(sid), preds[lo:hi], target[lo:hi])
        values = stacked_values(fb.results())
        torch.save(values, os.path.join(spec["dir"], f"b_final_host{pid}.pt"))
        out["b"] = {"cut": int(meta["fleet_cut"]), "cursor": int(meta["fleet_plan_cursor"]), "at_cut_digest": at_cut,
                    "digest": state_digest(fb.fleet_state()),
                    "spilled_rows": int(fb.engine.pager.tenancy_stats()["spilled_rows"]),
                    "page_outs": fb.engine.stats.page_outs}


def fleet_host(pid, spec_path):
    """One host of phase 27, a spawned process: its round, its kernel counts,
    the artifact written, then ``os._exit`` (the killed host's code after
    round 1)."""
    with open(spec_path) as f:
        spec = json.load(f)
    out, rc = {"pid": pid}, 0
    try:
        dev = torch.device(spec["devices"][pid])
        torch.cuda.set_device(dev)
        from metrics_tpu_torch.ops.kernels import build

        for name in build.SOURCES:
            build.library(name)
        for fn in kernel_wrappers().values():
            fn.launches = 0
        (fleet_serve if spec["round"] == "serve" else fleet_restore)(dev, pid, spec, out)
        torch.cuda.synchronize(dev)
        out["launches"] = counts()
        out["backend"] = __import__("torch.distributed", fromlist=["_"]).get_backend()
    except BaseException:  # noqa: BLE001 - the parent reports it and fails
        import traceback

        out["error"] = traceback.format_exc()
        rc = 1
    with open(spec["out"][pid], "w") as f:
        json.dump(out, f)
    os._exit(FLEET_EXIT if rc == 0 and spec["round"] == "serve" and pid == 1 else rc)


def fleet_round(name, devices):
    """Spawn the two hosts of one round and wait for both, bounded; kill any
    still alive at the deadline. Returns their exit codes and artifacts."""
    import socket

    import torch.multiprocessing as tmp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    spec = {"round": name, "devices": devices, "coord": f"tcp://127.0.0.1:{port}", "dir": str(FLEET_DIR),
            "out": [str(FLEET_DIR / f"{name}_host{p}.json") for p in range(FLEET_HOSTS)]}
    spec_path = FLEET_DIR / f"{name}_spec.json"
    spec_path.write_text(json.dumps(spec))
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=fleet_host, args=(p, str(spec_path))) for p in range(FLEET_HOSTS)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + FLEET_TIMEOUT_S
    try:
        for proc in procs:
            proc.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    outs = []
    for path in spec["out"]:
        try:
            outs.append(json.loads(Path(path).read_text()))
        except (OSError, ValueError):
            outs.append({"error": f"artifact missing: {path}"})
    return [proc.exitcode for proc in procs], outs


def fleet_references(dev, preds, target):
    """The single-process engines on the card serving 27's plans: (a) phase
    7's megastep engine, (b) the paged tenancy under the window, read at
    the last consistent cut (400), at ``FLEET_AT_B`` and at the end; each
    with the steady window the hosts read (``steady_window``)."""
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine, StreamingEngine

    _, _, plan_a, plan_b = fleet_plans(dev)
    eng = StreamingEngine(make_collection(dev), EngineConfig(buckets=(256, BUCKET), kernel_backend="megastep"))
    ref = {"a": {}}
    with eng:
        for lo, hi, tag in ((0, FLEET_STEADY_A[0], None), (FLEET_STEADY_A[0], FLEET_STEADY_A[1] + 1, "steady"),
                            (FLEET_STEADY_A[1] + 1, len(plan_a), None)):
            opened = steady_window(eng, FLEET_STEADY_A)
            for r0, r1 in plan_a[lo:hi]:
                eng.submit(preds[r0:r1], target[r0:r1])
            eng.flush()
            if tag:
                ref["a"]["steady"] = steady_window(eng, FLEET_STEADY_A, opened)
        ref["a"].update(digest=state_digest(eng.state()), values=flat_values(eng.result()))
    eng = MultiStreamEngine(make_collection(dev), PAGED_STREAMS, fleet_engine_b_config(), stream_shard=True,
                            resident_streams=RESIDENT)
    b = {}
    with eng:
        cut = (FLEET_KILL_B // FLEET_CUT_B) * FLEET_CUT_B  # the last consistent cut's plan position
        marks = sorted([(FLEET_STEADY_B[0], None), (FLEET_STEADY_B[1] + 1, "steady"), (cut, "cut"),
                        (FLEET_AT_B, "at"), (FLEET_PLAN_B, "final")], key=lambda m: m[0])
        for (lo, _), (hi, tag) in zip([(0, None)] + marks[:-1], marks):
            opened = steady_window(eng, FLEET_STEADY_B)
            for sid, (r0, r1) in plan_b[lo:hi]:
                eng.submit(int(sid), preds[r0:r1], target[r0:r1])
            eng.flush()
            if tag == "steady":
                b["steady"] = steady_window(eng, FLEET_STEADY_B, opened)
            elif tag:
                b[f"{tag}_digest"] = state_digest(eng.state())
                if tag != "cut":
                    b[f"{tag}_values"] = stacked_values(eng.results())
    b["page_outs"] = eng.stats.page_outs
    ref["b"] = b
    return ref


def fleet_phase(dev, preds, target):
    """Phase 27: the fleet (module docstring). Returns the phase's line."""
    from metrics_tpu_torch.engine import EngineConfig, MultiStreamEngine
    from metrics_tpu_torch.engine.fleet import last_consistent_cut, restore_fleet_into

    devices, layout, transport = fleet_layout()
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    FLEET_DIR.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        ref = fleet_references(dev, preds, target)
        ref_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rcs, serve = fleet_round("serve", devices)
        serve_s = time.perf_counter() - t0
        for p, o in enumerate(serve):
            check("error" not in o, f"27 round 1 host {p} failed:\n{o.get('error')}")
        check(rcs == [0, FLEET_EXIT], f"27 round 1 exit codes {rcs}, wanted [0, {FLEET_EXIT}]")
        for p, o in enumerate(serve):
            check(o["backend"] == transport, f"27 host {p} took {o['backend']}, the layout names {transport}")
            for k in ("histogram", "megastep_fold", "megastep_segment"):
                check(o["launches"][k] > 0, f"27 host {p}: kernel {k} was not launched")
            for form in ("a", "b"):
                n = o[form]
                check(not any(n["steady_collectives"].values()), f"27({form}) host {p}: collectives in steady steps "
                      f"{n['steady_collectives']}")
                check(sum(n["fold_collectives"].values()) >= 1, f"27({form}) host {p}: a fold issued no collective")
            check(o["a"]["cuts"] == FLEET_KILL_A // FLEET_CUT_A and o["b"]["cuts"] == FLEET_KILL_B // FLEET_CUT_B,
                  f"27 host {p} cuts {o['a']['cuts']}, {o['b']['cuts']}")
            check(o["b"]["page_outs"] > 0 and o["b"]["tenancy"]["spilled_rows"] > 0, f"27(b) host {p} never spilled")
            check(o["b_at"]["digest"] == ref["b"]["at_digest"], f"27(b) host {p}: state at {FLEET_AT_B} differs "
                  "from the single-process paged engine's")
            values_close(torch.load(FLEET_DIR / f"b_at_host{p}.pt"), ref["b"]["at_values"],
                         f"27(b) host {p} results at {FLEET_AT_B}")
        cut_a = last_consistent_cut(str(FLEET_DIR / "a"), FLEET_HOSTS)
        cut_b = last_consistent_cut(str(FLEET_DIR / "b"), FLEET_HOSTS)
        check(cut_a == FLEET_KILL_A // FLEET_CUT_A - 1 and cut_b == FLEET_KILL_B // FLEET_CUT_B - 1,
              f"27: last consistent cuts {cut_a}, {cut_b}")
        # 27(b)'s pieces merged into one unsharded engine on the card: the fleet's state at the cut
        t0 = time.perf_counter()
        merged = MultiStreamEngine(make_collection(dev), PAGED_STREAMS,
                                   EngineConfig(buckets=PAGED_BUCKETS, window=fleet_window()))
        meta = restore_fleet_into(merged, str(FLEET_DIR / "b"))
        merged_digest = state_digest(merged.state())
        merge_s = time.perf_counter() - t0
        check(int(meta["merged_from_hosts"]) == FLEET_HOSTS and merged_digest == ref["b"]["cut_digest"],
              "27(b): restore_fleet_into's state differs from the single-process engine's at the cut")
        del merged
        t0 = time.perf_counter()
        rcs, restore = fleet_round("restore", devices)
        restore_s = time.perf_counter() - t0
        for p, o in enumerate(restore):
            check("error" not in o, f"27 round 2 host {p} failed:\n{o.get('error')}")
        check(rcs == [0, 0], f"27 round 2 exit codes {rcs}")
        for p, o in enumerate(restore):
            check(o["a"]["cut"] == cut_a and o["b"]["cut"] == cut_b, f"27 host {p} restored cuts {o['a']['cut']}, "
                  f"{o['b']['cut']}")
            check(o["a"]["digest"] == ref["a"]["digest"], f"27(a) host {p}: replayed state differs from the "
                  "single-process engine's")
            values_close({k: torch.tensor(v) for k, v in o["a"]["values"].items()}, ref["a"]["values"],
                         f"27(a) host {p} values")
            check(o["b"]["at_cut_digest"] == ref["b"]["cut_digest"] == merged_digest,
                  f"27(b) host {p}: the restored state differs from the engine's at the cut")
            check(o["b"]["digest"] == ref["b"]["final_digest"], f"27(b) host {p}: replayed state differs")
            # page-outs, not the rows spilled at the end: the rotation at 800 drops the expired pane's rows
            check(o["b"]["page_outs"] > 0, f"27(b) host {p}: the replay never spilled")
            values_close(torch.load(FLEET_DIR / f"b_final_host{p}.pt"), ref["b"]["final_values"],
                         f"27(b) host {p} replayed results")
        hosts = []
        for p, o in enumerate(serve):
            hosts.append({"host": p, "device": devices[p], "launches": o["launches"],
                          **{form: {k: o[form][k] for k in ("fold_ms_p50", "fold_ms", "barrier_ms_p50", "cut_ms",
                                                            "fold_bytes", "steady_collectives", "fold_collectives",
                                                            "steps", "steady")}
                             for form in ("a", "b")},
                          "b_tenancy": o["b"]["tenancy"], "b_page_outs": o["b"]["page_outs"],
                          "b_rotations": o["b"]["rotations"], "b_replay_page_outs": restore[p]["b"]["page_outs"]})
        return {"layout": layout, "transport": transport, "devices": devices,
                "plans": {"a": {"batches": FLEET_KILL_A, "cut_every": FLEET_CUT_A, "killed_after": FLEET_KILL_A},
                          "b": {"batches": FLEET_PLAN_B, "streams": PAGED_STREAMS, "resident_a_host": RESIDENT,
                                "cut_every": FLEET_CUT_B, "pane": FLEET_PANE_B, "panes": FLEET_PANES_B,
                                "killed_after": FLEET_KILL_B}},
                "restored_cuts": {"a": cut_a, "b": cut_b}, "hosts": hosts,
                "single_process_steady": {"a": ref["a"]["steady"], "b": ref["b"]["steady"]},
                "seconds": {"references": ref_s, "round_1": serve_s, "merge_into_one": merge_s,
                            "round_2": restore_s}}
    finally:
        shutil.rmtree(FLEET_DIR, ignore_errors=True)


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1
    from metrics_tpu_torch.ops.kernels import build
    from metrics_tpu_torch.ops.kernels.match_cuda import greedy_match_cuda
    from metrics_tpu_torch.ops.kernels.toeplitz_cuda import toeplitz_solve_cuda

    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.library(name)
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {build.last_build_seconds:.2f} s) on {card}")

    rng = np.random.RandomState(SEED)
    t0 = time.perf_counter()
    fold_entries = fold_phase(dev, rng)
    hist_entries = hist_phase(dev, rng)
    binned_entries = binned_phase(dev, rng)
    print(f"kernel phases K1-K3: pass ({time.perf_counter() - t0:.2f} s on {card})")
    t0 = time.perf_counter()
    segment_entries = segment_phase(dev, rng)
    mega_fold_entries = megastep_fold_phase(dev, rng)
    mega_seg_entries, mega_q8_entries = megastep_segment_phase(dev, rng)
    print(f"kernel phases K4-K7: pass ({time.perf_counter() - t0:.2f} s on {card})")

    preds, target, preds_np, target_np = main_rows(dev)
    hist_cal_entry = hist_calibration_timing(dev, preds, target)
    hist_auroc_entry = hist_auroc_support_timing(dev, target)
    kernels = kernel_wrappers()
    for fn in kernels.values():
        fn.launches = 0
    greedy_match_cuda.launches = 0  # K9 runs in phase 24 alone
    gpu_state, gpu_values, one_shot_s = main_path(dev, preds, target)
    one_shot = counts()
    masked_state, masked_values, buckets, masked_s = masked_path(dev, preds_np, target_np, np.random.RandomState(SEED + 1))
    masked = delta(one_shot)
    for k in ("fold_rows", "histogram", "binned_counts"):
        check(masked[k] > 0, f"kernel {k} was not launched by the masked bucket step")
    check(one_shot["histogram"] > 0 and one_shot["binned_counts"] > 0, "one-shot update skipped a kernel")
    check(one_shot["histogram"] == N_ROWS // BATCH and masked["histogram"] == buckets,
          "K2: not one launch per batch and per masked bucket")

    phases = engine_phases(dev, preds, target, preds_np, target_np, gpu_state)
    launches = counts()
    profile = profile_bucket(dev, preds, target)
    phases_line = {"engine_phases": phases, "profile": profile, "card": card}
    print(json.dumps({"launches": {"one_shot_update": one_shot, "masked_buckets": masked}}))
    for k in kernels:
        check(launches[k] > 0, f"kernel {k} was not launched on the main path")

    # phase 10, its counts from 0: K1 (masked buckets), K2 (all three forms), K5 and K6 must launch
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    dashboard = dashboard_phase(dev, preds, target, preds_np, target_np)
    dashboard_launches = counts()
    for k in ("fold_rows", "histogram", "megastep_fold", "megastep_segment"):
        check(dashboard_launches[k] > 0, f"kernel {k} was not launched by the dashboard phase")
    launches = {k: launches[k] + dashboard_launches[k] for k in launches}
    print(json.dumps({"dashboard_phase": dashboard, "launches": dashboard_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 11, its counts from 0: K1 (the delta members, leaf by leaf), K2 and K3 must launch; no K5 (checked inside)
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    curves = curves_phase(dev, preds, target, preds_np, target_np)
    curve_launches = counts()
    for k in ("fold_rows", "histogram", "binned_counts"):
        check(curve_launches[k] > 0, f"kernel {k} was not launched by the curves phase")
    launches = {k: launches[k] + curve_launches[k] for k in launches}
    print(json.dumps({"curves_phase": curves, "launches": curve_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 12, its counts from 0: K2, K3, K5 (megastep engine) and K6 (paged engine) must launch
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    wrappers = wrapper_phase(dev, preds, target, preds_np, target_np)
    wrapper_launches = counts()
    for k in ("histogram", "binned_counts", "megastep_fold", "megastep_segment"):
        check(wrapper_launches[k] > 0, f"kernel {k} was not launched by the wrapper phase")
    launches = {k: launches[k] + wrapper_launches[k] for k in launches}
    print(json.dumps({"wrapper_phase": wrappers, "launches": wrapper_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 13, its counts from 0: K1 (masked buckets), K4 (unsharded), K5 (megastep) and K6 (paged) must launch
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    regression = regression_phase(dev)
    regression_launches = counts()
    for k in ("fold_rows", "segment_reduce", "megastep_fold", "megastep_segment"):
        check(regression_launches[k] > 0, f"kernel {k} was not launched by the regression phase")
    launches = {k: launches[k] + regression_launches[k] for k in launches}
    print(json.dumps({"regression_phase": regression, "launches": regression_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 14, its counts from 0: K2 and K3 (the flagship's rank-local update) must launch
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    sync = sync_phase(dev, gpu_state, gpu_values)
    sync_launches = counts()
    for k in ("histogram", "binned_counts"):
        check(sync_launches[k] > 0, f"kernel {k} was not launched by the sync phase")
    launches = {k: launches[k] + sync_launches[k] for k in launches}
    print(json.dumps({"sync_phase": sync, "launches": sync_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 15, its counts from 0: K2 and K3 (inside the flagship's captured forward) must launch
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    forward = forward_phase(dev, preds, target, gpu_state, gpu_values)
    forward_launches = counts()
    for k in ("histogram", "binned_counts"):
        check(forward_launches[k] > 0, f"kernel {k} was not launched by the forward phase")
    launches = {k: launches[k] + forward_launches[k] for k in launches}
    print(json.dumps({"forward_phase": forward, "launches": forward_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 16, its counts from 0: K2, K3, K5 (megastep engine), K6, K7 (paged q8) and K4 (merged) must launch
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    snapshots = snapshot_phase(dev, preds, target, gpu_state, gpu_values)
    snapshot_launches = counts()
    for k in ("histogram", "binned_counts", "segment_reduce", "megastep_fold", "megastep_segment",
              "megastep_segment_q8"):
        check(snapshot_launches[k] > 0, f"kernel {k} was not launched by the snapshot phase")
    launches = {k: launches[k] + snapshot_launches[k] for k in launches}
    print(json.dumps({"snapshot_phase": snapshots, "launches": snapshot_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 17, its counts from 0: K5 then K1 (the demoted megastep engine), K6, K7 then K4 (the
    # demoted paged engine), K2 and K3 must launch
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    chaos = chaos_phase(dev, preds, target, gpu_state)
    chaos_launches = counts()
    for k in kernels:
        check(chaos_launches[k] > 0, f"kernel {k} was not launched by the chaos phase")
    launches = {k: launches[k] + chaos_launches[k] for k in launches}
    print(json.dumps({"chaos_phase": chaos, "launches": chaos_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 18, its counts from 0: K5 then K1 (18(b)'s demoted megastep engine), K6, K7 then K4 (its demoted
    # paged engine), K2 (the steps and the recorder's folds) and K3 must launch
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    obs = obs_phase(dev, preds, target, preds_np, target_np, gpu_state)
    obs_launches = counts()
    for k in kernels:
        check(obs_launches[k] > 0, f"kernel {k} was not launched by the observability phase")
    launches = {k: launches[k] + obs_launches[k] for k in launches}
    print(json.dumps({"obs_phase": obs, "launches": obs_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))
    fold_entry = obs_fold_entry(dev, obs["traced"]["fold_indices"])

    # phase 19, its counts from 0: K5 (the windowed megastep engines), K6 and K7 (the windowed q8 tenancy), K2 and
    # K3 (the flagship's members) must launch
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    windows = window_phase(dev, preds, target, preds_np, target_np)
    window_launches = counts()
    for k in ("histogram", "binned_counts", "megastep_fold", "megastep_segment", "megastep_segment_q8"):
        check(window_launches[k] > 0, f"kernel {k} was not launched by the windows phase")
    launches = {k: launches[k] + window_launches[k] for k in launches}
    print(json.dumps({"window_phase": windows, "launches": window_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 20, its counts from 0: K1 (every device aggregate's folds) and K4 (the paged sweeps) must launch
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    ragged = ragged_phase(dev)
    ragged_launches = counts()
    for k in ("fold_rows", "segment_reduce"):
        check(ragged_launches[k] > 0, f"kernel {k} was not launched by the ragged phase")
    launches = {k: launches[k] + ragged_launches[k] for k in launches}
    print(json.dumps({"ragged_phase": ragged, "launches": ragged_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))
    ragged_entries = ragged_kernel_entries(dev, np.random.RandomState(SEED + 20))

    # phase 21, its counts from 0: the text path runs no kernel of K1-K7 (JAX's runs no Pallas kernel there)
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    text = text_phase(dev)
    text_launches = counts()
    check(not any(text_launches.values()), f"the text phase launched {text_launches}")
    print(json.dumps({"text_phase": text, "launches": text_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 22, its counts from 0: the audio and image path runs no kernel of K1-K7 (JAX's runs no Pallas kernel
    # there)
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    signal = signal_phase(dev)
    signal_launches = counts()
    check(not any(signal_launches.values()), f"the signal phase launched {signal_launches}")
    print(json.dumps({"signal_phase": signal, "launches": signal_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 23, its counts from 0: the embedded models run no kernel of K1-K7 (JAX's run no Pallas kernel there)
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    embedded = embedded_phase(dev)
    embedded_launches = counts()
    check(not any(embedded_launches.values()), f"the embedded-model phase launched {embedded_launches}")
    print(json.dumps({"embedded_phase": embedded, "launches": embedded_launches,
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 24, its counts from 0: detection runs K9 alone (JAX's matcher is a scan, no Pallas kernel), which
    # launches in no earlier phase; K1-K8 must stay 0, K9 must launch in (a) and (c) (checked inside)
    check(greedy_match_cuda.launches == 0, f"K9 launched {greedy_match_cuda.launches} times in phases 4-23")
    for fn in kernels.values():
        fn.launches = 0
    toeplitz_solve_cuda.launches = 0
    t0 = time.perf_counter()
    detection, k9_entries = detection_phase(dev)
    detection_launches = dict(counts(), toeplitz_solve=toeplitz_solve_cuda.launches)
    check(not any(detection_launches.values()), f"the detection phase launched {detection_launches}")
    k9_launches = sum(e["launches"] for e in k9_entries)
    print(json.dumps({"detection_phase": detection, "launches": dict(detection_launches, greedy_match=k9_launches),
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 25, its counts from 0: K2 and K3 (every shard's flagship step), K5 (the megastep shard steps), K1 (the
    # auto shard steps of 25(b)), K4 (the unsharded deferred streams), K6 and K7 (the stream-sharded tenancy) must
    # launch; K8 and K9 must stay 0
    for fn in kernels.values():
        fn.launches = 0
    toeplitz_solve_cuda.launches = greedy_match_cuda.launches = 0
    t0 = time.perf_counter()
    mesh = mesh_phase(dev, preds, target, preds_np, target_np, gpu_state)
    mesh_launches = counts()
    for k in kernels:
        check(mesh_launches[k] > 0, f"kernel {k} was not launched by the mesh phase")
    check(toeplitz_solve_cuda.launches == 0 and greedy_match_cuda.launches == 0, "the mesh phase launched K8 or K9")
    launches = {k: launches[k] + mesh_launches[k] for k in launches}
    print(json.dumps({"mesh_phase": mesh, "launches": dict(mesh_launches, toeplitz_solve=0, greedy_match=0),
                      "layout": mesh["layout"], "transport": mesh["transport"],
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 26, its counts from 0: K2 and K3 (every shard's flagship step), K5 (the windowed megastep shard steps),
    # K6 (the windowed stream-sharded tenancy), K1 (the ragged aggregates) and K4 (the ragged paged sweep) must
    # launch; K8 and K9 must stay 0
    for fn in kernels.values():
        fn.launches = 0
    toeplitz_solve_cuda.launches = greedy_match_cuda.launches = 0
    t0 = time.perf_counter()
    forms = mesh_forms_phase(dev, preds, target, embedded, text)
    forms_launches = counts()
    for k in ("fold_rows", "histogram", "binned_counts", "segment_reduce", "megastep_fold", "megastep_segment"):
        check(forms_launches[k] > 0, f"kernel {k} was not launched by the mesh-forms phase")
    check(toeplitz_solve_cuda.launches == 0 and greedy_match_cuda.launches == 0,
          "the mesh-forms phase launched K8 or K9")
    launches = {k: launches[k] + forms_launches[k] for k in launches}
    print(json.dumps({"mesh_forms_phase": forms, "launches": dict(forms_launches, toeplitz_solve=0, greedy_match=0),
                      "layout": forms["layout"], "transport": forms["transport"],
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 27, its counts from 0: the single-process references here launch K2 and K5 (27(a), phase 7's engine)
    # and K6 (27(b)'s paged tenancy); each host process counts its own K2, K5 and K6, which must be non-zero
    # (checked inside); K8 and K9 must stay 0
    for fn in kernels.values():
        fn.launches = 0
    toeplitz_solve_cuda.launches = greedy_match_cuda.launches = 0
    t0 = time.perf_counter()
    fleet = fleet_phase(dev, preds, target)
    fleet_launches = counts()
    for k in ("histogram", "megastep_fold", "megastep_segment"):
        check(fleet_launches[k] > 0, f"kernel {k} was not launched by the fleet phase's references")
    check(toeplitz_solve_cuda.launches == 0 and greedy_match_cuda.launches == 0, "the fleet phase launched K8 or K9")
    launches = {k: launches[k] + fleet_launches[k] for k in launches}
    print(json.dumps({"fleet_phase": fleet, "launches": dict(fleet_launches, toeplitz_solve=0, greedy_match=0),
                      "layout": fleet["layout"], "transport": fleet["transport"],
                      "seconds": time.perf_counter() - t0, "card": card}))

    # phase 4 against the CPU port (plain versions) and numpy
    cpu = torch.device("cpu")
    cpu_state, cpu_values, _ = main_path(cpu, torch.from_numpy(preds_np), torch.from_numpy(target_np))
    compare_states(gpu_state, cpu_state, "card vs CPU")
    compare_states(gpu_state, oracle_states(preds_np, target_np), "card vs numpy")
    for k in cpu_values:
        e = max_abs_err(gpu_values[k], cpu_values[k])
        check(e <= 1e-6, f"card vs CPU: value {k} err {e}")
    # phase 5 against phase 4
    compare_states(masked_state, gpu_state, "masked buckets vs one-shot")
    for k in gpu_values:
        check(max_abs_err(masked_values[k], gpu_values[k]) <= 1e-6, f"masked vs one-shot: value {k}")
    print(json.dumps({
        "main_path": {"rows": N_ROWS, "batch": BATCH, "classes": NUM_CLASSES, "thresholds": THRESHOLDS,
                      "one_shot_update_compute_s": one_shot_s, "masked_buckets": buckets,
                      "masked_update_compute_s": masked_s,
                      "accuracy": float(gpu_values["acc"]), "f1": float(gpu_values["f1"]),
                      "mean_ap": float(gpu_values["binned_ap"].mean())},
        "card": card,
    }))
    print(json.dumps(phases_line))

    entries = []
    hist_cal_entry["calibration_launches"] = dashboard["eager"]["calibration_k2_launches"]
    hist_auroc_entry["auroc_support_launches"] = curves["eager"]["auroc_support_k2_launches"]
    for e in (*fold_entries, *hist_entries, hist_cal_entry, hist_auroc_entry, *binned_entries, *segment_entries, *mega_fold_entries,
              *mega_seg_entries, *mega_q8_entries):
        e["launches"] = launches[e["name"]]
        e["card"] = card
        entries.append(e)
    fold_entry["launches"] = obs["traced"]["fold_k2_launches"]  # the scrape's folds in 18(a)
    fold_entry["card"] = card
    entries.append(fold_entry)
    for e in ragged_entries:  # phase 20's launches of the kernel, at every G
        e["launches"] = ragged_launches[e["name"]]
        e["card"] = card
        entries.append(e)
    entries.append(dict(signal["speech"]["solve"], card=card))  # K8: its launches are 22(a)'s
    entries.append(dict(signal["long_filter"]["solve"], card=card))  # K8 past 6144: its launches are 22(e)'s
    for e in k9_entries:  # K9: its launches are 24(a)'s compute and 24(c)'s first aggregate
        entries.append(dict(e, card=card))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
