"""End-to-end modification detection pipeline on PyTorch.

Counterpart of ``deepmod_tpu/engine/detect.py`` (the reference's detect
path, mDetect_manager -> detect_handler -> mDetect1 -> handle_record ->
mPredict1 -> sum_handler, myDetect.py:1124-1263, 948-984, 392-465,
488-782, 787-834, 1028-1120):

- fast5/pod5 batches are ingested, aligned and featurized on the host
  (``engine.host_worker``; with ``--threads N`` over several file
  batches, in N spawn workers of ``engine.host_pool``, which also write
  their batches' per-read outputs);
- ALL windows of a file batch are classified in large bucketed chunks by
  ``WindowPredictor``, on one device or split over several (every card of
  the machine by default): the BiLSTM center features come from the CUDA
  kernels (``ops.bilstm_fused``: K1 for odd windows up to 25, K4 for
  every other size) on the card, or from their plain versions on the
  CPU;
- predictions are scattered back to base maps, written in the reference's
  on-disk formats (predetail HDF5 + index files) and accumulated into
  per-(chr, strand) counters for the BEDs (``--device_aggregation 1``
  with more than one shard: one ``index_add_`` reduction a key and batch
  over the shards, ``parallel.aggregation``).

Under an initialized ``torch.distributed`` group (the caller starts it,
as ``testing.multihost_worker`` does), files are striped by rank, each
process writes its per-read outputs under ``p<rank>/``, the counts and
index parts are merged at the end of the run (``parallel.cross_process``)
and process 0 alone writes the BEDs.

``--predDet 0`` skips prediction and rebuilds the BEDs from an earlier
run's predetail HDF5 and index files (``engine.summarize``);
``--mod_cluster`` applies the inline CpG-cluster rescue before counting
and names the BEDs ``cluster_mod_pos.*``.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import functools
import glob
import os
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deepmod_tpu_torch.aggregate.summarize import (
    CountsMap,
    PositionCounts,
    write_bed,
)
from deepmod_tpu_torch.engine.outputs import (
    OutputOptions,
    batch_blocks,
    center_runs,
    run_centers,
    scatter_selected_preds,
    write_batch_outputs,
)
from deepmod_tpu_torch.models.bilstm import BiLSTMConfig, bilstm_logits
from deepmod_tpu_torch.models.tf_import import (
    load_model,
    params_from_numpy,
    params_to_numpy,
)
from deepmod_tpu_torch.ops.bilstm_fused import pack_bilstm_params, seq_dtype
from deepmod_tpu_torch.parallel.aggregation import sharded_position_counts
from deepmod_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    process_count,
    process_index,
)
from deepmod_tpu_torch.utils import ErrorCensus
from deepmod_tpu_torch.utils.device import resolve_device
from deepmod_tpu_torch.utils.profiling import StageTimer, count, span

PRE_BASE_STR = "rnn.pred.ind"  # index-file infix (myDetect.py:39)

# depth of the chunk queue in WindowPredictor: chunk i+k is prepared on
# the host and enqueued while chunk i computes; its result is fetched
# only when the queue is full
_LOOKAHEAD = 2


@dataclasses.dataclass
class DetectConfig:
    wrk_base: str
    ref: str
    model_path: str
    out_folder: str
    file_id: str = "mod"
    base: str = "C"
    fnum: int = 7
    window_size: int = 21
    align_str: str = "auto"
    basecall_1d: str = "Basecall_1D_000"
    basecall_2strand: str = "BaseCalled_template"
    signal_group: str = "simple"
    move: bool = False
    con_unk: bool = True
    # regions: list of (chrom|None, start|None, end|None) (DeepMod.py:152-160)
    regions: Sequence[Tuple[Optional[str], Optional[int], Optional[int]]] = (
        (None, None, None),
    )
    recursive: bool = True
    files_per_batch: int = 1000
    pred_det: bool = True
    pred_path: Optional[str] = None   # for summarize-only mode
    write_per_read: bool = True       # predetail HDF5 + index files
    mod_cluster: bool = False
    output_layer: str = ""            # '' | 'sigmoid' (myMultiBiRNN.py:50-53)
    hidden: int = 100                 # validated against the model
    threads: int = 1
    precision: str = "bf16"           # 'fp32' | 'bf16' kernel contract
    # manual multi-run sharding: (host_id, num_hosts) processes
    # files[host_id::num_hosts]
    host_shard: Optional[Tuple[int, int]] = None
    trace_dir: Optional[str] = None   # torch.profiler chrome trace output
    device_aggregation: bool = False
    # classify only windows whose reference base IS the target (BED-
    # identical; per-read files carry mod_pred 0 on non-target rows)
    target_only: bool = False
    # dorado-style basecall BAM/SAM (mv:B:c + ts:i tags) for .pod5 inputs
    basecalls: str = ""
    strict_ref_clips: bool = True
    predetail_gzip: int = 1
    device: str = "cuda"              # 'cuda' | 'cpu' (explicit only)


@dataclasses.dataclass
class DetectResult:
    out_folder: str
    bed_files: List[str]
    num_reads: int
    num_windows: int
    errors: Dict[str, List[str]]
    elapsed_s: float
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


class WindowPredictor:
    """Bucketed window classification on one device or over a mesh's
    shards.

    Materialized windows are cut into chunks of a small set of bucket
    sizes (the last partial chunk pads up to the smallest covering
    bucket; padding rows are zeros and their predictions are dropped); a
    compact chunk holds the rows its asked windows read, up to the
    largest bucket, and runs no tail. Host->device copies go through
    pinned memory with ``non_blocking=True`` and results come back through
    an async copy and an event, so the host prepares chunk i+1 while the
    device computes chunk i. Compact transfer ships each chunk's feature
    rows in the caller's fp32, as they stand, and casts them once to the
    kernel's dtype on the device. It reads the rows from the reads' own
    blocks (``predict_from_blocks``): each chunk's rows are gathered from
    the blocks that overlap them into a pinned host buffer, and its
    centers are derived from the asked runs inside the chunk loop, so the
    host makes no pass over the batch before the first chunk goes.
    PyTorch's caching host allocator serves those buffers and hands one
    out again only once the copies that read it have completed.

    Data parallel (more than one shard): ``devices`` lists this process's
    shards, one entry a shard, repeats allowed (by default every visible
    CUDA device when ``device`` is ``"cuda"`` and the machine has more
    than one; an explicit ``"cuda:N"`` keeps one card). The weights are packed once a
    device; each chunk's windows are split contiguously over the shards,
    each shard copies its rows (with the T-1 rows of halo its last
    windows read) to its device and runs the kernel there on its own
    stream, and the predictions come back in order: the same bits as one
    shard, since every window is computed alone. The JAX predictor
    shards over ``jax.devices()``, the global devices; this one over the
    process's local devices.
    """

    def __init__(
        self,
        params,
        config: BiLSTMConfig,
        buckets: Optional[Sequence[int]] = None,
        device: Union[str, torch.device] = "cuda",
        precision: str = "fp32",
        compact_transfer: Optional[bool] = None,
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
    ):
        self.config = config
        if devices is None:
            if (torch.device(device) == torch.device("cuda")
                    and torch.cuda.is_available()
                    and torch.cuda.device_count() > 1):
                devices = make_mesh().devices
            else:
                devices = [device]
        self.mesh = make_mesh(devices=devices)
        self.devices = self.mesh.devices
        self.device = self.devices[0]
        if any(d.type != self.device.type for d in self.devices):
            raise ValueError(f"mixed device types in {self.devices}")
        self._cuda = self.device.type == "cuda"
        if buckets is None:
            buckets = (
                (512, 4096, 16384, 65536, 131072, 262144)
                if self._cuda else (512, 4096, 16384)
            )
        self.buckets = sorted(buckets)
        self.precision = precision
        self._dtype = seq_dtype(precision)
        self.params = params_from_numpy(params_to_numpy(params), self.device)
        self._model = pack_bilstm_params(self.params, config, precision)
        if compact_transfer is None:
            # ship compact (rows, fnum) feature blocks and let the kernel
            # read each window in place: 10-21x fewer host->device bytes
            # than materialized windows (bf16 / fp32)
            compact_transfer = self._cuda
        self.compact_transfer = bool(compact_transfer)
        # one replica of the packed weights a device
        self._replicas = {self.device: self._model}
        for dev in self.devices:
            if dev not in self._replicas:
                self._replicas[dev] = pack_bilstm_params(
                    params_from_numpy(self.params, dev), config, precision)
        self._streams = None
        if self._cuda and len(self.devices) > 1:
            self._streams = [torch.cuda.Stream(device=d) for d in self.devices]
            for dev in self._replicas:
                torch.cuda.synchronize(dev)  # replicas built before use
        # kernel launches of each shard (K1 or K4, from the wrappers'
        # counts around the shard's classification)
        self.shard_launches = [0] * len(self.devices)
        self._fn = self._classify
        # host->device payload bytes dispatched (features/windows only).
        # Monotonic across calls — callers snapshot before/after.
        self.transfer_bytes = 0

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    # -- device plumbing -------------------------------------------------

    def _classify(self, x: torch.Tensor) -> torch.Tensor:
        """(N, T, F) device tensor (any strides) -> (N,) int8 predictions."""
        model = self._replicas[x.device]
        logits = bilstm_logits(model, x, self.config, self.precision)
        return torch.argmax(logits, dim=-1).to(torch.int8)

    def _to_device(self, host: torch.Tensor,
                   device: Optional[torch.device] = None) -> torch.Tensor:
        self.transfer_bytes += host.numel() * host.element_size()
        with span("detect.h2d"):
            if not self._cuda:
                return host
            return host.pin_memory().to(device or self.device,
                                        non_blocking=True)

    def _launch(self, preds: torch.Tensor):
        """Start the result fetch; returns a handle for ``_fetch``."""
        if not self._cuda:
            return preds, []
        host = torch.empty(preds.shape, dtype=preds.dtype, pin_memory=True)
        host.copy_(preds, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, [done]

    def _dispatch(self, n: int, windows_on):
        """Classify ``n`` windows; ``windows_on(lo, hi, device)`` gives
        windows lo..hi-1 as an (hi-lo, T, F) tensor on ``device``. One
        shard: the current stream. Several: contiguous slices of the
        windows, each on its shard's device and stream, written into one
        host buffer in order. Returns a handle for ``_fetch``."""
        count("detect.windows_run", n)
        with span("detect.dispatch"):
            if len(self.devices) == 1:
                return self._launch(self._fn(windows_on(0, n, self.device)))
            from deepmod_tpu_torch.ops import bilstm_fused as ops

            host = torch.empty(n, dtype=torch.int8, pin_memory=self._cuda)
            events = []
            bounds = np.linspace(0, n, len(self.devices) + 1).round()
            bounds = bounds.astype(int)
            for s, dev in enumerate(self.devices):
                lo, hi = int(bounds[s]), int(bounds[s + 1])
                if hi == lo:
                    continue
                before = _kernel_launches(ops)
                if self._streams is None:
                    host[lo:hi] = self._fn(windows_on(lo, hi, dev))
                else:
                    stream = self._streams[s]
                    stream.wait_stream(torch.cuda.current_stream(dev))
                    with torch.cuda.stream(stream):
                        host[lo:hi].copy_(self._fn(windows_on(lo, hi, dev)),
                                          non_blocking=True)
                        done = torch.cuda.Event()
                        done.record(stream)
                        events.append(done)
                self.shard_launches[s] += _kernel_launches(ops) - before
            return host, events

    @staticmethod
    def _fetch(handle) -> np.ndarray:
        host, events = handle
        for done in events:
            done.synchronize()
        return host.numpy()

    def _host_cast(self, arr: np.ndarray) -> torch.Tensor:
        """numpy -> CPU tensor in the transfer dtype. bf16 mode casts on
        the host (round to nearest even, as a device cast would), halving
        host->device bytes."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self._dtype)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    # -- window transfer -------------------------------------------------

    def _host_windows(self, windows: torch.Tensor, lo: int, hi: int,
                      device: torch.device) -> torch.Tensor:
        return self._to_device(windows[lo:hi], device)

    def predict(self, windows: np.ndarray) -> np.ndarray:
        """(N, T, F) -> (N,) int8 predictions."""
        n = len(windows)
        count("detect.windows_asked", n)
        if n == 0:
            return np.empty(0, np.int8)
        with span("detect.pack"):
            windows = self._host_cast(windows)

        def chunks():
            done = 0
            # consume DESCENDING buckets greedily, but stop descending once
            # the remainder's covering bucket pads with bounded waste (<=
            # max of the smallest bucket and ~1.5% of n): fewer device calls
            # than a full descent, far less padding than one top bucket
            max_waste = max(self.buckets[0], n >> 6)
            for b in reversed(self.buckets):
                while n - done >= b:
                    with span("detect.chunk"):
                        windows_on = functools.partial(
                            self._host_windows, windows[done : done + b])
                    yield b, windows_on, slice(done, done + b), slice(0, b)
                    done += b
                rem = n - done
                if rem == 0 or self._bucket_for(rem) - rem <= max_waste:
                    break
            if done < n:
                with span("detect.chunk"):
                    rem = n - done
                    bucket = self._bucket_for(rem)
                    if bucket == rem:
                        tail = windows[done:]
                    else:
                        tail = torch.zeros(
                            (bucket,) + tuple(windows.shape[1:]),
                            dtype=windows.dtype)
                        tail[:rem] = windows[done:]
                yield (bucket, functools.partial(self._host_windows, tail),
                       slice(done, n), slice(0, rem))

        return self._pipeline(n, chunks())

    def _pipeline(self, n: int, chunks) -> np.ndarray:
        """The chunk queue both transfers share. ``chunks`` yields ``(m,
        windows_on, dst, keep)`` a chunk: ``m`` windows to classify, as
        ``_dispatch`` takes them, and where their predictions go, ``out[dst]
        = preds[keep]``. Each chunk is dispatched as soon as it is made;
        the oldest is fetched once more than ``_LOOKAHEAD`` are in flight,
        and the rest at the end. Returns ``out``, the (n,) predictions."""
        out = np.empty(n, np.int8)
        inflight = deque()

        def drain(limit: int) -> None:
            while len(inflight) > limit:
                with span("detect.fetch"):
                    dst, keep, handle = inflight.popleft()
                    out[dst] = self._fetch(handle)[keep]

        for m, windows_on, dst, keep in chunks:
            inflight.append((dst, keep, self._dispatch(m, windows_on)))
            drain(_LOOKAHEAD)
        drain(0)
        return out

    # -- compact transfer ------------------------------------------------

    def _window_view(self, staged: torch.Tensor, window: int, lo: int,
                     hi: int, device: torch.device) -> torch.Tensor:
        """Windows lo..hi-1 of a staged fp32 row chunk on ``device``: rows
        lo..hi+T-2 (the T-1 rows of halo) copied over, cast there to the
        kernel's dtype (round to nearest even, the host cast's bits; none
        at fp32), and the overlapping window view the kernel reads in
        place."""
        feats = self._to_device(staged[lo : hi + window - 1], device)
        count("detect.rows_cast_on_device", len(feats))
        feats = feats.to(self._dtype)
        fnum = feats.shape[1]
        return feats.as_strided((hi - lo, window, fnum), (fnum, fnum, 1))

    def _compact(self, n: int, window: int, rows: int) -> bool:
        """Whether ``n`` windows over ``rows`` feature rows take compact
        transfer. SPARSE selections (n * window < rows) take the
        materialized-window path, which then moves fewer bytes and runs
        fewer windows; dense ones ship each feature row once."""
        return self.compact_transfer and n * window >= rows

    def predict_from_features(
        self, features: np.ndarray, centers: np.ndarray, window: int = 21,
        assume_packable: bool = False,
    ) -> np.ndarray:
        """Classify windows cut from compact per-read feature blocks.

        ``features``: concatenated (rows, fnum) blocks, each with the rows
        its windows read on either side (``engine.outputs.batch_blocks``
        trims the engine's +-100 pad to them); ``centers``: absolute row
        index of each window's center. On the compact path, the one-block
        case of ``predict_from_blocks``.

        ``assume_packable`` has no effect; it stays only for callers
        outside the package.
        """
        n = len(centers)
        if n == 0:
            return np.empty(0, np.int8)
        if self._compact(n, window, len(features)):
            return self._predict_compact([features], *center_runs(centers),
                                         window)
        return self._predict_windows(features, centers, window)

    def predict_from_blocks(
        self, blocks: Sequence[np.ndarray], firsts: np.ndarray,
        counts: np.ndarray, window: int = 21,
    ) -> np.ndarray:
        """Classify windows cut from per-read (rows, fnum) feature blocks
        read as laid end to end; the compact path stages each chunk's rows
        from the blocks and never concatenates them. The windows asked are
        runs of consecutive centers of that layout, run q the ``counts[q]``
        rows from row ``firsts[q]`` (``engine.outputs.center_runs``),
        ascending; the predictions come in their order."""
        firsts = np.asarray(firsts, np.int64)
        counts = np.asarray(counts, np.int64)
        firsts, counts = firsts[counts > 0], counts[counts > 0]
        n = int(counts.sum())
        if n == 0:
            return np.empty(0, np.int8)
        if self._compact(n, window, sum(len(b) for b in blocks)):
            return self._predict_compact(blocks, firsts, counts, window)
        return self._predict_windows(np.concatenate(blocks),
                                     run_centers(firsts, counts), window)

    def _predict_windows(self, features: np.ndarray, centers: np.ndarray,
                         window: int) -> np.ndarray:
        """Materialized-window transfer: each asked window cut on the
        host."""
        half = window // 2
        with span("detect.pack"):
            view = np.lib.stride_tricks.sliding_window_view(
                features, window, axis=0)
            windows = np.moveaxis(view[centers - half], 2, 1)
        return self.predict(windows)

    def _stage(self, blocks: Sequence[np.ndarray], starts: np.ndarray,
               row0: int, rows: int) -> torch.Tensor:
        """Rows [row0, row0 + rows) of ``blocks`` read as laid end to end
        (block b from row ``starts[b]``), padded with zeros, gathered in
        fp32 into a new host buffer: pinned on the card, from PyTorch's
        caching host allocator, so ``_to_device`` copies it as it stands
        and the buffer is reused only once that copy has completed."""
        buf = torch.empty((rows,) + tuple(blocks[0].shape[1:]),
                          dtype=torch.float32, pin_memory=self._cuda)
        _gather(blocks, starts, row0, buf.numpy())
        return buf

    def _predict_compact(
        self, blocks: Sequence[np.ndarray], firsts: np.ndarray,
        counts: np.ndarray, window: int,
    ) -> np.ndarray:
        """Ship (rows, fnum) row chunks, classify every window a chunk's
        rows hold (the kernel reads window i as rows i..i+T-1 in place),
        keep the asked centers' predictions on the host. A chunk runs from
        the first row its first asked window reads and holds as many rows
        as the asked windows left read, up to the largest bucket; the
        windows between two reads' runs are run too, so blocks trimmed to
        their windows' rows (``batch_blocks``) leave T-1 of them a read.
        Bit-identical to window transfer: the window build is a pure copy,
        and the bf16 rounding of the same fp32 values rounds to nearest
        even on the device as on the host."""
        n = int(counts.sum())
        count("detect.windows_asked", n)
        half = window // 2
        lasts = firsts + counts - 1
        with span("detect.pack"):
            lengths = np.array([len(b) for b in blocks], np.int64)
            starts = np.cumsum(lengths) - lengths
        rows = int(lengths.sum())
        if np.any(firsts[1:] < lasts[:-1]):
            raise ValueError("compact transfer requires ascending centers")
        # a window centred on row c reads rows c - half .. c - half + T - 1
        if int(firsts[0]) < half or int(lasts[-1]) - half + window > rows:
            raise ValueError(
                "compact transfer requires a full window inside features "
                f"for every center (first={int(firsts[0])}, "
                f"last={int(lasts[-1])}, rows={rows}, window={window})"
            )
        # cum[q]: the windows asked before run q
        cum = np.concatenate([[0], np.cumsum(counts)])
        # a row chunk must cover at least one full window or the loop
        # below cannot advance (buckets may be narrower than a window)
        min_rows = 1 << int(window).bit_length()

        def chunks():
            i = 0
            while i < n:
                with span("detect.chunk"):
                    r = int(np.searchsorted(cum, i, "right")) - 1  # i's run
                    row0 = int(firsts[r] + i - cum[r]) - half
                    # the rows the asked windows from window i on read, up
                    # to the largest bucket
                    span_rows = int(lasts[-1]) - half + window - row0
                    chunk = max(min(span_rows, self.buckets[-1]), min_rows)
                    # centers computable from rows [row0, row0+chunk):
                    # c - half + T <= row0 + chunk; runs r..k-1 hold them
                    limit = row0 + chunk + half - window + 1
                    k = int(np.searchsorted(firsts, limit, "left"))
                    j = int(cum[k - 1]
                            + min(counts[k - 1], limit - firsts[k - 1]))
                    # each asked window's index among the chunk's windows
                    took = (np.minimum(cum[r + 1 : k + 1], j)
                            - np.maximum(cum[r:k], i))
                    idx = (np.arange(i, j) - row0 - half
                           + np.repeat(firsts[r:k] - cum[r:k], took))
                    with span("detect.stage"):
                        staged = self._stage(blocks, starts, row0, chunk)
                yield (chunk - window + 1,
                       functools.partial(self._window_view, staged, window),
                       slice(i, j), idx)
                i = j

        return self._pipeline(n, chunks())


def _kernel_launches(ops) -> int:
    """K1 and K4 launches so far (the wrappers' counts)."""
    return sum(ops.LAUNCHES.values()) + sum(ops.LAYERED_LAUNCHES.values())


def _gather(blocks: Sequence, starts: np.ndarray, row0: int, dst) -> None:
    """Rows [row0, row0 + len(dst)) of ``blocks`` laid end to end (block b
    from row ``starts[b]``) into ``dst``; rows past the last block are
    zeros. ``dst`` and the blocks are numpy arrays or torch tensors
    alike."""
    b = int(np.searchsorted(starts, row0, "right")) - 1
    pos = 0
    while pos < len(dst) and b < len(blocks):
        lo = row0 + pos - int(starts[b])
        take = min(len(blocks[b]) - lo, len(dst) - pos)
        dst[pos : pos + take] = blocks[b][lo : lo + take]
        pos += take
        b += 1
    dst[pos:] = 0


def discover_fast5(wrk_base: str, recursive: bool = True) -> List[str]:
    """Glob fast5 (and pod5) files up to 4 levels deep
    (myDetect.py:1142-1146; .pod5 is beyond the reference)."""
    files = []
    for ext in ("*.fast5", "*.pod5"):
        files.extend(glob.glob(os.path.join(wrk_base, ext)))
        if recursive:
            for depth in ("*/", "*/*/", "*/*/*/"):
                files.extend(glob.glob(os.path.join(wrk_base, depth + ext)))
    return files


def _host_options(config: DetectConfig):
    from .host_worker import HostOptions

    return HostOptions(
        ref=config.ref,
        align_str=config.align_str,
        fnum=config.fnum,
        window_size=config.window_size,
        base=config.base,
        con_unk=config.con_unk,
        regions=tuple(config.regions),
        basecall_1d=config.basecall_1d,
        basecall_2strand=config.basecall_2strand,
        signal_group=config.signal_group,
        move=config.move,
        basecalls=config.basecalls,
        min_events=50,
        cpg_canonicalize=True,
        strict_ref_clips=config.strict_ref_clips,
    )


def predict_batch_windows(
    results, predictor: WindowPredictor, timer=None,
    target_base: Optional[str] = None,
) -> np.ndarray:
    """The DEVICE part of one batch: classify every read's windows (only
    refbase == ``target_base`` windows when set, detect --targetOnly)
    straight from the reads' feature blocks, which the compact path stages
    chunk by chunk without concatenating them."""
    with span("device_inference", timer):
        with span("detect.request"):
            window = predictor.config.timesteps
            blocks, firsts, counts, selections, n_total = batch_blocks(
                results, target_base, window)
        preds_sel = predictor.predict_from_blocks(
            blocks, firsts, counts, window=window)
        with span("detect.scatter"):
            return scatter_selected_preds(results, selections, preds_sel,
                                          n_total)


def apply_batch_outputs(
    results,  # List[HostReadResult]
    preds: np.ndarray,
    config: DetectConfig,
    counts: CountsMap,
    batch_id: int,
    ct_folder: str,
    timer=None,
    agg_mesh: Optional[Mesh] = None,
) -> Tuple[int, int, List[List[str]]]:
    """The OUTPUT part of one batch: prediction scatter, per-read HDF5,
    count accumulation. Mutates ``counts``: one thread at a time. With
    ``agg_mesh`` (device aggregation), each key's coverage and mod counts
    of the batch go through ONE reduction over the mesh's shards."""
    if not results:
        return 0, 0, []
    batch_obs: Dict[Tuple[str, str], list] = {}

    def collect_for_device(key, item) -> bool:
        # defer cov/mod to ONE device reduction per key per batch; `seen`
        # (a boolean, no addition) is set host-side immediately
        if not counts[key].dense:
            return False
        bm = item.base_map
        is_target = bm["refbase"] == config.base
        counts[key].seen[bm["refbasei"][is_target].astype(np.int64)] = True
        sel = is_target & (bm["readbase"] != "-")
        pos = bm["refbasei"][sel].astype(np.int64)
        batch_obs.setdefault(key, []).append(
            (pos, (bm["mod_pred"][sel] == 1).astype(np.int64))
        )
        return True

    with span("outputs_and_aggregation", timer):
        n_reads, n_windows, index_entries = write_batch_outputs(
            results, preds, _output_options(config), counts, batch_id,
            ct_folder,
            collect=collect_for_device if agg_mesh is not None else None,
        )
    if batch_obs:
        with span("device_aggregation", timer):
            for key, obs in batch_obs.items():
                pos = np.concatenate([o[0] for o in obs])
                mod = np.concatenate([o[1] for o in obs])
                _device_accumulate(agg_mesh, counts[key], pos,
                                   np.ones(len(pos), np.int64), mod)
    return n_reads, n_windows, index_entries


def _output_options(config: DetectConfig) -> OutputOptions:
    return OutputOptions(
        wrk_base=config.wrk_base,
        out_base=os.path.join(config.out_folder, config.file_id),
        base=config.base,
        write_per_read=config.write_per_read,
        mod_cluster=config.mod_cluster,
        gzip_level=config.predetail_gzip,
    )


def _device_accumulate(mesh: Mesh, pc, pos: np.ndarray, cov: np.ndarray,
                       mod: np.ndarray) -> None:
    """One reduction of a batch's (positions, coverage, mod) observations:
    an ``index_add_`` a shard and the sum over the mesh's LOCAL shards
    (``parallel.aggregation``). Under a multi-process group each process
    reduces its own batches (batch counts differ by process, so a
    collective here would deadlock); the end-of-run merge
    (``parallel.cross_process``) combines the processes' counts."""
    pad = (-len(pos)) % mesh.local_size
    if pad:
        pos = np.concatenate([pos, np.zeros(pad, np.int64)])
        mod = np.concatenate([mod, np.zeros(pad, np.int64)])
        cov = np.concatenate([cov, np.zeros(pad, np.int64)])
    cov_vec, mod_vec = sharded_position_counts(mesh, pos, cov, mod, pc.length)
    pc.coverage += cov_vec.cpu().numpy()
    pc.mod_count += mod_vec.cpu().numpy()


def _merge_counts_coo(
    counts: CountsMap, coo, agg_mesh: Optional[Mesh] = None, timer=None
) -> None:
    """Fold a worker batch's COO count summary into the engine's counters
    — the only serialized piece of the output stage under HostPool; with
    ``agg_mesh``, through the device reduction."""
    for chrom, strand, length, pos, cov, mod in coo:
        key = (chrom, strand)
        if key not in counts:
            counts[key] = PositionCounts.zeros(length)
        pc = counts[key]
        if agg_mesh is not None and pc.dense and len(pos):
            pc.seen[pos] = True
            with span("device_aggregation", timer):
                _device_accumulate(agg_mesh, pc, pos, cov.astype(np.int64),
                                   mod.astype(np.int64))
        else:
            pc.add_coo(pos, cov, mod)


def _write_index_files(
    index_entries: List[List[str]], config: DetectConfig, part_dir: str = ""
) -> None:
    """Merged per-chromosome index files (myDetect.py:1195-1221).

    ``part_dir`` ('p<pid>' under a multi-process group) writes each
    process's part INSIDE its private output tree, so processes on a
    shared filesystem never clobber each other and part names can never
    collide with merged outputs; process 0 then combines the parts
    (``parallel.cross_process.merge_index_parts``)."""
    out_base = os.path.join(config.out_folder, config.file_id)
    if part_dir:
        os.makedirs(os.path.join(out_base, part_dir), exist_ok=True)
    by_chr: Dict[str, List[List[str]]] = defaultdict(list)
    for entry in index_entries:
        by_chr[entry[0]].append(entry)
    for chrom, entries in by_chr.items():
        entries = sorted(
            entries, key=lambda e: (e[0], e[1], int(e[2]), e[3], e[4], e[5])
        )
        path = os.path.join(out_base, part_dir, f"{PRE_BASE_STR}.{chrom}")
        with open(path, "w") as fh:
            fh.write(f"#base_folder_fast5 {config.wrk_base} \n")
            fh.write(
                f"#base_folder_output {os.path.abspath(out_base)} \n"
            )
            for entry in entries:
                fh.write(" ".join(entry + ["\n"]))


def detect_run(
    config: DetectConfig,
    predictor: Optional[WindowPredictor] = None,
    host_pool=None,
) -> DetectResult:
    """Full detect: per-read prediction + genomic summaries + BED.

    With ``pred_det=False``, skips prediction and rebuilds summaries from
    an existing run's prediction files (the reference's --predDet 0 path,
    myDetect.py:1230-1263): no model is loaded and no device is touched.
    ``predictor`` reuses an already-built WindowPredictor (device-resident
    weights) across runs; it must match the configured model.
    ``host_pool`` likewise reuses a warm ``engine.host_pool.HostPool``
    (spawned workers with their aligner index loaded); its HostOptions
    must match the config's."""
    if not config.trace_dir:
        return _detect_run_inner(config, predictor, host_pool)
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(config.device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        result = _detect_run_inner(config, predictor, host_pool)
    os.makedirs(config.trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(config.trace_dir, "detect.json"))
    return result


def _detect_run_inner(
    config: DetectConfig,
    predictor: Optional[WindowPredictor] = None,
    host_pool=None,
) -> DetectResult:
    start_time = time.time()
    if not config.pred_det:
        from .summarize import summarize_run

        pred_path = config.pred_path or os.path.join(
            config.out_folder, config.file_id
        )
        bed_files = summarize_run(
            pred_path, config.out_folder, config.base, config.mod_cluster
        )
        open(config.out_folder.rstrip("/") + ".done", "w").close()
        return DetectResult(
            out_folder=config.out_folder,
            bed_files=bed_files,
            num_reads=0,
            num_windows=0,
            errors={},
            elapsed_s=time.time() - start_time,
        )
    os.makedirs(os.path.join(config.out_folder, config.file_id), exist_ok=True)

    if predictor is None:
        params, model_config = load_model(config.model_path)
        model_config = dataclasses.replace(
            model_config,
            timesteps=config.window_size,
            output_layer=config.output_layer or model_config.output_layer,
        )
        if model_config.num_input != config.fnum:
            raise ValueError(
                f"model expects fnum={model_config.num_input}, got {config.fnum}"
            )
        if model_config.num_hidden != config.hidden:
            raise ValueError(
                f"model expects hidden={model_config.num_hidden}, got {config.hidden}"
            )
        predictor = WindowPredictor(
            params, model_config, device=config.device,
            precision=config.precision,
        )

    timer = StageTimer()
    files = sorted(discover_fast5(config.wrk_base, config.recursive))
    nproc, pid = process_count(), process_index()
    if config.host_shard is not None and nproc > 1:
        # every process would parse the SAME stripe and write colliding
        # outputs (multi_proc turns off below) — reject loudly
        raise ValueError(
            "host_shard is for the manual multi-run workflow (independent "
            "hosts); under a torch.distributed runtime file sharding and "
            "the collective BED merge are automatic — drop --hostShard"
        )
    if config.host_shard is not None:
        host_id, num_hosts = config.host_shard
        files = files[host_id::num_hosts]
    elif nproc > 1:
        files = files[pid::nproc]
    # device aggregation reduces over the predictor's local shards; with
    # one shard it stays on the host, as JAX's does on one device
    agg_mesh = getattr(predictor, "mesh", None)
    if not (config.device_aggregation and agg_mesh is not None
            and agg_mesh.local_size > 1):
        agg_mesh = None
    errors = ErrorCensus()
    counts: CountsMap = {}
    all_index: List[List[str]] = []
    n_reads = 0
    n_windows = 0
    out_futs: List = []

    def drain_outputs(limit: int) -> None:
        nonlocal n_reads, n_windows
        while len(out_futs) > limit:
            r, w, idx = out_futs.pop(0).result()
            n_reads += r
            n_windows += w
            all_index.extend(idx)

    from .host_worker import host_process_files, init_worker

    host_opts = _host_options(config)
    sub_folder_size = 100  # batches per subfolder (myDetect.py:1163)
    n_batches = max(1, (len(files) + config.files_per_batch - 1) // config.files_per_batch)
    batches = [
        files[i * config.files_per_batch : (i + 1) * config.files_per_batch]
        for i in range(n_batches)
    ]
    # under a multi-process group every process writes its per-read
    # outputs into a private p<pid>/ tree (batch ids restart at 0 in each
    # process, so shared paths would collide)
    multi_proc = nproc > 1 and config.host_shard is None
    proc_dir = f"p{pid}" if multi_proc else ""

    def ct_folder_for(batch_id: int) -> str:
        folder = os.path.join(
            config.out_folder, config.file_id, proc_dir,
            str(batch_id // sub_folder_size),
        )
        os.makedirs(folder, exist_ok=True)
        return folder

    todo = [(batch_id, batch) for batch_id, batch in enumerate(batches) if batch]
    if config.threads > 1 and len(batches) > 1:
        # host stages AND output writes in spawn workers (they never touch
        # the device): each worker ingests a batch, ships the compact
        # feature block up for classification here, receives the
        # predictions back and writes ITS batch's predetail HDF5 in
        # parallel with the other workers (per-batch files, the
        # reference's own exclusivity, myDetect.py:714-760). Only the COO
        # count merge is serialized here.
        from .host_pool import HostPool

        out_opts = _output_options(config)
        target_base = config.base if config.target_only else None
        own_pool = host_pool is None
        pool = host_pool if host_pool is not None else HostPool(
            config.threads, host_opts
        )
        if pool.host_opts != host_opts:
            raise ValueError(
                "host_pool was built with different HostOptions than this "
                "config resolves to — reuse is only valid across runs over "
                "the same reference/aligner/feature settings"
            )
        queued = deque(todo)
        bid_to_batch: Dict[int, int] = {}  # pool bid -> run batch id
        outstanding = 0
        ok = False
        try:
            while queued or outstanding:
                # keep every live worker ~2 batches deep: one being
                # ingested, one awaiting preds/writing outputs
                while queued:
                    load = pool.min_load()
                    if load is None:  # every worker died: fail the rest
                        while queued:
                            batch_id, _ = queued.popleft()
                            errors.add(
                                "Batch worker failed: WorkerDied",
                                f"batch_{batch_id}",
                            )
                        break
                    if load >= 2:
                        break
                    batch_id, batch = queued.popleft()
                    bid = pool.submit_ingest(
                        batch_id, batch, ct_folder_for(batch_id),
                        out_opts, target_base, predictor.config.timesteps,
                    )
                    bid_to_batch[bid] = batch_id
                    outstanding += 1
                if not outstanding:
                    continue
                # the engine's wait on the host stage (the single-process
                # path's counterpart: host_ingest_align_features)
                with span("wait_for_host_workers", timer):
                    msg = pool.next_message()
                kind = msg[0]
                if kind == "features":
                    _, wid, bid, feats, centers, batch_errors = msg
                    for ekind, paths in batch_errors.items():
                        errors.extend(ekind, paths)
                    with span("device_inference", timer):
                        preds_sel = predictor.predict_from_features(
                            feats, centers,
                            window=predictor.config.timesteps)
                    pool.send_preds(wid, bid, preds_sel)
                elif kind == "outputs":
                    (_, wid, bid, n_r, n_w, idx, coo, secs,
                     batch_errors) = msg
                    for ekind, paths in batch_errors.items():
                        errors.extend(ekind, paths)
                    n_reads += n_r
                    n_windows += n_w
                    all_index.extend(idx)
                    if secs:
                        timer.add("outputs_in_workers", secs)
                    with span("counts_merge", timer):
                        _merge_counts_coo(counts, coo, agg_mesh, timer)
                    bid_to_batch.pop(bid, None)
                    outstanding -= 1
                elif kind == "error":
                    _, wid, bid, phase, message = msg
                    errors.add(
                        f"Batch worker failed: {message.split(':')[0]}",
                        f"batch_{bid_to_batch.pop(bid, bid)}",
                    )
                    outstanding -= 1
            ok = True
        finally:
            if own_pool:
                pool.close()
            elif not ok:
                # a shared pool must come back clean after this run's
                # exception: drop its in-flight state and the workers'
                # stashed batches so the next run schedules freshly
                pool.abandon_inflight()
    else:
        # a prefetch thread prepares the NEXT batch's host work while the
        # device consumes the current one, and a writer thread overlaps
        # the output stage with the next batch's inference
        init_worker(host_opts)
        with cf.ThreadPoolExecutor(max_workers=1) as prefetch, \
                cf.ThreadPoolExecutor(max_workers=1) as writer:
            future = (
                prefetch.submit(host_process_files, todo[0][1])
                if todo else None
            )
            for pos, (batch_id, batch) in enumerate(todo):
                try:
                    with span("host_ingest_align_features", timer):
                        results, batch_errors = future.result()
                except Exception as exc:
                    errors.add(
                        f"Batch worker failed: {type(exc).__name__}",
                        f"batch_{batch_id}",
                    )
                    results, batch_errors = [], {}
                if pos + 1 < len(todo):
                    future = prefetch.submit(
                        host_process_files, todo[pos + 1][1]
                    )
                for kind, paths in batch_errors.items():
                    errors.extend(kind, paths)
                if not results:
                    continue
                preds = predict_batch_windows(
                    results, predictor, timer,
                    target_base=config.base if config.target_only else None,
                )
                for r in results:
                    r.features = None  # outputs never read them
                out_futs.append(
                    writer.submit(
                        apply_batch_outputs, results, preds, config, counts,
                        batch_id, ct_folder_for(batch_id), timer, agg_mesh,
                    )
                )
                drain_outputs(2)  # bound the writer backlog
            drain_outputs(0)

    if config.write_per_read:
        _write_index_files(all_index, config, part_dir=proc_dir)

    if multi_proc:
        # the collective merge replacing the reference's filesystem
        # barrier (myDetect.py:1196-1221): per-(chr, strand) COO counts
        # are all-gathered across processes (deterministic key grid from
        # the replicated FASTA), then process 0 alone writes the BEDs
        from deepmod_tpu_torch.io.fasta import FastaReference
        from deepmod_tpu_torch.parallel.cross_process import (
            merge_counts_across_processes,
            merge_index_parts,
        )

        with span("cross_process_merge", timer):
            ref_fa = FastaReference(config.ref)
            chrom_lengths = {n: ref_fa.length(n) for n in ref_fa.names()}
            counts = merge_counts_across_processes(counts, chrom_lengths)
        if config.write_per_read and pid == 0:
            # every process has written its index parts once it reaches
            # the collective above; merge on the lead process (no-op for
            # parts on another host's private disk)
            merge_index_parts(
                os.path.join(config.out_folder, config.file_id),
                PRE_BASE_STR, nproc,
            )

    bed_files: List[str] = []
    if pid == 0 or not multi_proc:
        prefix = "cluster_mod_pos" if config.mod_cluster else "mod_pos"
        for (chrom, strand), pc in sorted(counts.items()):
            bed_path = os.path.join(
                config.out_folder,
                f"{prefix}.{chrom}{strand}.{config.base}.bed",
            )
            if write_bed(bed_path, chrom, strand, config.base, pc) > 0:
                bed_files.append(bed_path)

        # completion sentinel (myDetect.py:1263)
        open(config.out_folder.rstrip("/") + ".done", "w").close()
    if multi_proc:
        # the other processes return only after the lead wrote the outputs
        torch.distributed.barrier()
    return DetectResult(
        out_folder=config.out_folder,
        bed_files=bed_files,
        num_reads=n_reads,
        num_windows=n_windows,
        errors=errors.errors,
        elapsed_s=time.time() - start_time,
        stage_seconds=timer.as_dict(),
    )
