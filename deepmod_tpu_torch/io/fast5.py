"""Fast5 ingestion: channel info, basecalls, raw signal, events.

Replicates the reference read path (myDetect.py:33-386):
  channel attrs -> basecaller version -> Fastq (read id + sequence) ->
  raw signal -> event table (v1 / v2-simple / rundif / move) ->
  median-MAD normalization -> per-event mean/std.

Errors use the reference's error-class strings so the operational census
(ErrorCensus) is comparable run-to-run with the reference's output
(myDetect.py:1222-1226).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepmod_tpu_torch.utils import ErrorCensus
from .events import (
    EventError,
    collapse_events_v1,
    collapse_events_v2,
    move_table_events,
    resegment_events,
)
from .signal_norm import SignalRangeError, normalize_and_event_stats

# HDF5 path fragments (myCom.py:51-56, myDetect.py:31-37)
CHANNEL_PATH = "UniqueGlobalKey/channel_id"
ANALYSES = "Analyses"
RAW_READS = "/Raw/Reads"


@dataclasses.dataclass
class Fast5ReadOptions:
    """Subset of moptions consumed by ingestion (bin/DeepMod.py:305-319)."""

    basecall_1d: str = "Basecall_1D_000"
    basecall_2strand: str = "BaseCalled_template"
    signal_group: str = "simple"  # 'simple' or 'rundif'
    move: bool = False
    # basecall source for .pod5 inputs (pod5 carries raw signal only):
    # a dorado-style BAM/SAM whose records hold seq + mv:B:c + ts:i
    # (align.alignfile.read_basecalls); ignored for fast5 inputs
    basecalls: Optional[str] = None


@dataclasses.dataclass
class Fast5Read:
    """One ingested read (the f5data tuple of myDetect.py:373)."""

    read_id: str
    basecall: str
    m_event: np.ndarray           # EVENT_DTYPE
    raw_signals: np.ndarray       # normalized
    path: str
    left_right_skip: Tuple[int, int]
    albacore_version: str = "0.0"


def _version_class(version_str: str) -> int:
    """1 for albacore <2.0, 2 for >=2.0 (myDetect.py:61-78)."""
    try:
        major = int(str(version_str).split(".")[0])
    except (ValueError, IndexError):
        return 1
    return 2 if major >= 2 else 1


def _decode(value) -> str:
    if isinstance(value, bytes):
        return value.decode("utf-8")
    return str(value)


def _basecall_from_states(states: np.ndarray) -> str:
    """Center base of each 5-mer model_state (myDetect.py:237)."""
    # vectorized: fixed-width bytes view -> take the center column
    if states.dtype == np.dtype("S5") and states.flags.c_contiguous:
        as_bytes = states.view(np.uint8).reshape(len(states), 5)
    else:
        as_bytes = states.astype("S5").view(np.uint8).reshape(len(states), 5)
    return as_bytes[:, 2].tobytes().decode("ascii")


def _basecall_from_events(m_event: np.ndarray) -> str:
    """Center base of each event's model_state, straight off the struct.

    A field view of a structured array is strided, so going through
    ``_basecall_from_states(m_event['model_state'])`` pays a full 5-byte
    copy per event; gathering the single center byte from a uint8 view of
    the (contiguous) event array itself is ~5x cheaper.
    """
    n = len(m_event)
    if n == 0:
        return ""
    field_dtype, off = m_event.dtype.fields["model_state"][:2]
    if not m_event.flags.c_contiguous:
        return _basecall_from_states(m_event["model_state"])
    if field_dtype == np.dtype("S5"):
        byte_off = off + 2           # 3rd ascii byte
    elif field_dtype == np.dtype("<U5"):
        byte_off = off + 2 * 4       # low byte of the 3rd UCS4 codepoint
    else:
        return _basecall_from_states(m_event["model_state"])
    u8 = m_event.view(np.uint8).reshape(n, m_event.dtype.itemsize)
    return u8[:, byte_off].tobytes().decode("ascii")


def _ingest_read(
    node, options: Fast5ReadOptions, path: str, *,
    channel_path: str, raw_getter, analyses_prefix: str,
) -> Fast5Read:
    """Shared ingestion for both fast5 layouts.

    ``node`` is the h5py File (single-read) or read_<uuid> group
    (multi-read); the three keyword params encode the only layout
    differences — channel-attrs location, raw-signal group, and the
    Analyses path prefix. Everything else (version probe, fastq/read-id
    parsing, the four event paths, normalize + mean/std + basecall
    truncation) is one code path so fixes cannot silently diverge.
    """
    # channel info (myDetect.py:45-51)
    try:
        channel = dict(node[channel_path].attrs)
        sampling_rate = float(channel["sampling_rate"])
    except Exception as exc:
        raise EventError("Channel information could not be found") from exc

    base_path = f"{analyses_prefix}{options.basecall_1d}"
    try:
        version = _decode(node[base_path].attrs.get("version", "0.0"))
    except Exception:
        version = "0.0"
    version_class = _version_class(version)

    # fastq (myDetect.py:313-322)
    fq_path = f"{base_path}/{options.basecall_2strand}/Fastq"
    try:
        fq_data = _decode(node[fq_path][()]).split("\n")
    except Exception as exc:
        raise EventError("No Fastq data") from exc
    header = fq_data[0]
    read_id = (header[1:] if header.startswith("@") else header)
    read_id = read_id.replace(" ", ":::").replace("\t", "|||")
    fq_seq = fq_data[1]

    # raw signal + attrs (myDetect.py:287-297)
    try:
        raw_group = raw_getter(node)
        raw_attributes = dict(raw_group.attrs)
        try:
            raw_signals = np.asarray(raw_group["Signal"][()])
        except OSError:
            # vbz-compressed signal and no vendor plugin installed: read
            # the chunks directly and decode with the built-in codec
            from .vbz import dataset_has_vbz, dataset_vbz_options, read_vbz_dataset

            dset = raw_group["Signal"]
            if not dataset_has_vbz(dset):
                raise
            opts = dataset_vbz_options(dset)
            raw_signals = read_vbz_dataset(
                dset, use_delta_zigzag=opts["use_zig_zag"]
            )
    except EventError:
        raise
    except Exception as exc:
        raise EventError("No Raw_reads/Signal") from exc

    # events -> m_event (myDetect.py:133-261)
    if options.move:
        mv_path = f"{base_path}/{options.basecall_2strand}/Move"
        try:
            move_data = np.asarray(node[mv_path][()])
        except Exception as exc:
            raise EventError("No move data") from exc
        seg = "Segmentation_" + options.basecall_1d.split("_")[-1]
        seg_attrs = node[f"{analyses_prefix}{seg}/Summary/segmentation"].attrs
        m_event, skip = move_table_events(
            move_data,
            raw_signals,
            fq_seq,
            int(seg_attrs["first_sample_template"]),
        )
        basecall = fq_seq
    else:
        ev_path = f"{base_path}/{options.basecall_2strand}/Events"
        try:
            events_data = np.asarray(node[ev_path][()])
        except Exception as exc:
            raise EventError("No events data") from exc
        if version_class == 1:
            if "start_time" not in raw_attributes:
                # reference reads it unconditionally in the v1 path
                # (myDetect.py:182-183) and a missing attr lands in
                # the generic open-error class via KeyError
                raise EventError("Cannot open fast5 or other errors")
            start_time = int(raw_attributes["start_time"])
            m_event, skip = collapse_events_v1(
                events_data, sampling_rate, start_time
            )
        elif options.signal_group == "simple":
            m_event, skip = collapse_events_v2(events_data)
        else:
            m_event, skip = resegment_events(events_data, raw_signals, fq_seq)
        basecall = _basecall_from_events(m_event)

    span_start = int(m_event["start"][0])
    span_end = int(m_event["start"][-1] + m_event["length"][-1])
    raw_signals, m_event, n_valid = normalize_and_event_stats(
        m_event, raw_signals, span_start, span_end, in_place=True
    )
    if n_valid < len(basecall):
        basecall = basecall[:n_valid]

    return Fast5Read(
        read_id=read_id,
        basecall=basecall,
        m_event=m_event,
        raw_signals=raw_signals,
        path=path,
        left_right_skip=skip,
        albacore_version=version,
    )


_BASECALL_CACHE: Dict[str, Dict] = {}


def _basecall_cache(path: str, loader) -> Dict:
    """Per-process cache of parsed basecall BAMs (one scan per worker,
    like the aligner index)."""
    if path not in _BASECALL_CACHE:
        _BASECALL_CACHE[path] = loader(path)
    return _BASECALL_CACHE[path]


def read_fast5_file(
    path: str, options: Fast5ReadOptions | None = None
) -> Fast5Read:
    """Ingest one fast5; raises EventError/SignalRangeError/KeyError with
    reference-style error-class messages on malformed files."""
    import h5py

    options = options or Fast5ReadOptions()
    with h5py.File(path, "r") as f5:
        return _ingest_read(
            f5, options, path,
            channel_path=CHANNEL_PATH,
            raw_getter=lambda n: next(iter(n[RAW_READS].values())),
            analyses_prefix=f"/{ANALYSES}/",
        )


def is_multi_read_fast5(path: str) -> bool:
    """Modern ONT multi-read fast5: top-level read_<id> groups."""
    import h5py

    try:
        with h5py.File(path, "r") as f5:
            for key in f5.keys():
                return key.startswith("read_")
    except Exception:
        return False
    return False


def read_multi_fast5_file(
    path: str,
    options: Fast5ReadOptions | None = None,
    errors: Optional[ErrorCensus] = None,
) -> Dict[str, Fast5Read]:
    """Ingest every read of a multi-read fast5 (beyond the reference,
    which supports only single-read files — README.md:24 excludes Guppy
    outputs; the per-read layout here is the ONT standard: channel_id,
    Raw and Analyses nested under each read_<uuid> group)."""
    import h5py

    options = options or Fast5ReadOptions()
    errors = errors if errors is not None else ErrorCensus()
    out: Dict[str, Fast5Read] = {}
    with h5py.File(path, "r") as f5:
        for key in f5.keys():
            if not key.startswith("read_"):
                continue
            group = f5[key]
            try:
                read = _ingest_read_group(group, options, path)
            except (EventError, SignalRangeError) as exc:
                errors.add(str(exc), f"{path}:{key}")
                continue
            except Exception:
                errors.add("Cannot open fast5 or other errors", f"{path}:{key}")
                continue
            out[read.read_id] = read
    return out


def _ingest_read_group(group, options: Fast5ReadOptions, path: str) -> Fast5Read:
    """Per-read extraction for the multi-read layout (shared core)."""
    return _ingest_read(
        group, options, path,
        channel_path="channel_id",
        raw_getter=lambda n: n["Raw"],
        analyses_prefix="Analyses/",
    )


def _peek_version(path: str, options: "Fast5ReadOptions") -> Optional[str]:
    """Basecaller version attr of a read that failed ingestion, if
    readable (for the version census)."""
    import h5py

    try:
        with h5py.File(path, "r") as f5:
            base_path = f"/Analyses/{options.basecall_1d}"
            return _decode(f5[base_path].attrs.get("version", "0.0"))
    except Exception:
        return None


def read_pod5_batch(
    path: str,
    options: Fast5ReadOptions,
    errors: ErrorCensus,
    basecalls: Dict[str, "object"],
) -> Dict[str, Fast5Read]:
    """Ingest one .pod5 (beyond the reference, which scopes pod5 out —
    README.md:24): raw signal + calibration from the container
    (io.pod5), per-read sequence/move-table/trim from a dorado-style
    basecall BAM (``basecalls`` from align.alignfile.read_basecalls).
    Downstream is the SAME move-table path fast5 Move datasets take
    (events.move_table_events with the mv-tag stride, then
    normalize_and_event_stats), so predictions are identical for
    identical signal + moves."""
    import uuid as uuid_mod

    from deepmod_tpu_torch.io.pod5 import read_pod5

    out: Dict[str, Fast5Read] = {}
    try:
        pod_reads = read_pod5(path)
    except Exception:
        errors.add("Cannot open fast5 or other errors", path)
        return out
    for pr in pod_reads:
        read_id = str(uuid_mod.UUID(bytes=pr.read_id))
        bc = basecalls.get(read_id)
        if bc is None:
            errors.add("No move data", f"{path}:{read_id}")
            continue
        try:
            # pod5 signal is raw ADC int16, same integers a fast5
            # Raw/Signal dataset holds — the normalizer consumes them
            # identically
            raw_signals = np.asarray(pr.signal)
            m_event, skip = move_table_events(
                bc.moves, raw_signals, bc.seq, bc.trim, stride=bc.stride
            )
            span_start = int(m_event["start"][0])
            span_end = int(m_event["start"][-1] + m_event["length"][-1])
            raw_signals, m_event, n_valid = normalize_and_event_stats(
                m_event, raw_signals, span_start, span_end, in_place=True
            )
            basecall = bc.seq[:n_valid] if n_valid < len(bc.seq) else bc.seq
        except (EventError, SignalRangeError) as exc:
            errors.add(str(exc), f"{path}:{read_id}")
            continue
        except Exception:
            errors.add("Cannot open fast5 or other errors",
                       f"{path}:{read_id}")
            continue
        out[read_id] = Fast5Read(
            read_id=read_id,
            basecall=basecall,
            m_event=m_event,
            raw_signals=raw_signals,
            path=path,
            left_right_skip=skip,
            albacore_version="pod5",
        )
    return out


def read_fast5_batch(
    paths: List[str],
    options: Fast5ReadOptions | None = None,
    errors: Optional[ErrorCensus] = None,
    version_census: Optional[Dict[str, int]] = None,
) -> Dict[str, Fast5Read]:
    """Ingest a batch; failures are recorded, never fatal
    (get_Event_Signals, myDetect.py:348-386). ``version_census``
    accumulates basecaller-version counts like the reference's version_Q
    (myGetFeatureBasedPos.py:580-582). ``.pod5`` containers are
    auto-detected and ingested through read_pod5_batch when
    ``options.basecalls`` names a basecall BAM/SAM."""
    errors = errors if errors is not None else ErrorCensus()
    out: Dict[str, Fast5Read] = {}
    pod5_paths = [p for p in paths if p.endswith(".pod5")]
    if pod5_paths:
        opts0 = options or Fast5ReadOptions()
        if opts0.basecalls:
            from deepmod_tpu_torch.align.alignfile import read_basecalls

            try:
                bc_map = _basecall_cache(opts0.basecalls, read_basecalls)
            except Exception:
                # a missing/corrupt basecall file fails every pod5 of
                # the batch, censused per file like any other bad input
                for path in pod5_paths:
                    errors.add("Cannot open fast5 or other errors", path)
                bc_map = None
                pod5_paths = []
            for path in pod5_paths:
                for read_id, read in read_pod5_batch(
                    path, opts0, errors, bc_map
                ).items():
                    if read_id in out:
                        errors.add("Duplicate id", path)
                    out[read_id] = read
                    if version_census is not None:
                        version_census["pod5"] = (
                            version_census.get("pod5", 0) + 1
                        )
        else:
            for path in pod5_paths:
                errors.add("No move data", path)  # pod5 without basecalls
        paths = [p for p in paths if not p.endswith(".pod5")]
    # Native C reader is on by default (+~45% ingest throughput); set
    # DMT_NATIVE_FAST5=0 to force the h5py path. Every native failure —
    # including EventError — retries through h5py, so the native path can
    # only add reads, never lose one.
    use_native = False
    if os.environ.get("DMT_NATIVE_FAST5", "1") != "0":
        from deepmod_tpu_torch.native.fast5_native import native_fast5_available

        use_native = native_fast5_available()
    for path in paths:
        read = None
        if use_native:
            # native-first: a successful native read skips the per-file
            # h5py multi-read probe entirely (one h5py open per file saved;
            # multi-read containers fail native open and fall through)
            from deepmod_tpu_torch.native.fast5_native import read_fast5_native

            try:
                read = read_fast5_native(path, options)
            except Exception:
                read = None
        if read is None and is_multi_read_fast5(path):
            for read_id, read in read_multi_fast5_file(
                path, options, errors
            ).items():
                if read_id in out:
                    errors.add("Duplicate id", path)
                out[read_id] = read
                if version_census is not None:
                    version_census[read.albacore_version] = (
                        version_census.get(read.albacore_version, 0) + 1
                    )
            continue
        if read is None:
            try:
                read = read_fast5_file(path, options)
            except (EventError, SignalRangeError) as exc:
                errors.add(str(exc), path)
                # the reference censuses the version of every file whose
                # attrs were readable, including reads that later fail
                # (myDetect.py:363-365)
                if version_census is not None:
                    v = _peek_version(path, options)
                    if v is not None:
                        version_census[v] = version_census.get(v, 0) + 1
                continue
            except Exception:
                errors.add("Cannot open fast5 or other errors", path)
                continue
        if version_census is not None:
            version_census[read.albacore_version] = (
                version_census.get(read.albacore_version, 0) + 1
            )
        if read.read_id in out:
            # duplicate ids overwrite, like f5data[read_id] = ... after the
            # reference's warning print (myDetect.py:367-368)
            errors.add("Duplicate id", path)
        out[read.read_id] = read
    return out
