// Native fast5 reader: minimal HDF5 C-API client loaded via dlopen.
//
// This image ships no HDF5 development headers; h5py bundles its own
// libhdf5 (1.14 ABI). We dlopen that library (path supplied by Python)
// and declare only the dozen entry points the fast5 layout needs, so the
// reader has zero build-time dependencies. All numeric dataset/attr
// reads go through HDF5's own type conversion to native doubles/int64s,
// which keeps this robust across the albacore-v1 (float seconds) and
// v2/guppy (uint64 samples) flavors.
//
// C ABI: dmt_f5_init(libpath) once, then per file
//   h = dmt_f5_open(path, basecall_group)  ->  getters  ->  dmt_f5_free(h).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dlfcn.h>
#include <string>
#include <vector>

typedef int64_t hid_t;
typedef int herr_t;
typedef unsigned long long hsize_t_;
typedef int H5_index_t_;
typedef int H5_iter_order_t_;

namespace {

struct H5Api {
  herr_t (*H5open)();
  hid_t (*H5Fopen)(const char*, unsigned, hid_t);
  herr_t (*H5Fclose)(hid_t);
  hid_t (*H5Dopen2)(hid_t, const char*, hid_t);
  herr_t (*H5Dclose)(hid_t);
  hid_t (*H5Dget_type)(hid_t);
  hid_t (*H5Dget_space)(hid_t);
  herr_t (*H5Dread)(hid_t, hid_t, hid_t, hid_t, hid_t, void*);
  hid_t (*H5Sget_simple_extent_npoints)(hid_t);
  herr_t (*H5Sclose)(hid_t);
  hid_t (*H5Aopen_by_name)(hid_t, const char*, const char*, hid_t, hid_t);
  herr_t (*H5Aread)(hid_t, hid_t, void*);
  herr_t (*H5Aclose)(hid_t);
  hid_t (*H5Aget_type)(hid_t);
  int (*H5Tget_class)(hid_t);
  size_t (*H5Tget_size)(hid_t);
  int (*H5Tis_variable_str)(hid_t);
  hid_t (*H5Tcreate)(int, size_t);
  hid_t (*H5Tcopy)(hid_t);
  herr_t (*H5Tset_size)(hid_t, size_t);
  herr_t (*H5Tset_strpad)(hid_t, int);
  herr_t (*H5Tinsert)(hid_t, const char*, size_t, hid_t);
  herr_t (*H5Tclose)(hid_t);
  int (*H5Tget_nmembers)(hid_t);
  char* (*H5Tget_member_name)(hid_t, unsigned);
  herr_t (*H5free_memory)(void*);
  hid_t (*H5Gopen2)(hid_t, const char*, hid_t);
  herr_t (*H5Gclose)(hid_t);
  herr_t (*H5Literate2)(hid_t, int, int, hsize_t_*,
                        herr_t (*)(hid_t, const char*, const void*, void*),
                        void*);
  // global native type handles (valid after H5open)
  hid_t native_double;
  hid_t native_int64;
  hid_t native_float;
  hid_t c_s1;
  bool ready = false;
};

H5Api api;

template <typename T>
bool load_sym(void* lib, const char* name, T* out) {
  *out = reinterpret_cast<T>(dlsym(lib, name));
  return *out != nullptr;
}

herr_t first_link_cb(hid_t, const char* name, const void*, void* op_data) {
  std::string* out = static_cast<std::string*>(op_data);
  *out = name;
  return 1;  // stop after first
}

struct Fast5Data {
  int status = 0;  // 0 ok; negative = error code
  double sampling_rate = 0;
  long long raw_start_time = -1;  // -1 = attr absent (v1 path rejects)
  std::string version;
  std::string fastq;
  std::vector<double> signal;
  // events (empty when move table in use), interleaved per-event records
  // filled by ONE H5Dread compound conversion pass (layout EV_* below)
  std::vector<char> ev_raw;
  size_t n_events = 0;
  size_t state_width = 0;
  // move table
  std::vector<int64_t> move;
  long long first_sample_template = -1;
};

bool read_string_attr(hid_t root, const char* obj, const char* attr,
                      std::string* out) {
  hid_t aid = api.H5Aopen_by_name(root, obj, attr, 0, 0);
  if (aid < 0) return false;
  hid_t tid = api.H5Aget_type(aid);
  bool ok = false;
  if (api.H5Tis_variable_str(tid) > 0) {
    char* ptr = nullptr;
    hid_t mem = api.H5Tcopy(api.c_s1);
    api.H5Tset_size(mem, (size_t)-1);  // H5T_VARIABLE
    if (api.H5Aread(aid, mem, &ptr) >= 0 && ptr) {
      *out = ptr;
      api.H5free_memory(ptr);
      ok = true;
    }
    api.H5Tclose(mem);
  } else {
    size_t n = api.H5Tget_size(tid);
    std::vector<char> buf(n + 1, 0);
    hid_t mem = api.H5Tcopy(api.c_s1);
    api.H5Tset_size(mem, n);
    api.H5Tset_strpad(mem, 1 /*NULLPAD: keep all n chars, see above*/);
    if (api.H5Aread(aid, mem, buf.data()) >= 0) {
      *out = std::string(buf.data(), strnlen(buf.data(), n));
      ok = true;
    }
    api.H5Tclose(mem);
  }
  api.H5Tclose(tid);
  api.H5Aclose(aid);
  return ok;
}

bool read_scalar_attr_double(hid_t root, const char* obj, const char* attr,
                             double* out) {
  hid_t aid = api.H5Aopen_by_name(root, obj, attr, 0, 0);
  if (aid < 0) return false;
  bool ok = api.H5Aread(aid, api.native_double, out) >= 0;
  api.H5Aclose(aid);
  return ok;
}

bool read_scalar_attr_int64(hid_t root, const char* obj, const char* attr,
                            long long* out) {
  hid_t aid = api.H5Aopen_by_name(root, obj, attr, 0, 0);
  if (aid < 0) return false;
  int64_t v = 0;
  bool ok = api.H5Aread(aid, api.native_int64, &v) >= 0;
  *out = v;
  api.H5Aclose(aid);
  return ok;
}

// Interleaved in-memory event record: every numeric field lands as a
// native double (HDF5 converts the v1 float-seconds and v2 uint-sample
// flavors alike), matching the previous per-field read semantics but in
// ONE H5Dread conversion pass instead of six.
constexpr size_t EV_MEAN = 0, EV_STDV = 8, EV_START = 16, EV_LENGTH = 24,
                 EV_MOVE = 32, EV_STATE = 40, EV_STATE_W = 5, EV_STRIDE = 48;

bool read_events_interleaved(hid_t did, size_t n, std::vector<char>* out) {
  hid_t str_t = api.H5Tcopy(api.c_s1);
  api.H5Tset_size(str_t, EV_STATE_W);
  // NULLPAD, not the C_S1 default NULLTERM: a null-terminated destination
  // reserves its last byte for NUL, silently truncating 5-char states to
  // 4 (caught by tests/test_native_fast5.py::
  // test_native_collapse_crafted_moves); numpy's astype('S5') — the h5py
  // path — keeps all 5 bytes.
  api.H5Tset_strpad(str_t, 1 /*H5T_STR_NULLPAD*/);
  hid_t mem = api.H5Tcreate(6 /*H5T_COMPOUND*/, EV_STRIDE);
  bool ok = api.H5Tinsert(mem, "mean", EV_MEAN, api.native_double) >= 0 &&
            api.H5Tinsert(mem, "stdv", EV_STDV, api.native_double) >= 0 &&
            api.H5Tinsert(mem, "start", EV_START, api.native_double) >= 0 &&
            api.H5Tinsert(mem, "length", EV_LENGTH, api.native_double) >= 0 &&
            api.H5Tinsert(mem, "move", EV_MOVE, api.native_int64) >= 0 &&
            // width-5 string member: HDF5 conversion truncates longer
            // file-side states, the pipeline contract (m_event stores U5,
            // myDetect.py:234) and what astype('S5') does on the h5py path
            api.H5Tinsert(mem, "model_state", EV_STATE, str_t) >= 0;
  if (ok) {
    out->assign(n * EV_STRIDE, 0);
    ok = api.H5Dread(did, mem, 0, 0, 0, out->data()) >= 0;
  }
  api.H5Tclose(mem);
  api.H5Tclose(str_t);
  return ok;
}

}  // namespace

extern "C" {

int dmt_f5_init(const char* libhdf5_path) {
  if (api.ready) return 0;
  void* lib = dlopen(libhdf5_path, RTLD_NOW | RTLD_GLOBAL);
  if (!lib) return -1;
  bool ok = true;
  ok &= load_sym(lib, "H5open", &api.H5open);
  ok &= load_sym(lib, "H5Fopen", &api.H5Fopen);
  ok &= load_sym(lib, "H5Fclose", &api.H5Fclose);
  ok &= load_sym(lib, "H5Dopen2", &api.H5Dopen2);
  ok &= load_sym(lib, "H5Dclose", &api.H5Dclose);
  ok &= load_sym(lib, "H5Dget_type", &api.H5Dget_type);
  ok &= load_sym(lib, "H5Dget_space", &api.H5Dget_space);
  ok &= load_sym(lib, "H5Dread", &api.H5Dread);
  ok &= load_sym(lib, "H5Sget_simple_extent_npoints",
                 &api.H5Sget_simple_extent_npoints);
  ok &= load_sym(lib, "H5Sclose", &api.H5Sclose);
  ok &= load_sym(lib, "H5Aopen_by_name", &api.H5Aopen_by_name);
  ok &= load_sym(lib, "H5Aread", &api.H5Aread);
  ok &= load_sym(lib, "H5Aclose", &api.H5Aclose);
  ok &= load_sym(lib, "H5Aget_type", &api.H5Aget_type);
  ok &= load_sym(lib, "H5Tget_class", &api.H5Tget_class);
  ok &= load_sym(lib, "H5Tget_size", &api.H5Tget_size);
  ok &= load_sym(lib, "H5Tis_variable_str", &api.H5Tis_variable_str);
  ok &= load_sym(lib, "H5Tcreate", &api.H5Tcreate);
  ok &= load_sym(lib, "H5Tcopy", &api.H5Tcopy);
  ok &= load_sym(lib, "H5Tset_size", &api.H5Tset_size);
  ok &= load_sym(lib, "H5Tset_strpad", &api.H5Tset_strpad);
  ok &= load_sym(lib, "H5Tinsert", &api.H5Tinsert);
  ok &= load_sym(lib, "H5Tclose", &api.H5Tclose);
  ok &= load_sym(lib, "H5Tget_nmembers", &api.H5Tget_nmembers);
  ok &= load_sym(lib, "H5Tget_member_name", &api.H5Tget_member_name);
  ok &= load_sym(lib, "H5free_memory", &api.H5free_memory);
  ok &= load_sym(lib, "H5Gopen2", &api.H5Gopen2);
  ok &= load_sym(lib, "H5Gclose", &api.H5Gclose);
  ok &= load_sym(lib, "H5Literate2", &api.H5Literate2);
  if (!ok) return -2;
  if (api.H5open() < 0) return -3;
  hid_t* p;
  if (!load_sym(lib, "H5T_NATIVE_DOUBLE_g", &p)) return -4;
  api.native_double = *p;
  if (!load_sym(lib, "H5T_NATIVE_LLONG_g", &p)) return -4;
  api.native_int64 = *p;
  if (!load_sym(lib, "H5T_NATIVE_FLOAT_g", &p)) return -4;
  api.native_float = *p;
  if (!load_sym(lib, "H5T_C_S1_g", &p)) return -4;
  api.c_s1 = *p;
  api.ready = true;
  return 0;
}

void* dmt_f5_open(const char* path, const char* basecall_group,
                  const char* strand_group, int use_move) {
  auto* d = new Fast5Data();
  if (!api.ready) {
    d->status = -100;
    return d;
  }
  hid_t fid = api.H5Fopen(path, 0 /*RDONLY*/, 0);
  if (fid < 0) {
    d->status = -1;
    return d;
  }
  // channel info
  if (!read_scalar_attr_double(fid, "UniqueGlobalKey/channel_id",
                               "sampling_rate", &d->sampling_rate)) {
    d->status = -2;
    api.H5Fclose(fid);
    return d;
  }
  std::string base = std::string("/Analyses/") + basecall_group;
  read_string_attr(fid, base.c_str(), "version", &d->version);

  // fastq
  std::string fq_path = base + "/" + strand_group + "/Fastq";
  hid_t did = api.H5Dopen2(fid, fq_path.c_str(), 0);
  if (did < 0) {
    d->status = -3;
    api.H5Fclose(fid);
    return d;
  }
  hid_t tid = api.H5Dget_type(did);
  if (api.H5Tis_variable_str(tid) > 0) {
    char* ptr = nullptr;
    hid_t mem = api.H5Tcopy(api.c_s1);
    api.H5Tset_size(mem, (size_t)-1);
    if (api.H5Dread(did, mem, 0, 0, 0, &ptr) >= 0 && ptr) {
      d->fastq = ptr;
      api.H5free_memory(ptr);
    }
    api.H5Tclose(mem);
  } else {
    size_t n = api.H5Tget_size(tid);
    std::vector<char> buf(n + 1, 0);
    hid_t mem = api.H5Tcopy(api.c_s1);
    api.H5Tset_size(mem, n);
    api.H5Tset_strpad(mem, 1 /*NULLPAD: keep all n chars, see above*/);
    if (api.H5Dread(did, mem, 0, 0, 0, buf.data()) >= 0)
      d->fastq = std::string(buf.data(), strnlen(buf.data(), n));
    api.H5Tclose(mem);
  }
  api.H5Tclose(tid);
  api.H5Dclose(did);

  // raw signal: first child of /Raw/Reads
  std::string read_name;
  hid_t gid = api.H5Gopen2(fid, "/Raw/Reads", 0);
  if (gid < 0) {
    d->status = -4;
    api.H5Fclose(fid);
    return d;
  }
  hsize_t_ idx = 0;
  api.H5Literate2(gid, 0 /*NAME*/, 0 /*INC*/, &idx, first_link_cb, &read_name);
  api.H5Gclose(gid);
  if (read_name.empty()) {
    d->status = -4;
    api.H5Fclose(fid);
    return d;
  }
  std::string raw_group = std::string("/Raw/Reads/") + read_name;
  read_scalar_attr_int64(fid, raw_group.c_str(), "start_time",
                         &d->raw_start_time);
  std::string sig_path = raw_group + "/Signal";
  did = api.H5Dopen2(fid, sig_path.c_str(), 0);
  if (did < 0) {
    d->status = -5;
    api.H5Fclose(fid);
    return d;
  }
  hid_t sid = api.H5Dget_space(did);
  long long n_sig = api.H5Sget_simple_extent_npoints(sid);
  api.H5Sclose(sid);
  d->signal.resize(n_sig);
  if (api.H5Dread(did, api.native_double, 0, 0, 0, d->signal.data()) < 0)
    d->status = -5;
  api.H5Dclose(did);
  if (d->status != 0) {
    api.H5Fclose(fid);
    return d;
  }

  if (use_move) {
    std::string mv_path = base + "/" + strand_group + "/Move";
    did = api.H5Dopen2(fid, mv_path.c_str(), 0);
    if (did < 0) {
      d->status = -6;
      api.H5Fclose(fid);
      return d;
    }
    sid = api.H5Dget_space(did);
    long long n = api.H5Sget_simple_extent_npoints(sid);
    api.H5Sclose(sid);
    d->move.resize(n);
    if (api.H5Dread(did, api.native_int64, 0, 0, 0, d->move.data()) < 0)
      d->status = -6;
    api.H5Dclose(did);
    // segmentation attrs
    std::string seg = basecall_group;
    size_t us = seg.rfind('_');
    std::string seg_group = std::string("/Analyses/Segmentation_") +
                            (us == std::string::npos ? "000"
                                                     : seg.substr(us + 1)) +
                            "/Summary/segmentation";
    read_scalar_attr_int64(fid, seg_group.c_str(), "first_sample_template",
                           &d->first_sample_template);
  } else {
    std::string ev_path = base + "/" + strand_group + "/Events";
    did = api.H5Dopen2(fid, ev_path.c_str(), 0);
    if (did < 0) {
      d->status = -7;
      api.H5Fclose(fid);
      return d;
    }
    sid = api.H5Dget_space(did);
    long long n = api.H5Sget_simple_extent_npoints(sid);
    api.H5Sclose(sid);
    d->n_events = (size_t)n;
    d->state_width = EV_STATE_W;
    if (!read_events_interleaved(did, (size_t)n, &d->ev_raw))
      d->status = -7;
    api.H5Dclose(did);
  }
  api.H5Fclose(fid);
  return d;
}

int dmt_f5_status(void* h) { return static_cast<Fast5Data*>(h)->status; }
double dmt_f5_sampling_rate(void* h) {
  return static_cast<Fast5Data*>(h)->sampling_rate;
}
long long dmt_f5_start_time(void* h) {
  return static_cast<Fast5Data*>(h)->raw_start_time;
}
const char* dmt_f5_version(void* h) {
  return static_cast<Fast5Data*>(h)->version.c_str();
}
const char* dmt_f5_fastq(void* h) {
  return static_cast<Fast5Data*>(h)->fastq.c_str();
}
long long dmt_f5_signal_len(void* h) {
  return (long long)static_cast<Fast5Data*>(h)->signal.size();
}
void dmt_f5_signal(void* h, double* out) {
  auto* d = static_cast<Fast5Data*>(h);
  memcpy(out, d->signal.data(), d->signal.size() * sizeof(double));
}
long long dmt_f5_n_events(void* h) {
  return (long long)static_cast<Fast5Data*>(h)->n_events;
}
void dmt_f5_events(void* h, double* mean, double* stdv, double* start,
                   double* length, int64_t* move, char* state) {
  auto* d = static_cast<Fast5Data*>(h);
  const size_t n = d->n_events;
  for (size_t i = 0; i < n; ++i) {
    const char* p = d->ev_raw.data() + i * EV_STRIDE;
    memcpy(mean + i, p + EV_MEAN, 8);
    memcpy(stdv + i, p + EV_STDV, 8);
    memcpy(start + i, p + EV_START, 8);
    memcpy(length + i, p + EV_LENGTH, 8);
    memcpy(move + i, p + EV_MOVE, 8);
    memcpy(state + i * EV_STATE_W, p + EV_STATE, EV_STATE_W);
  }
}
// Fill a packed numpy structured array directly (one call, no per-field
// temporaries): dtype [(mean f8)(stdv f8)(start f8|u8)(length f8|u8)
// (model_state S5)(move i8)] -> offsets 0/8/16/24/32/37, itemsize 45.
// start_as_u64 selects the Albacore-v2 integer start/length layout
// (float->uint64 truncation; negatives clamp to 0 instead of UB).
void dmt_f5_events_packed(void* h, char* dst, int start_as_u64) {
  auto* d = static_cast<Fast5Data*>(h);
  const size_t n = d->n_events;
  const size_t stride = 45;
  for (size_t i = 0; i < n; ++i) {
    const char* src = d->ev_raw.data() + i * EV_STRIDE;
    char* p = dst + i * stride;
    memcpy(p, src + EV_MEAN, 8);
    memcpy(p + 8, src + EV_STDV, 8);
    if (start_as_u64) {
      double sv, lv;
      memcpy(&sv, src + EV_START, 8);
      memcpy(&lv, src + EV_LENGTH, 8);
      const uint64_t s = sv > 0 ? (uint64_t)sv : 0;
      const uint64_t l = lv > 0 ? (uint64_t)lv : 0;
      memcpy(p + 16, &s, 8);
      memcpy(p + 24, &l, 8);
    } else {
      memcpy(p + 16, src + EV_START, 8);
      memcpy(p + 24, src + EV_LENGTH, 8);
    }
    memcpy(p + 32, src + EV_STATE, 5);
    memcpy(p + 37, src + EV_MOVE, 8);
  }
}

// Collapsed Albacore-v2 'simple' events, emitted directly in the numpy
// EVENT_DTYPE layout (io/events.py:29-37: mean f4@0, stdv f4@4,
// start u8@8, length u8@16, model_state U5@24 — five uint32 codepoints —
// itemsize 44). Semantics replicate collapse_events_v2 exactly: group
// leaders are event 0 plus every later move>0 event, each group's length
// is the uint64 sum over its stay run (np.add.reduceat), mean/stdv are
// np.round(x, 3) = rint(x*1000)/1000 cast to f4, start is the leader's
// float->uint64 truncation (negatives clamp to 0, as dmt_f5_events_packed
// + astype(uint64) produced before).
long long dmt_f5_n_collapsed_v2(void* h) {
  auto* d = static_cast<Fast5Data*>(h);
  const size_t n = d->n_events;
  if (n == 0) return 0;
  long long count = 1;
  for (size_t i = 1; i < n; ++i) {
    int64_t mv;
    memcpy(&mv, d->ev_raw.data() + i * EV_STRIDE + EV_MOVE, 8);
    if (mv > 0) ++count;
  }
  return count;
}

void dmt_f5_events_collapsed_v2(void* h, char* dst) {
  auto* d = static_cast<Fast5Data*>(h);
  const size_t n = d->n_events;
  if (n == 0) return;
  constexpr size_t OUT_STRIDE = 44;
  char* out = dst;
  uint64_t acc_len = 0;
  for (size_t i = 0; i < n; ++i) {
    const char* src = d->ev_raw.data() + i * EV_STRIDE;
    int64_t mv;
    memcpy(&mv, src + EV_MOVE, 8);
    double len_d;
    memcpy(&len_d, src + EV_LENGTH, 8);
    const uint64_t len_u = len_d > 0 ? (uint64_t)len_d : 0;
    if (i == 0 || mv > 0) {
      if (i > 0) {
        memcpy(out + 16, &acc_len, 8);
        out += OUT_STRIDE;
      }
      double mean_d, stdv_d, start_d;
      memcpy(&mean_d, src + EV_MEAN, 8);
      memcpy(&stdv_d, src + EV_STDV, 8);
      memcpy(&start_d, src + EV_START, 8);
      const float m3 = (float)(rint(mean_d * 1000.0) / 1000.0);
      const float s3 = (float)(rint(stdv_d * 1000.0) / 1000.0);
      const uint64_t st = start_d > 0 ? (uint64_t)start_d : 0;
      memcpy(out + 0, &m3, 4);
      memcpy(out + 4, &s3, 4);
      memcpy(out + 8, &st, 8);
      uint32_t cp[5];
      for (int k = 0; k < 5; ++k)
        cp[k] = (uint32_t)(unsigned char)src[EV_STATE + k];
      memcpy(out + 24, cp, 20);
      acc_len = len_u;
    } else {
      acc_len += len_u;
    }
  }
  memcpy(out + 16, &acc_len, 8);
}

// round(np.float64 scalar, 3): the reference rounds np.float64
// structured-array elements (myDetect.py:199-231), and under py3/modern
// numpy the scalar __round__ is numpy's rint(x*1000)/1000 — NOT
// CPython's correctly-rounded decimal round (they differ at doubles
// adjacent to .0005 midpoints, e.g. 2.6755 -> 2.676 vs 2.675). Pinned
// against the EXECUTED reference by a crafted near-midpoint fixture in
// tests/test_reference_differential.py; the half-even tie rule of
// nearbyint under the default FE_TONEAREST mode matches np.rint.
static double np_round3(double x) {
  if (!std::isfinite(x)) return x;
  return std::nearbyint(x * 1000.0) / 1000.0;
}

// Collapsed Albacore-v1 events (seconds -> sample indices, stay collapse,
// gap patching), emitted in the numpy EVENT_DTYPE layout like the v2
// variant above. Replicates io/events.py::collapse_events_v1 — itself the
// reference's getEvent v1 branch (myDetect.py:166-238) — including the
// per-event float->uint64 length truncation, the uint64 gap arithmetic,
// python-round means/stdvs and uppercased states. Returns the collapsed
// event count, or a negative error code: -1 "Remove too many bases on
// left", -2 "Remove too many bases on right", -3 "first index < -2".
// `dst` must hold 2*n_events + 2 records (gap fillers can double a run's
// output); skips are returned through skip_left/skip_right.
long long dmt_f5_events_collapsed_v1(void* h, double sampling_rate,
                                     long long raw_start_time, char* dst,
                                     long long* skip_left,
                                     long long* skip_right) {
  auto* d = static_cast<Fast5Data*>(h);
  const long long n = (long long)d->n_events;
  const char* raw = d->ev_raw.data();
  auto f64_at = [&](long long i, size_t off) {
    double v;
    memcpy(&v, raw + i * EV_STRIDE + off, 8);
    return v;
  };
  auto mv_at = [&](long long i) {
    int64_t v;
    memcpy(&v, raw + i * EV_STRIDE + EV_MOVE, 8);
    return v;
  };
  long long m0l = -1, m0r = -1;
  for (long long i = 0; i < n; ++i)
    if (mv_at(i) != 0) { m0l = i; break; }
  if (m0l < 0) return -1;
  for (long long i = n - 1; i >= 0; --i)
    if (mv_at(i) != 0) { m0r = i; break; }
  if (m0l > (n - 1) - 20) return -1;
  if (m0r < m0l + 20) return -2;

  const double start_m0l_sec = f64_at(m0l, EV_START);
  const double based_ind = start_m0l_sec * sampling_rate -
                           (double)raw_start_time;
  long long first_idx_i = (long long)std::nearbyint(
      start_m0l_sec * sampling_rate) - raw_start_time;
  if (first_idx_i < -2) return -3;
  if (first_idx_i < 0) first_idx_i = 0;
  const uint64_t first_idx = (uint64_t)first_idx_i;

  // float->uint64 like numpy's astype (negatives wrap through int64)
  auto len_samples = [&](long long i) {
    const double v = f64_at(i, EV_LENGTH) * sampling_rate;
    return (uint64_t)(int64_t)v;
  };

  constexpr size_t OUT_STRIDE = 44;
  char* out = dst;
  long long count = 0;
  uint64_t prev_end = 0;  // start+length of the last emitted record
  auto put = [&](long long src_i, uint64_t start, uint64_t length) {
    const float m3 = (float)np_round3(f64_at(src_i, EV_MEAN));
    const float s3 = (float)np_round3(f64_at(src_i, EV_STDV));
    char* p = out + count * OUT_STRIDE;
    memcpy(p + 0, &m3, 4);
    memcpy(p + 4, &s3, 4);
    memcpy(p + 8, &start, 8);
    memcpy(p + 16, &length, 8);
    uint32_t cp[5];
    const char* st = raw + src_i * EV_STRIDE + EV_STATE;
    for (int k = 0; k < 5; ++k) {
      unsigned char c = (unsigned char)st[k];
      if (c >= 'a' && c <= 'z') c = (unsigned char)(c - 'a' + 'A');
      cp[k] = (uint32_t)c;
    }
    memcpy(p + 24, cp, 20);
    ++count;
    prev_end = start + length;
  };

  long long pre_i = m0l;
  uint64_t cur_length = len_samples(m0l);
  auto emit = [&]() {
    if (pre_i == m0l) {
      put(pre_i, first_idx, cur_length);
      return;
    }
    const double cal_st = (f64_at(pre_i, EV_START) - start_m0l_sec) *
                              sampling_rate + based_ind;
    const double gap_f = cal_st - (double)prev_end;
    if (cal_st > 0 && gap_f > 0 && (uint64_t)gap_f > 0) {
      const uint64_t gap = (uint64_t)gap_f;
      if (gap > 2) {
        const uint64_t pe = prev_end;
        put(pre_i, pe, gap);                     // gap-filler pseudo-event
        put(pre_i, (uint64_t)cal_st, cur_length);  // the real one
      } else {
        put(pre_i, prev_end, gap + cur_length);
      }
    } else {
      put(pre_i, prev_end, cur_length);
    }
  };

  for (long long i = m0l + 1; i <= m0r; ++i) {
    if (mv_at(i) > 0) {
      emit();
      pre_i = i;
      cur_length = len_samples(i);
    } else {
      cur_length += len_samples(i);
    }
  }
  emit();  // final pending event

  *skip_left = m0l;
  *skip_right = n - m0r - 1;
  return count;
}

long long dmt_f5_move_len(void* h) {
  return (long long)static_cast<Fast5Data*>(h)->move.size();
}
void dmt_f5_move(void* h, int64_t* out) {
  auto* d = static_cast<Fast5Data*>(h);
  memcpy(out, d->move.data(), d->move.size() * sizeof(int64_t));
}
long long dmt_f5_first_sample(void* h) {
  return static_cast<Fast5Data*>(h)->first_sample_template;
}
void dmt_f5_free(void* h) { delete static_cast<Fast5Data*>(h); }

}  // extern "C"
