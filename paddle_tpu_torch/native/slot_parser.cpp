// MultiSlot dataset file parser.
//
// Native C++ equivalent of the reference's MultiSlotDataFeed parsing hot
// path (paddle/fluid/framework/data_feed.cc:532 MultiSlotDataFeed — text
// records of the form, per line, for each slot in order:
//     <num_values> v1 v2 ... vnum
// with slots typed float or uint64).  The Python layer (paddle_tpu/
// dataset.py) keeps a pure-Python fallback; this library is the fast path,
// built with g++ -O3 at first import (see native/__init__.py).
//
// C ABI (ctypes):
//   pt_parse_file(path, n_slots, types, &n_instances) -> handle
//     types: one char per slot, 'f' (float) or 'u' (uint64 ids)
//   pt_slot_size(handle, slot)          -> total value count in slot
//   pt_slot_fill(handle, slot, values_out, offsets_out)
//     values_out: float* or int64*; offsets_out: int64[n_instances+1]
//   pt_free(handle)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct SlotData {
  char type;  // 'f' or 'u'
  std::vector<float> fvals;
  std::vector<int64_t> uvals;
  std::vector<int64_t> offsets;  // CSR offsets, len = n_instances + 1
};

struct ParseResult {
  std::vector<SlotData> slots;
  int64_t n_instances = 0;
};

// Skip spaces/tabs (not newlines).
inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  return p;
}

// Checked parsers: fail (return false) on a missing/garbage token instead
// of silently yielding 0 or consuming tokens past `end` (the line end) —
// a malformed line must invalidate exactly that instance, never desync
// the stream (parity: MultiSlotDataFeed's CheckFile, data_feed.cc).
inline bool parse_i64(const char** pp, const char* end, int64_t* out) {
  const char* p = skip_ws(*pp, end);
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) {
    neg = (*p == '-');
    ++p;
  }
  const char* digits = p;
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    ++p;
  }
  if (p == digits) return false;
  *out = neg ? -v : v;
  *pp = p;
  return true;
}

inline bool parse_f32(const char** pp, const char* end, float* out) {
  const char* p = skip_ws(*pp, end);
  if (p >= end) return false;  // strtof would walk past the newline
  char* q = nullptr;
  *out = strtof(p, &q);
  if (!q || q == p || q > end) return false;
  *pp = q;
  return true;
}

}  // namespace

extern "C" {

void* pt_parse_file(const char* path, int n_slots, const char* types,
                    int64_t* n_instances_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(size);
  if (size > 0 && fread(&buf[0], 1, size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  auto* res = new ParseResult();
  res->slots.resize(n_slots);
  for (int i = 0; i < n_slots; ++i) {
    res->slots[i].type = types[i];
    res->slots[i].offsets.push_back(0);
  }

  const char* p = buf.data();
  const char* end = p + buf.size();
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    const char* q = skip_ws(p, line_end);
    if (q < line_end) {  // non-empty line = one instance
      // snapshot per-slot sizes so a malformed line can be rolled back
      // without leaving ghost values / desynced offsets behind
      std::vector<size_t> fsz(n_slots), usz(n_slots), osz(n_slots);
      for (int s = 0; s < n_slots; ++s) {
        fsz[s] = res->slots[s].fvals.size();
        usz[s] = res->slots[s].uvals.size();
        osz[s] = res->slots[s].offsets.size();
      }
      bool ok = true;
      for (int s = 0; s < n_slots && ok; ++s) {
        int64_t num = 0;
        if (!parse_i64(&q, line_end, &num) || num < 0) { ok = false; break; }
        SlotData& slot = res->slots[s];
        for (int64_t k = 0; k < num && ok; ++k) {
          if (slot.type == 'f') {
            float v;
            if (!parse_f32(&q, line_end, &v)) { ok = false; break; }
            slot.fvals.push_back(v);
          } else {
            int64_t v;
            if (!parse_i64(&q, line_end, &v)) { ok = false; break; }
            slot.uvals.push_back(v);
          }
        }
        if (ok) {
          slot.offsets.push_back(
              slot.type == 'f' ? (int64_t)slot.fvals.size()
                               : (int64_t)slot.uvals.size());
        }
      }
      if (ok) {
        ++res->n_instances;
      } else {
        for (int s = 0; s < n_slots; ++s) {
          res->slots[s].fvals.resize(fsz[s]);
          res->slots[s].uvals.resize(usz[s]);
          res->slots[s].offsets.resize(osz[s]);
        }
      }
    }
    p = line_end + 1;
  }
  *n_instances_out = res->n_instances;
  return res;
}

int64_t pt_slot_size(void* handle, int slot) {
  auto* res = static_cast<ParseResult*>(handle);
  const SlotData& s = res->slots[slot];
  return s.type == 'f' ? (int64_t)s.fvals.size() : (int64_t)s.uvals.size();
}

void pt_slot_fill(void* handle, int slot, void* values_out,
                  int64_t* offsets_out) {
  auto* res = static_cast<ParseResult*>(handle);
  const SlotData& s = res->slots[slot];
  if (s.type == 'f') {
    memcpy(values_out, s.fvals.data(), s.fvals.size() * sizeof(float));
  } else {
    memcpy(values_out, s.uvals.data(), s.uvals.size() * sizeof(int64_t));
  }
  memcpy(offsets_out, s.offsets.data(),
         s.offsets.size() * sizeof(int64_t));
}

void pt_free(void* handle) { delete static_cast<ParseResult*>(handle); }

}  // extern "C"
