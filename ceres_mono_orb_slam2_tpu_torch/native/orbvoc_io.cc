// Native ORB vocabulary text I/O.
//
// TPU-native runtime component mirroring the reference's native vocabulary
// loader (lib/DBoW2/DBoW2/TemplatedVocabulary.h:1338-1423 loadFromTextFile):
// the ~1.1M-line ORBvoc.txt parse is pure host-side work that gates system
// startup, so like the reference we keep it in C++ — the Python line loop
// takes ~40 s for the full file, this parser streams it in ~1 s.
//
// Format (header "k L scoring weighting", then one line per non-root node):
//   parent_id is_leaf d0..d31 weight
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// Read entire file into a malloc'd buffer (plus one NUL terminator).
char* read_all(const char* path, long* out_len) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  char* buf = static_cast<char*>(std::malloc(len + 1));
  if (!buf) {
    std::fclose(f);
    return nullptr;
  }
  long got = static_cast<long>(std::fread(buf, 1, len, f));
  std::fclose(f);
  if (got != len) {
    std::free(buf);
    return nullptr;
  }
  buf[len] = '\0';
  *out_len = len;
  return buf;
}

inline void skip_ws(const char*& p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
}

// Fast unsigned-int parse; returns false if no digits at p.
inline bool parse_uint(const char*& p, long* out) {
  skip_ws(p);
  if (*p < '0' || *p > '9') return false;
  long v = 0;
  while (*p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  *out = v;
  return true;
}

}  // namespace

extern "C" {

// Count data lines (nodes) in an ORBvoc text file. Returns -1 on I/O error.
long orbvoc_count(const char* path) {
  long len = 0;
  char* buf = read_all(path, &len);
  if (!buf) return -1;
  long lines = 0;
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    const char* nl = static_cast<const char*>(std::memchr(p, '\n', end - p));
    if (!nl) {
      if (end - p > 2) ++lines;  // trailing unterminated line
      break;
    }
    if (nl - p > 2) ++lines;  // skip blank-ish lines
    p = nl + 1;
  }
  std::free(buf);
  return lines - 1;  // minus the header line
}

// Parse the file into caller-allocated arrays sized for max_nodes nodes:
//   parents (n) int32, leafs (n) uint8, descs (n,32) uint8, weights (n) float
// Returns the number of nodes parsed, or -1 on error. k/levels get the
// header values.
long orbvoc_parse(const char* path, int32_t* parents, uint8_t* leafs,
                  uint8_t* descs, float* weights, long max_nodes, int* k,
                  int* levels) {
  long len = 0;
  char* buf = read_all(path, &len);
  if (!buf) return -1;
  const char* p = buf;

  long hk = 0, hl = 0;
  if (!parse_uint(p, &hk) || !parse_uint(p, &hl)) {
    std::free(buf);
    return -1;
  }
  *k = static_cast<int>(hk);
  *levels = static_cast<int>(hl);
  // skip rest of header line (scoring + weighting ids)
  const char* nl = std::strchr(p, '\n');
  if (!nl) {
    std::free(buf);
    return 0;
  }
  p = nl + 1;

  long n = 0;
  while (*p && n < max_nodes) {
    long parent, leaf;
    if (!parse_uint(p, &parent) || !parse_uint(p, &leaf)) {
      // blank or malformed line: skip to next newline
      const char* q = std::strchr(p, '\n');
      if (!q) break;
      p = q + 1;
      continue;
    }
    parents[n] = static_cast<int32_t>(parent);
    leafs[n] = static_cast<uint8_t>(leaf != 0);
    uint8_t* d = descs + n * 32;
    bool ok = true;
    for (int i = 0; i < 32; ++i) {
      long v;
      if (!parse_uint(p, &v)) {
        ok = false;
        break;
      }
      d[i] = static_cast<uint8_t>(v);
    }
    if (!ok) {
      const char* q = std::strchr(p, '\n');
      if (!q) break;
      p = q + 1;
      continue;
    }
    skip_ws(p);
    char* endp = nullptr;
    weights[n] = std::strtof(p, &endp);
    p = endp ? endp : p;
    ++n;
    const char* q = std::strchr(p, '\n');
    if (!q) break;
    p = q + 1;
  }
  std::free(buf);
  return n;
}

// Serialize a vocabulary to the same text format. children is (n_nodes, k)
// int32 with -1 padding; word_id (n_nodes) int32 (-1 for non-leaves);
// word_weight indexed by word id. Pre-order node numbering, matching
// dump_orbvoc_text in ops/bow.py. Returns 0 on success.
int orbvoc_dump(const char* path, int k, int levels, const uint8_t* descs,
                const int32_t* children, int kmax, const int32_t* word_id,
                const float* word_weight, long n_nodes) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::setvbuf(f, nullptr, _IOFBF, 1 << 22);
  std::fprintf(f, "%d %d 0 3\n", k, levels);

  // iterative pre-order over (parent,node) edges, remapping ids to emission
  // order (root=0)
  int32_t* remap = static_cast<int32_t*>(std::malloc(n_nodes * sizeof(int32_t)));
  long* stack = static_cast<long*>(std::malloc(n_nodes * sizeof(long)));
  long* kids = static_cast<long*>(std::malloc((kmax > 0 ? kmax : 1) * sizeof(long)));
  if (!remap || !stack || !kids) {
    std::free(remap);
    std::free(stack);
    std::free(kids);
    std::fclose(f);
    return -1;
  }
  for (long i = 0; i < n_nodes; ++i) remap[i] = -1;
  remap[0] = 0;
  long sp = 0;
  stack[sp++] = 0;
  long next_id = 1;
  // First pass: assign pre-order ids (children in table order).
  // Emission interleaves with assignment: process stack, for each popped
  // node emit its children lines immediately (they reference remap[parent],
  // already assigned).
  while (sp > 0) {
    long node = stack[--sp];
    const int32_t* ch = children + node * kmax;
    int nk = 0;
    for (int i = 0; i < kmax; ++i)
      if (ch[i] >= 0) kids[nk++] = ch[i];
    for (int i = 0; i < nk; ++i) {
      long c = kids[i];
      remap[c] = next_id++;
      const uint8_t* d = descs + c * 32;
      std::fprintf(f, "%d %d", remap[node], word_id[c] >= 0 ? 1 : 0);
      for (int b = 0; b < 32; ++b) std::fprintf(f, " %u", d[b]);
      float w = word_id[c] >= 0 ? word_weight[word_id[c]] : 0.0f;
      std::fprintf(f, " %.9g\n", w);  // f32 round-trip precision
    }
    for (int i = nk - 1; i >= 0; --i) stack[sp++] = kids[i];
  }
  std::free(remap);
  std::free(stack);
  std::free(kids);
  return std::fclose(f) == 0 ? 0 : -1;
}

}  // extern "C"
