// Host-native runtime components: streaming FASTA parsing and a rolling
// minimizer sketcher.  C ABI for ctypes binding from python.
//
// These are the framework's native equivalents of the reference pipeline's
// external C/C++ tools (btllib SeqReader/Indexlr, see SURVEY §2.3): the
// parser feeds base codes straight into packed buffers, and the sketcher is
// the sequential rolling-hash formulation of the device kernel — used as a
// differential oracle against the closed-form JAX/Pallas paths and as the
// fast host fallback when no accelerator is attached.
//
// Hash contract (identical to ops/nthash_np.py): ntHash2 split rotation,
// canonical = forward + reverse (mod 2^64), selection by canonical hash,
// emitted value = nte(canonical, k, 1).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#include <string>

namespace {

constexpr uint64_t kSeed[4] = {0x3C8BFBB395C60474ULL, 0x3193C18562A02B4CULL,
                               0x20323ED082572324ULL, 0x295549F54BE24456ULL};
constexpr uint64_t kMultiSeed = 0x90B45D39FB6DA1FAULL;
constexpr int kMultiShift = 27;
constexpr uint8_t kInvalid = 4;

inline uint64_t srol(uint64_t x) {
  uint64_t m = ((x & 0x8000000000000000ULL) >> 30) | ((x & 0x100000000ULL) >> 32);
  return ((x << 1) & 0xFFFFFFFDFFFFFFFFULL) | m;
}

inline uint64_t srol_n(uint64_t x, unsigned n) {
  unsigned nl = n % 33, nh = n % 31;
  uint64_t low = x & 0x1FFFFFFFFULL;
  uint64_t high = x >> 33;
  if (nl) low = ((low << nl) | (low >> (33 - nl))) & 0x1FFFFFFFFULL;
  if (nh) high = ((high << nh) | (high >> (31 - nh))) & 0x7FFFFFFFULL;
  return (high << 33) | low;
}

inline uint64_t sror1(uint64_t x) {  // srol^{-1}: both groups rotate right 1
  uint64_t low = x & 0x1FFFFFFFFULL;
  uint64_t high = x >> 33;
  low = (low >> 1) | ((low & 1ULL) << 32);
  high = (high >> 1) | ((high & 1ULL) << 30);
  return (high << 33) | low;
}

// Shared rolling-hash core (the bit-exactness contract lives in ONE place:
// both nj_canonical_hashes and nj_sketch advance through these).
struct RollTabs {
  uint64_t out[4], rc_in[4];
  explicit RollTabs(int k) {
    for (int c = 0; c < 4; ++c) {
      out[c] = srol_n(kSeed[c], (unsigned)k);
      rc_in[c] = srol_n(kSeed[3 - c], (unsigned)(k - 1));
    }
  }
};

// (Re)build both strand states from the k-mer starting at codes[p].
inline void roll_build(const uint8_t* codes, int64_t p, int k,
                       uint64_t& f, uint64_t& r) {
  f = 0; r = 0;
  for (int j = 0; j < k; ++j) {
    f = srol(f) ^ kSeed[codes[p + j]];
    r = srol(r) ^ kSeed[3 - codes[p + k - 1 - j]];
  }
}

// Advance both strands by one base (oc leaves, ic enters):
//   f' = srol(f) ^ srol^k(seed[oc]) ^ seed[ic]
//   r' = srol^{-1}(r ^ seed[rc(oc)]) ^ srol^{k-1}(seed[rc(ic)])
inline void roll_step(const RollTabs& tabs, uint8_t oc, uint8_t ic,
                      uint64_t& f, uint64_t& r) {
  f = srol(f) ^ tabs.out[oc] ^ kSeed[ic];
  r = sror1(r ^ kSeed[3 - oc]) ^ tabs.rc_in[ic];
}

inline uint64_t nte1(uint64_t h, unsigned k) {
  uint64_t t = h * (1ULL ^ (uint64_t)k * kMultiSeed);
  return t ^ (t >> kMultiShift);
}

uint8_t g_code_lut[256];
struct LutInit {
  LutInit() {
    memset(g_code_lut, kInvalid, sizeof(g_code_lut));
    const char* b = "ACGT";
    for (int i = 0; i < 4; ++i) {
      g_code_lut[(unsigned char)b[i]] = (uint8_t)i;
      g_code_lut[(unsigned char)(b[i] + 32)] = (uint8_t)i;
    }
  }
} g_lut_init;

}  // namespace

extern "C" {

// Encode ASCII bases to codes in-place-ish: dst must hold n bytes.
void nj_encode(const char* seq, int64_t n, uint8_t* dst) {
  for (int64_t i = 0; i < n; ++i) dst[i] = g_code_lut[(unsigned char)seq[i]];
}

// Pack int8 codes (low 2 bits each) 4-per-byte into out[byte_off..]; the
// device upload path ships 2-bit codes (4x less host-to-device traffic) and paints
// invalid runs separately.  Tail codes (n % 4) pack into one final byte.
void nj_pack2(const int8_t* codes, int64_t n, uint8_t* out, int64_t byte_off) {
  uint8_t* dst = out + byte_off;
  int64_t nfull = n / 4;
  for (int64_t i = 0; i < nfull; ++i) {
    const int8_t* c = codes + 4 * i;
    dst[i] = (uint8_t)((c[0] & 3) | ((c[1] & 3) << 2) | ((c[2] & 3) << 4) |
                       ((c[3] & 3) << 6));
  }
  if (n % 4) {
    uint8_t tail = 0;
    for (int64_t j = 0; j < n % 4; ++j)
      tail |= (uint8_t)((codes[4 * nfull + j] & 3) << (2 * j));
    dst[nfull] = tail;
  }
}

// Canonical hash of every kmer start (valid flag separate).  Used by tests.
void nj_canonical_hashes(const uint8_t* codes, int64_t n, int k,
                         uint64_t* hashes, uint8_t* valid) {
  if (n < k) return;
  int64_t nk = n - k + 1;
  // O(n) rolling with both strands: maintain f and r.
  RollTabs tabs(k);
  uint64_t f = 0, r = 0;
  bool have = false;
  for (int64_t p = 0; p < nk; ++p) {
    // validity of window [p, p+k)
    bool ok = true;
    if (p == 0) {
      for (int j = 0; j < k; ++j)
        if (codes[j] >= kInvalid) { ok = false; break; }
    } else {
      // incremental validity: recompute only when edges are invalid
      ok = valid[p - 1] ? (codes[p + k - 1] < kInvalid)
                        : false;
      if (!ok && codes[p + k - 1] < kInvalid) {
        ok = true;
        for (int j = 0; j < k; ++j)
          if (codes[p + j] >= kInvalid) { ok = false; break; }
      }
    }
    valid[p] = ok ? 1 : 0;
    if (!ok) { have = false; hashes[p] = 0; continue; }
    if (!have) {
      roll_build(codes, p, k, f, r);
      have = true;
    } else {
      roll_step(tabs, codes[p - 1], codes[p + k - 1], f, r);
    }
    hashes[p] = f + r;
  }
}

// Full minimizer sketch of one record: fused single pass (rolling hash +
// monotone-deque window minimum), O(w) extra memory.  Returns the number of
// minimizers written (capped at cap); positions/hashes are parallel outputs.
int64_t nj_sketch(const uint8_t* codes, int64_t n, int k, int w,
                  int64_t* positions, uint64_t* hashes, int64_t cap) {
  if (k > n || w > n - k + 1) return 0;
  int64_t nk = n - k + 1;
  RollTabs tabs(k);
  // deque slots over the last <= w valid kmers
  struct Slot { uint64_t hash; int64_t pos; int64_t sidx; };
  int64_t dsz = 1;
  while (dsz < w + 1) dsz <<= 1;  // power-of-two ring: mask instead of div
  const int64_t dmask = dsz - 1;
  std::vector<Slot> deq((size_t)dsz);
  int64_t head = 0, tail = 0;  // indices into deq (mod size)
  uint64_t f = 0, r = 0;
  bool have = false;
  int64_t stream_i = 0;  // count of valid kmers so far
  int64_t count = 0, last_emit = -1;
  for (int64_t p = 0; p < nk; ++p) {
    uint8_t ic = codes[p + k - 1];
    bool ok;
    if (!have) {
      ok = true;
      for (int j = 0; j < k; ++j)
        if (codes[p + j] >= kInvalid) { ok = false; break; }
      if (ok) {
        roll_build(codes, p, k, f, r);
        have = true;
      }
    } else {
      ok = ic < kInvalid;
      if (ok) {
        roll_step(tabs, codes[p - 1], ic, f, r);
      } else {
        have = false;
      }
    }
    if (!ok) continue;
    uint64_t hv = f + r;
    // monotone deque: strict pop keeps the leftmost of equal hashes ahead
    while (tail > head && deq[(tail - 1) & dmask].hash > hv) --tail;
    deq[tail & dmask] = {hv, p, stream_i};
    ++tail;
    if (stream_i >= w - 1) {
      while (deq[head & dmask].sidx <= stream_i - w) ++head;
      const Slot& s = deq[head & dmask];
      if (s.sidx != last_emit) {
        if (count < cap) {
          positions[count] = s.pos;
          hashes[count] = nte1(s.hash, (unsigned)k);
        }
        ++count;
        last_emit = s.sidx;
      }
    }
    ++stream_i;
  }
  return count < cap ? count : cap;
}

// Tile-parallel sketch: threads own disjoint window ranges with one extra
// left seam window each; halos make every window exact and the merge drops
// the duplicate seam emission (same halo algebra as the device mesh path).
// Windows slide over VALID k-mers, so N-containing records tile in
// valid-k-mer STREAM space: thread boundaries are resolved to the base
// positions of their stream ranks (two cheap O(n) scans), exactly like
// parallel/mesh.py's stream-split.  (The old code fell back to the
// single-thread sketcher for ANY non-ACGT base, serializing every real
// N-gapped scaffold input.)
int64_t nj_sketch_mt(const uint8_t* codes, int64_t n, int k, int w,
                     int threads, int64_t* positions, uint64_t* hashes,
                     int64_t cap) {
  if (k > n || w > n - k + 1) return 0;
  int64_t nk = n - k + 1;
  // one pass: count valid k-mers (ns) and detect invalid bases
  int64_t ns = 0, last_bad = -1;
  for (int64_t i = 0; i < n; ++i) {
    if (codes[i] >= kInvalid) last_bad = i;
    if (i >= k - 1 && i - last_bad >= k) ++ns;
  }
  bool clean = ns == nk;
  int64_t nsw = ns - w + 1;  // stream windows
  if (threads <= 1 || nsw < (int64_t)threads * 4096) {
    return nj_sketch(codes, n, k, w, positions, hashes, cap);
  }
  int64_t per = (nsw + threads - 1) / threads;
  // per-thread base ranges: identity mapping for clean records, resolved
  // stream ranks otherwise (lo rank includes the lead seam window)
  std::vector<int64_t> blo((size_t)threads), bhi((size_t)threads);
  std::vector<int64_t> wown((size_t)threads);
  {
    std::vector<int64_t> lo_rank((size_t)threads), hi_rank((size_t)threads);
    for (int t = 0; t < threads; ++t) {
      int64_t w_lo = (int64_t)t * per;
      int64_t w_hi = w_lo + per < nsw ? w_lo + per : nsw;
      wown[t] = w_hi - w_lo;
      if (wown[t] <= 0) continue;
      lo_rank[t] = w_lo - (t > 0 ? 1 : 0);
      int64_t last = w_hi - 1 + w - 1;  // last window's last k-mer rank
      hi_rank[t] = last < ns - 1 ? last : ns - 1;
    }
    if (clean) {
      for (int t = 0; t < threads; ++t) {
        if (wown[t] <= 0) continue;
        blo[t] = lo_rank[t];
        bhi[t] = hi_rank[t] + k;
      }
    } else {
      // second pass: resolve the (ascending) rank targets to k-mer start
      // positions; both target lists are ascending in t -> merge-scan
      int tl = 0, th = 0;
      while (tl < threads && wown[tl] <= 0) ++tl;
      while (th < threads && wown[th] <= 0) ++th;
      int64_t rank = 0;
      last_bad = -1;
      for (int64_t i = 0; i < n && (tl < threads || th < threads); ++i) {
        if (codes[i] >= kInvalid) last_bad = i;
        if (i >= k - 1 && i - last_bad >= k) {
          int64_t start = i - k + 1;
          while (tl < threads && lo_rank[tl] == rank) {
            blo[tl] = start;
            do { ++tl; } while (tl < threads && wown[tl] <= 0);
          }
          while (th < threads && hi_rank[th] == rank) {
            bhi[th] = start + k;
            do { ++th; } while (th < threads && wown[th] <= 0);
          }
          ++rank;
        }
      }
    }
  }
  struct Part {
    std::vector<int64_t> pos;
    std::vector<uint64_t> hash;
  };
  std::vector<Part> parts((size_t)threads);
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&, t]() {
      int64_t w_lo = (int64_t)t * per;
      int64_t w_hi = w_lo + per < nsw ? w_lo + per : nsw;
      if (w_lo >= w_hi) return;
      int64_t base_lo = blo[t];
      int64_t len = bhi[t] - base_lo;
      // expected emissions ~= 2*windows/w (each window moves the argmin with
      // prob ~2/w); size for 4x that and grow geometrically on overflow
      // rather than touching a windows-sized zeroed buffer up front.
      int64_t local_cap = (w_hi - w_lo) / (w > 8 ? w / 8 : 1) + 64;
      int64_t hard_cap = (w_hi - w_lo) + 2;
      if (local_cap > hard_cap) local_cap = hard_cap;
      Part& part = parts[t];
      part.pos.resize((size_t)local_cap);
      part.hash.resize((size_t)local_cap);
      int64_t cnt = nj_sketch(codes + base_lo, len, k, w, part.pos.data(),
                              part.hash.data(), local_cap);
      // grow on overflow (dense emission)
      while (cnt >= local_cap) {
        local_cap *= 2;
        part.pos.resize((size_t)local_cap);
        part.hash.resize((size_t)local_cap);
        cnt = nj_sketch(codes + base_lo, len, k, w, part.pos.data(),
                        part.hash.data(), local_cap);
      }
      part.pos.resize((size_t)cnt);
      part.hash.resize((size_t)cnt);
      for (auto& p : part.pos) p += base_lo;  // back to global positions
    });
  }
  for (auto& th : pool) th.join();
  int64_t count = 0;
  int64_t last_pos = -1;
  for (int t = 0; t < threads; ++t) {
    const Part& part = parts[t];
    for (size_t i = 0; i < part.pos.size(); ++i) {
      if (part.pos[i] == last_pos) continue;  // duplicate seam emission
      if (count < cap) {
        positions[count] = part.pos[i];
        hashes[count] = part.hash[i];
      }
      ++count;
      last_pos = part.pos[i];
    }
  }
  return count < cap ? count : cap;
}

// Walk a linear chain from `source`: n1/n2 are each node's (<=2) neighbour
// ids (-1 when absent), e1/e2 the corresponding edge ids.  Writes the node
// order and the edge id taken at each step; returns the walked length.
int64_t nj_walk_chain(const int32_t* n1, const int32_t* n2,
                      const int32_t* e1, const int32_t* e2,
                      int64_t source, int64_t max_len,
                      int32_t* out_nodes, int32_t* out_eids) {
  int64_t prev = -1, cur = source, len = 0;
  while (cur >= 0 && len < max_len) {
    out_nodes[len] = (int32_t)cur;
    int64_t a = n1[cur], b = n2[cur];
    int64_t nxt, eid;
    if (a != prev) { nxt = a; eid = e1[cur]; }
    else { nxt = b; eid = e2[cur]; }
    if (len + 1 < max_len && nxt >= 0) out_eids[len] = (int32_t)eid;
    prev = cur;
    cur = nxt;
    ++len;
  }
  return len;
}

// Write a samtools-faidx-format .fai index for a FASTA file.  Columns:
// name, length, byte offset of first base, bases per line, bytes per line.
// Records whose sequence lines are NOT uniform (every line but the last must
// have exactly linebases bases / linewidth bytes, no interior blank lines —
// the same rule samtools faidx enforces by erroring out) are written with
// linebases=linewidth=0 as a deterministic "ragged" sentinel: byte-offset
// slicing is impossible for them and FastaStore materialises those records
// from the raw bytes instead.  Returns the number of records indexed, or -1
// on IO error.
int64_t nj_write_fai(const char* path, const char* out_path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  FILE* out = fopen(out_path, "wb");
  if (!out) { fclose(f); return -1; }
  std::vector<char> buf((size_t)1 << 20);
  std::string carry;
  std::string name;
  int64_t length = 0, offset = 0, linebases = 0, linewidth = 0;
  int64_t prev_stripped = 0, prev_raw = 0;
  bool have = false, first_line = true, uniform = true, saw_blank = false;
  int64_t pos = 0, count = 0;
  auto flush_record = [&]() {
    if (have) {
      // the final sequence line may be SHORTER than linebases but never
      // longer (byte arithmetic would walk into a phantom next line)
      if (!first_line && prev_stripped > linebases) uniform = false;
      int64_t lb = uniform ? linebases : 0;
      int64_t lw = uniform ? linewidth : 0;
      fprintf(out, "%s\t%lld\t%lld\t%lld\t%lld\n", name.c_str(),
              (long long)length, (long long)offset, (long long)lb,
              (long long)lw);
      ++count;
    }
  };
  auto handle_line = [&](const char* line, int64_t raw_len) {
    // raw_len includes the newline if present
    int64_t stripped = raw_len;
    while (stripped > 0 &&
           (line[stripped - 1] == '\n' || line[stripped - 1] == '\r'))
      --stripped;
    if (stripped > 0 && line[0] == '>') {
      flush_record();
      int64_t e = 1;
      while (e < stripped && line[e] != ' ' && line[e] != '\t') ++e;
      name.assign(line + 1, (size_t)(e - 1));
      have = true;
      length = 0;
      offset = pos + raw_len;
      first_line = true;
      uniform = true;
      saw_blank = false;
      linebases = 0;  // empty records write 0/0 like samtools (no
      linewidth = 0;  // stale values from the previous record)
    } else if (have && stripped > 0) {
      if (first_line) {
        linebases = stripped;
        linewidth = raw_len;
        first_line = false;
        if (saw_blank) uniform = false;  // blank line shifted `offset`
      } else {
        // The previous sequence line was not the record's last, so it must
        // have been full-width; a blank line before any further bases also
        // breaks offset arithmetic.
        if (prev_stripped != linebases || prev_raw != linewidth || saw_blank)
          uniform = false;
      }
      prev_stripped = stripped;
      prev_raw = raw_len;
      length += stripped;
    } else if (have && stripped == 0) {
      saw_blank = true;
    }
    pos += raw_len;
  };
  size_t got;
  while ((got = fread(buf.data(), 1, buf.size(), f)) > 0) {
    size_t start = 0;
    for (size_t i = 0; i < got; ++i) {
      if (buf[i] == '\n') {
        if (!carry.empty()) {
          carry.append(buf.data() + start, i - start + 1);
          handle_line(carry.data(), (int64_t)carry.size());
          carry.clear();
        } else {
          handle_line(buf.data() + start, (int64_t)(i - start + 1));
        }
        start = i + 1;
      }
    }
    if (start < got) carry.append(buf.data() + start, got - start);
  }
  if (!carry.empty()) handle_line(carry.data(), (int64_t)carry.size());
  flush_record();
  bool bad = ferror(f) || ferror(out);
  fclose(f);
  if (fclose(out) != 0 || bad) return -1;  // honor the -1-on-IO-error contract
  return count;
}

// Minimizer-graph DOT dump (node labels + coloured edges).  All variable
// text is passed in as python-prepared string tables so the formatting
// contract (python float/str semantics) stays in one place; this function
// only does the hot per-node/per-edge assembly and decimal conversion.
//
//   prefix_blob/prefix_off: per-(assembly,contig) label prefixes, flattened;
//     assembly a's contig c uses entry prefix_base[a] + ctg[a*num_nodes+i].
//   wblob/woff + widx: per-edge weight strings (unique-value table).
//   cblob/coff + cidx: per-edge colour strings (unique-mask table).
int64_t nj_write_dot(
    const char* out_path, int64_t num_nodes, const uint64_t* node_hash,
    int32_t n_asm, const char* prefix_blob, const int64_t* prefix_off,
    const int64_t* prefix_base, const int32_t* ctg, const int64_t* pos,
    int64_t n_edges, const int32_t* esrc, const int32_t* edst,
    const int32_t* widx, const char* wblob, const int64_t* woff,
    const int32_t* cidx, const char* cblob, const int64_t* coff) {
  FILE* out = fopen(out_path, "wb");
  if (!out) return -1;
  std::string buf;
  buf.reserve(1 << 22);
  char tmp[24];
  auto put_u64 = [&](uint64_t v) {
    char* e = tmp + sizeof(tmp);
    char* p = e;
    do { *--p = (char)('0' + v % 10); v /= 10; } while (v);
    buf.append(p, (size_t)(e - p));
  };
  auto put_i64 = [&](int64_t v) {
    if (v < 0) { buf.push_back('-'); put_u64((uint64_t)(-v)); }
    else put_u64((uint64_t)v);
  };
  auto flush_if_big = [&]() {
    if (buf.size() > (3u << 20)) {
      fwrite(buf.data(), 1, buf.size(), out);
      buf.clear();
    }
  };
  buf.append("graph G {\n");
  for (int64_t i = 0; i < num_nodes; ++i) {
    buf.push_back('"');
    put_u64(node_hash[i]);
    buf.append("\" [label=\"");
    put_u64(node_hash[i]);
    for (int32_t a = 0; a < n_asm; ++a) {
      buf.push_back('\n');
      int64_t pi = prefix_base[a] + ctg[(int64_t)a * num_nodes + i];
      buf.append(prefix_blob + prefix_off[pi],
                 (size_t)(prefix_off[pi + 1] - prefix_off[pi]));
      put_i64(pos[(int64_t)a * num_nodes + i]);
      buf.push_back(')');
    }
    buf.append("\"]\n");
    flush_if_big();
  }
  for (int64_t e = 0; e < n_edges; ++e) {
    buf.push_back('"');
    put_u64(node_hash[esrc[e]]);
    buf.append("\" --\"");
    put_u64(node_hash[edst[e]]);
    buf.append("\" [weight=");
    int64_t wi = widx[e];
    buf.append(wblob + woff[wi], (size_t)(woff[wi + 1] - woff[wi]));
    buf.append(" color=");
    int64_t ci = cidx[e];
    buf.append(cblob + coff[ci], (size_t)(coff[ci + 1] - coff[ci]));
    buf.append("]\n");
    flush_if_big();
  }
  buf.append("}\n");
  fwrite(buf.data(), 1, buf.size(), out);
  bool bad = ferror(out) != 0;
  if (fclose(out) != 0 || bad) return -1;  // truncated DOT must not pass
  return num_nodes + n_edges;
}

// ---- streaming FASTA parser ------------------------------------------------

struct NjFasta {
  std::vector<std::string> names;
  std::vector<std::string> seqs;
};

void* nj_fasta_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  NjFasta* fa = new NjFasta();
  std::string line;
  line.reserve(1 << 16);
  std::vector<char> buf((size_t)1 << 20);
  std::string cur;
  bool in_rec = false;
  // NUL-safe framing: fgets+strlen silently merged lines (and whole
  // records) when a corrupt input contained a 0 byte; scan fread chunks
  // for newlines instead, like nj_write_fai does.
  auto handle = [&]() {
    size_t len = line.size();
    if (len && line[len - 1] == '\r') line.resize(--len);
    if (len && line[0] == '>') {
      if (in_rec) fa->seqs.push_back(cur);
      size_t sp = line.find_first_of(" \t");
      fa->names.push_back(
          line.substr(1, sp == std::string::npos ? len - 1 : sp - 1));
      cur.clear();
      in_rec = true;
    } else if (in_rec) {
      cur += line;
    }
    line.clear();
  };
  size_t got;
  while ((got = fread(buf.data(), 1, buf.size(), f)) > 0) {
    size_t start = 0;
    for (size_t i = 0; i < got; ++i) {
      if (buf[i] == '\n') {
        line.append(buf.data() + start, i - start);
        handle();
        start = i + 1;
      }
    }
    if (start < got) line.append(buf.data() + start, got - start);
  }
  if (!line.empty()) handle();
  if (in_rec) fa->seqs.push_back(cur);
  fclose(f);
  return fa;
}

int64_t nj_fasta_count(void* h) { return ((NjFasta*)h)->names.size(); }

int64_t nj_fasta_len(void* h, int64_t i) { return ((NjFasta*)h)->seqs[i].size(); }

int64_t nj_fasta_name(void* h, int64_t i, char* out, int64_t cap) {
  const std::string& s = ((NjFasta*)h)->names[i];
  int64_t n = (int64_t)s.size() < cap - 1 ? (int64_t)s.size() : cap - 1;
  memcpy(out, s.data(), n);
  out[n] = 0;
  return (int64_t)s.size();
}

const char* nj_fasta_seq_ptr(void* h, int64_t i) {
  return ((NjFasta*)h)->seqs[i].data();
}

void nj_fasta_seq(void* h, int64_t i, char* out) {
  const std::string& s = ((NjFasta*)h)->seqs[i];
  memcpy(out, s.data(), s.size());
}

void nj_fasta_codes(void* h, int64_t i, uint8_t* out) {
  const std::string& s = ((NjFasta*)h)->seqs[i];
  nj_encode(s.data(), (int64_t)s.size(), out);
}

void nj_fasta_close(void* h) { delete (NjFasta*)h; }

}  // extern "C"
