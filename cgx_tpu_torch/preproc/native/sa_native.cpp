// Native suffix-array / LCP / interval-LCP-tree construction for cgx_tpu_torch
// (a copy of cgx_tpu/preproc/native/sa_native.cpp).
//
// Replaces the reference's host-side DC3 + Kasai + recursion_lcp
// (SuffixArray.c:51-193).  The token string ends in a unique
// sentinel, so the suffix array is unique and SA-IS here produces output identical
// to the reference's DC3.  Exposed via a C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// SA-IS over an int alphabet.  s must have length n with values in [0, K); the
// last element must be the unique minimum (we append an internal 0 sentinel).
// ---------------------------------------------------------------------------
void sais_int(const int32_t* s, int32_t* sa, int64_t n, int64_t K,
              std::vector<int64_t>& bkt_scratch) {
  if (n == 0) return;
  if (n == 1) { sa[0] = 0; return; }

  std::vector<uint8_t> t(n);  // 1 = S-type
  t[n - 1] = 1;
  for (int64_t i = n - 2; i >= 0; --i)
    t[i] = (s[i] < s[i + 1] || (s[i] == s[i + 1] && t[i + 1])) ? 1 : 0;

  auto is_lms = [&](int64_t i) { return i > 0 && t[i] && !t[i - 1]; };

  std::vector<int64_t>& bkt = bkt_scratch;
  bkt.assign(K + 1, 0);
  for (int64_t i = 0; i < n; ++i) bkt[s[i] + 1]++;
  for (int64_t i = 0; i < K; ++i) bkt[i + 1] += bkt[i];
  std::vector<int64_t> bkt_start(bkt.begin(), bkt.end());

  auto induce = [&](const std::vector<int64_t>& lms) {
    std::fill(sa, sa + n, -1);
    // place LMS suffixes at bucket ends (in given order, reversed fill)
    std::vector<int64_t> be(bkt_start.begin() + 1, bkt_start.end());
    for (int64_t i = (int64_t)lms.size() - 1; i >= 0; --i) {
      int64_t p = lms[i];
      sa[--be[s[p]]] = (int32_t)p;
    }
    // induce L
    std::vector<int64_t> bs(bkt_start.begin(), bkt_start.end() - 1);
    for (int64_t i = 0; i < n; ++i) {
      int64_t j = sa[i];
      if (j > 0 && !t[j - 1]) sa[bs[s[j - 1]]++] = (int32_t)(j - 1);
    }
    // induce S
    be.assign(bkt_start.begin() + 1, bkt_start.end());
    for (int64_t i = n - 1; i >= 0; --i) {
      int64_t j = sa[i];
      if (j > 0 && t[j - 1]) sa[--be[s[j - 1]]] = (int32_t)(j - 1);
    }
  };

  std::vector<int64_t> lms;
  for (int64_t i = 1; i < n; ++i)
    if (is_lms(i)) lms.push_back(i);

  induce(lms);

  // name LMS substrings in SA order
  int64_t n1 = (int64_t)lms.size();
  std::vector<int64_t> lms_sorted;
  lms_sorted.reserve(n1);
  for (int64_t i = 0; i < n; ++i)
    if (is_lms(sa[i])) lms_sorted.push_back(sa[i]);

  std::vector<int64_t> name(n, -1);
  int64_t names = 0;
  int64_t prev = -1;
  for (int64_t idx = 0; idx < (int64_t)lms_sorted.size(); ++idx) {
    int64_t p = lms_sorted[idx];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      for (int64_t d = 0;; ++d) {
        if (d > 0 && (is_lms(p + d) || is_lms(prev + d))) {
          diff = !(is_lms(p + d) && is_lms(prev + d) && s[p + d] == s[prev + d]);
          break;
        }
        if (s[p + d] != s[prev + d] || t[p + d] != t[prev + d]) {
          diff = true;
          break;
        }
      }
    }
    if (diff) { ++names; prev = p; }
    name[p] = names - 1;
  }

  std::vector<int64_t> order;
  if (names < n1) {
    std::vector<int32_t> s1(n1), sa1(n1);
    int64_t k = 0;
    for (int64_t i = 1; i < n; ++i)
      if (is_lms(i)) s1[k++] = (int32_t)name[i];
    sais_int(s1.data(), sa1.data(), n1, names, bkt_scratch);
    // bkt_scratch was clobbered by recursion: recompute for this level
    bkt.assign(K + 1, 0);
    for (int64_t i = 0; i < n; ++i) bkt[s[i] + 1]++;
    for (int64_t i = 0; i < K; ++i) bkt[i + 1] += bkt[i];
    bkt_start.assign(bkt.begin(), bkt.end());
    order.resize(n1);
    for (int64_t i = 0; i < n1; ++i) order[i] = lms[sa1[i]];
  } else {
    order.resize(n1);
    for (int64_t i = 1; i < n; ++i)
      if (is_lms(i)) order[name[i]] = i;
  }
  induce(order);
}

}  // namespace

extern "C" {

// Builds SA over s[0..n), values in [0, K].  Returns 0 on success.
int cgx_build_sa(const int32_t* s, int64_t n, int32_t K, int32_t* sa_out) {
  if (n <= 0) return 0;
  // append internal 0 sentinel (all real values are >= 1 after +1 shift)
  std::vector<int32_t> s2(n + 1);
  for (int64_t i = 0; i < n; ++i) s2[i] = s[i] + 1;
  s2[n] = 0;
  std::vector<int32_t> sa2(n + 1);
  std::vector<int64_t> scratch;
  sais_int(s2.data(), sa2.data(), n + 1, (int64_t)K + 2, scratch);
  // drop the sentinel suffix (always first)
  std::memcpy(sa_out, sa2.data() + 1, sizeof(int32_t) * n);
  return 0;
}

// Kasai LCP: lcp[i] = LCP(SA[i-1], SA[i]); lcp[0] = 0.
int cgx_build_lcp(const int32_t* s, const int32_t* sa, int64_t n, int32_t* lcp_out) {
  std::vector<int32_t> rank(n);
  for (int64_t i = 0; i < n; ++i) rank[sa[i]] = (int32_t)i;
  std::memset(lcp_out, 0, sizeof(int32_t) * n);
  int64_t h = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = rank[i];
    if (r > 0) {
      int64_t j = sa[r - 1];
      int64_t m = n - std::max(i, j);
      while (h < m && s[i + h] == s[j + h]) ++h;
      lcp_out[r] = (int32_t)h;
      h = 0;
    }
  }
  return 0;
}

// Midpoint-interval LCP tree (SuffixArray.c:131-179), iterative.
int cgx_build_interval_tree(const int32_t* lcp, int64_t n, int32_t* lcpleft,
                            int32_t* lcpright) {
  std::memset(lcpleft, 0, sizeof(int32_t) * n);
  std::memset(lcpright, 0, sizeof(int32_t) * n);
  if (n < 2) return 0;
  struct Frame { int64_t L, R; int stage; int32_t a; };
  std::vector<Frame> stack;
  std::vector<int32_t> ret;  // return-value channel
  stack.push_back({0, n - 1, 0, 0});
  ret.reserve(64);
  int32_t retval = 0;
  while (!stack.empty()) {
    Frame& f = stack.back();
    if (f.L == f.R - 1) {
      retval = lcp[f.R];
      stack.pop_back();
      continue;
    }
    int64_t M = (f.L + f.R) / 2;
    if (f.stage == 0) {
      f.stage = 1;
      stack.push_back({f.L, M, 0, 0});
    } else if (f.stage == 1) {
      f.a = retval;           // result of (L, M)
      f.stage = 2;
      stack.push_back({M, f.R, 0, 0});
    } else {
      lcpleft[M] = f.a;
      lcpright[M] = retval;   // result of (M, R)
      retval = std::min(f.a, retval);
      stack.pop_back();
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Corpus tokenizer + vocab interning (replaces the uthash loaders,
// Start.cu:240-380 / 142-238): whitespace tokens interned in first-appearance
// order with ids starting at 2; separator token 1 after every line.
//
// Two-pass C ABI for ctypes: cgx_tokenize writes token ids + per-line counts and
// returns the vocab as offsets into the input buffer (first occurrence of each
// word), so no strings are copied.
// ---------------------------------------------------------------------------

#include <string_view>
#include <unordered_map>

extern "C" {

// text: corpus bytes (not NUL-terminated), length n.
// out_ids      [>= n tokens]   token id per token (pre-separator layout)
// out_linetok  [>= n lines]    token count per line
// out_word_off [>= n words]    byte offset of each vocab word's first occurrence
// out_word_len [>= n words]    byte length of each vocab word
// Returns number of tokens written; *n_lines_out lines; *n_words_out distinct.
long cgx_tokenize(const char* text, long n, int32_t* out_ids,
                  int32_t* out_linetok, int64_t* out_word_off,
                  int32_t* out_word_len, long* n_lines_out, long* n_words_out) {
  std::unordered_map<std::string_view, int32_t> vocab;
  vocab.reserve(1 << 20);
  long ntok = 0, nlines = 0, nwords = 0;
  long i = 0;
  while (i < n) {
    long line_end = i;
    while (line_end < n && text[line_end] != '\n') ++line_end;
    int32_t line_count = 0;
    long j = i;
    while (j < line_end) {
      while (j < line_end && (text[j] == ' ' || text[j] == '\t' ||
                              text[j] == '\r')) ++j;
      long w0 = j;
      while (j < line_end && text[j] != ' ' && text[j] != '\t' &&
             text[j] != '\r') ++j;
      if (j > w0) {
        std::string_view w(text + w0, (size_t)(j - w0));
        auto it = vocab.find(w);
        int32_t id;
        if (it == vocab.end()) {
          id = (int32_t)(nwords + 2);
          vocab.emplace(w, id);
          out_word_off[nwords] = w0;
          out_word_len[nwords] = (int32_t)(j - w0);
          ++nwords;
        } else {
          id = it->second;
        }
        out_ids[ntok++] = id;
        ++line_count;
      }
    }
    out_linetok[nlines++] = line_count;
    i = line_end + 1;
  }
  *n_lines_out = nlines;
  *n_words_out = nwords;
  return ntok;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Rule-instance dedup (replaces the numpy two-stage sort dedup of
// features/lexicon._dedup_spans): the uthash-style hash grouping of
// createLexiconFast / createLexiconGappyFast / createLexiconTwoGapFast
// (ExtractPair.c:548-556, 723-737) fused with the target-key rendering of
// _target_key_rows — ONE pass over the instance rows, no sorts, no
// materialized [n, 16] key matrix.  Groups are discovered in first-appearance
// order (hash-map insert order), exactly the contract the numpy path restores
// with its post-sort reorder; byte-identity is test-enforced.
// ---------------------------------------------------------------------------

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int KEYW = 16;  // rendered target symbols per rule key

// Render one rule instance's target key row (the semantics of
// features/lexicon._target_key_rows): tokens of [ts, ts+end] with each gap
// span collapsed to a single marker (-1 for gap 1, -3 for gap 2), -2 padding.
inline void render_key(int64_t ts, int64_t end, const int64_t* gs,
                       const int64_t* ge, const int32_t* marker, int ngaps,
                       const int32_t* tgt, int64_t tgt_len, int32_t* key) {
  for (int k = 0; k < KEYW; ++k) key[k] = -2;
  const int64_t te = ts + end;
  for (int64_t k = 0; k < KEYW; ++k) {
    int64_t P = ts + k;
    bool E = P <= te;
    int64_t Pc = P < 0 ? 0 : (P >= tgt_len ? tgt_len - 1 : P);
    int32_t T = tgt[Pc];
    int64_t O = k;
    for (int g = 0; g < ngaps; ++g) {
      bool ing = P >= gs[g] && P <= ge[g];
      if (ing) T = marker[g];
      E = E && (!ing || P == gs[g]);
      if (P > ge[g]) O -= ge[g] - gs[g];
    }
    if (E) {
      int64_t slot = O < KEYW - 1 ? O : KEYW - 1;
      // mirror numpy's wrap on the (KEYW+1)-wide staging buffer for
      // degenerate negative offsets (slot KEYW is the discard column)
      if (slot < 0) slot += KEYW + 1;
      if (slot >= 0 && slot < KEYW) key[slot] = T;
    }
  }
}

inline uint64_t mix64(uint64_t x) {
  x ^= x >> 33; x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33; return x;
}

inline uint64_t hash_row(int64_t cid, const int32_t* key) {
  uint64_t h = mix64((uint64_t)cid);
  for (int k = 0; k < KEYW; k += 2) {
    uint64_t w = ((uint64_t)(uint32_t)key[k] << 32) | (uint32_t)key[k + 1];
    h = mix64(h ^ w);
  }
  return h;
}

}  // namespace

extern "C" {

// Groups n rule instances by (cid, rendered key).  g1/g11 (and g2/g21) may be
// NULL for families without that gap.  out_first/out_counts have capacity n;
// out_keys capacity n*16.  Returns the number of distinct rules.
int64_t cgx_dedup_rules(const int64_t* cid, const int64_t* ts,
                        const int64_t* end, const int64_t* g1,
                        const int64_t* g11, const int64_t* g2,
                        const int64_t* g21, int64_t n, const int32_t* tgt,
                        int64_t tgt_len, int64_t* out_first,
                        int64_t* out_counts, int32_t* out_keys) {
  if (n <= 0) return 0;
  uint64_t cap = 16;
  while (cap < (uint64_t)(2 * n)) cap <<= 1;
  std::vector<int64_t> table(cap, -1);  // slot -> group id
  std::vector<int64_t> gcid;            // group id -> cid
  gcid.reserve((size_t)(n / 4 + 16));
  const uint64_t mask = cap - 1;
  int64_t ngroups = 0;
  int32_t key[KEYW];
  int64_t gs[2], ge[2];
  int32_t marker[2];
  for (int64_t i = 0; i < n; ++i) {
    int ngaps = 0;
    if (g1) {
      gs[ngaps] = ts[i] + g1[i]; ge[ngaps] = ts[i] + g11[i];
      marker[ngaps++] = -1;
    }
    if (g2) {
      gs[ngaps] = ts[i] + g2[i]; ge[ngaps] = ts[i] + g21[i];
      marker[ngaps++] = -3;
    }
    render_key(ts[i], end[i], gs, ge, marker, ngaps, tgt, tgt_len, key);
    uint64_t h = hash_row(cid[i], key) & mask;
    for (;;) {
      int64_t gid = table[h];
      if (gid < 0) {
        table[h] = ngroups;
        out_first[ngroups] = i;
        out_counts[ngroups] = 1;
        std::memcpy(out_keys + ngroups * KEYW, key, sizeof(key));
        gcid.push_back(cid[i]);
        ++ngroups;
        break;
      }
      if (gcid[(size_t)gid] == cid[i] &&
          std::memcmp(out_keys + gid * KEYW, key, sizeof(key)) == 0) {
        ++out_counts[gid];
        break;
      }
      h = (h + 1) & mask;
    }
  }
  return ngroups;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Rule-line feature formatting (replaces the host printf loop of
// PrintResults.c:355-364 at rule-count scale): the 7-feature suffix of every
// cdec rule line, snprintf "%f" (6-decimal fixed, correctly rounded — glibc
// and CPython's float __mod__ produce identical bytes for every double, so
// output is byte-identical to the Python formatter; test-enforced).
// ---------------------------------------------------------------------------

#include <cstdio>

namespace {

// Memoized "%f" formatting keyed on the float's bit pattern: the feature
// columns repeat heavily (fsample/paircount are small clamped ints; MaxLex
// scores repeat per word pair), so most of the 5 conversions per line hit
// the cache instead of glibc's snprintf (~200ns per "%f").  Entries longer
// than 16 bytes (|value| >= 1e9, never a real feature) bypass the cache;
// output bytes are identical either way.
struct F6Cache {
  static constexpr uint64_t CAP = 1u << 16;
  static constexpr int W = 16;
  std::vector<uint32_t> bits;
  std::vector<uint8_t> len;   // 0 = empty slot
  std::vector<char> txt;
  F6Cache() : bits(CAP), len(CAP), txt(CAP * W) {}
  inline int format(float v, char* out) {
    uint32_t b;
    std::memcpy(&b, &v, 4);
    uint64_t h = mix64(b) & (CAP - 1);
    for (int probe = 0; probe < 8; ++probe) {
      if (len[h] == 0) {
        char tmp[352];
        int m = snprintf(tmp, sizeof tmp, "%f", (double)v);
        if (m > 0 && m <= W) {
          bits[h] = b;
          len[h] = (uint8_t)m;
          std::memcpy(&txt[h * W], tmp, (size_t)m);
        }
        std::memcpy(out, tmp, (size_t)m);
        return m;
      }
      if (bits[h] == b) {
        std::memcpy(out, &txt[h * W], len[h]);
        return len[h];
      }
      h = (h + 1) & (CAP - 1);
    }
    return snprintf(out, 352, "%f", (double)v);
  }
};

// Assembles one 7-feature suffix into `line` (capacity >= 512); returns its
// length.  Byte-identical to the snprintf format string it replaces.
inline int format_suffix(F6Cache& c, float aa, float fss, float bb, float fge,
                         float egf, int64_t f, int64_t pc, char* line) {
  int w = 0;
  auto lit = [&](const char* s, int m) { std::memcpy(line + w, s, m); w += m; };
  lit("EgivenFCoherent=", 16); w += c.format(aa, line + w);
  lit(" SampleCountF=", 14);   w += c.format(fss, line + w);
  lit(" CountEF=", 9);         w += c.format(bb, line + w);
  lit(" MaxLexFgivenE=", 15);  w += c.format(fge, line + w);
  lit(" MaxLexEgivenF=", 15);  w += c.format(egf, line + w);
  lit(" IsSingletonF=", 14);   line[w++] = f == 1 ? '1' : '0';
  lit(" IsSingletonFE=", 15);  line[w++] = pc == 1 ? '1' : '0';
  return w;
}

}  // namespace

extern "C" {

// Formats n feature suffixes into `out` (capacity out_cap bytes);
// offsets[n+1] receives the running byte offsets.  Returns total bytes
// written, or -1 if out_cap would be exceeded.
int64_t cgx_format_features(const float* aa, const float* fss,
                            const float* bb, const float* fge,
                            const float* egf, const int64_t* f,
                            const int64_t* pc, int64_t n, char* out,
                            int64_t out_cap, int64_t* offsets) {
  F6Cache cache;
  char line[512];
  int64_t w = 0;
  offsets[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    int m = format_suffix(cache, aa[i], fss[i], bb[i], fge[i], egf[i],
                          f[i], pc[i], line);
    if (m >= (int)sizeof(line) || out_cap - w < m) return -1;
    std::memcpy(out + w, line, (size_t)m);
    w += m;
    offsets[i + 1] = w;
  }
  return w;
}


// Formats n COMPLETE rule lines: "[X] ||| <lexical[i]> ||| <features...>".
// lex: concatenated UTF-8 lexical strings, lex_offs[n+1] byte offsets.
// Returns total bytes written into out, or -1 if out_cap would be exceeded.
int64_t cgx_format_rule_lines(const char* lex, const int64_t* lex_offs,
                              const float* aa, const float* fss,
                              const float* bb, const float* fge,
                              const float* egf, const int64_t* f,
                              const int64_t* pc, int64_t n, char* out,
                              int64_t out_cap, int64_t* offsets) {
  F6Cache cache;
  char line[512];
  int64_t w = 0;
  offsets[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t ll = lex_offs[i + 1] - lex_offs[i];
    int m = format_suffix(cache, aa[i], fss[i], bb[i], fge[i], egf[i],
                          f[i], pc[i], line);
    if (m >= (int)sizeof(line) || out_cap - w < ll + m + 13) return -1;
    std::memcpy(out + w, "[X] ||| ", 8);
    w += 8;
    std::memcpy(out + w, lex + lex_offs[i], (size_t)ll);
    w += ll;
    std::memcpy(out + w, " ||| ", 5);
    w += 5;
    std::memcpy(out + w, line, (size_t)m);
    w += m;
    offsets[i + 1] = w;
  }
  return w;
}

}  // extern "C"
