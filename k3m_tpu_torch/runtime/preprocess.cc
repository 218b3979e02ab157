// Native per-sample preprocessing: K3MR record -> fixed-shape batch arrays.
//
// The reference's online data path is C-backed end to end: LMDB (C) ->
// msgpack-numpy (C ext) -> tensorpack PrefetchDataZMQ (ZeroMQ, C) feeding
// BertPreprocessBatch (concept_cap_dataset_struc.py:532-933). This is the
// port's copy of k3m_tpu/runtime/preprocess.cc: one C++ call maps a batch of
// record indices to the final padded/masked/collated numpy batch, doing
// record decode (msgpack subset), WordPiece tokenization, MLM +
// deterministic-pv + RoI masking, pv span indexing, IoU co-masking and the
// global-image-token prepend, byte-identical to the Python path in
// k3m_tpu_torch/data/preprocess.py and to the JAX package's native producer
// (tests/test_torch_native.py). The `file.py:line` references below are to
// the JAX package's Python modules, which the port's copies mirror.
//
// Randomness: the Python loader pre-draws per-sample uniform/integer blocks
// from numpy (np.random.default_rng((seed, epoch, i, 0))) and passes them
// in, so the native and Python paths consume the SAME draws and produce
// bit-equal batches — no RNG is reimplemented here.
//
// Unicode: tokenization needs per-codepoint category flags and the
// lower+NFD-strip-Mn transform. Those are generated from Python's own
// unicodedata (k3m_tpu_torch/runtime/unicode_tables.py) and passed in as tables,
// so the C++ basic tokenizer matches the Python tokenizer by construction.
// (Known, documented divergence: U+03A3 GREEK CAPITAL SIGMA lowercases
// context-freely to sigma here, where Python's str.lower() applies the
// Final_Sigma rule; irrelevant for the Chinese product domain.)
//
// Build (k3m_tpu_torch/runtime/__init__.py, at first use, into build/):
// g++ -O3 -ffp-contract=off -pthread -shared -fPIC -o libk3mnative.so
// preprocess.cc (recordio.cc is #included for the mmap reader and
// arrayrecord.cc for the ArrayRecord framing; a single translation unit,
// whose library also serves the record readers).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "recordio.cc"  // k3mr_open/k3mr_record/k3mr_close + Reader
#include "arrayrecord.cc"  // k3mar_*: ArrayRecord framing and hashes

namespace {

// ------------------------------------------------------------------ flags
constexpr uint8_t F_WS = 1;       // _is_whitespace (space,\t\n\r, Zs)
constexpr uint8_t F_CTRL = 2;     // _is_control (C* except \t\n\r)
constexpr uint8_t F_PUNCT = 4;    // _is_punctuation
constexpr uint8_t F_CJK = 8;      // _is_cjk
constexpr uint8_t F_DROP = 16;    // cp==0 or cp==0xFFFD
constexpr uint8_t F_PYSPACE = 32; // Python str.isspace()

constexpr uint32_t MAX_CP = 0x110000;

// --------------------------------------------------------------- msgpack
// Minimal decoder for the subset records.py emits (packb with
// use_bin_type=True): maps, str, bin, ints, floats, arrays, nil, bool.

struct MsgView {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint8_t peek() { return ok && p < end ? *p : (ok = false, 0); }
  uint8_t next() { return ok && p < end ? *p++ : (ok = false, 0); }
  bool take(size_t n, const uint8_t** out) {
    if (!ok || p + n > end) { ok = false; return false; }
    *out = p; p += n; return true;
  }
  uint64_t be(int n) {
    const uint8_t* q;
    if (!take(n, &q)) return 0;
    uint64_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 8) | q[i];
    return v;
  }
};

struct MsgStr { const char* p = nullptr; size_t len = 0; };
struct MsgBin { const uint8_t* p = nullptr; size_t len = 0; };

bool msg_read_str(MsgView& v, MsgStr* out) {
  uint8_t t = v.next();
  size_t n;
  if ((t & 0xe0) == 0xa0) n = t & 0x1f;
  else if (t == 0xd9) n = v.be(1);
  else if (t == 0xda) n = v.be(2);
  else if (t == 0xdb) n = v.be(4);
  else { v.ok = false; return false; }
  const uint8_t* q;
  if (!v.take(n, &q)) return false;
  out->p = reinterpret_cast<const char*>(q);
  out->len = n;
  return true;
}

bool msg_read_int(MsgView& v, int64_t* out) {
  uint8_t t = v.next();
  if (t <= 0x7f) { *out = t; return v.ok; }
  if (t >= 0xe0) { *out = static_cast<int8_t>(t); return v.ok; }
  switch (t) {
    case 0xcc: *out = static_cast<int64_t>(v.be(1)); return v.ok;
    case 0xcd: *out = static_cast<int64_t>(v.be(2)); return v.ok;
    case 0xce: *out = static_cast<int64_t>(v.be(4)); return v.ok;
    case 0xcf: *out = static_cast<int64_t>(v.be(8)); return v.ok;
    case 0xd0: *out = static_cast<int8_t>(v.be(1)); return v.ok;
    case 0xd1: *out = static_cast<int16_t>(v.be(2)); return v.ok;
    case 0xd2: *out = static_cast<int32_t>(v.be(4)); return v.ok;
    case 0xd3: *out = static_cast<int64_t>(v.be(8)); return v.ok;
    case 0xca: { uint32_t b = v.be(4); float f; std::memcpy(&f, &b, 4);
                 *out = static_cast<int64_t>(f); return v.ok; }
    case 0xcb: { uint64_t b = v.be(8); double d; std::memcpy(&d, &b, 8);
                 *out = static_cast<int64_t>(d); return v.ok; }
  }
  v.ok = false;
  return false;
}

size_t msg_map_len(MsgView& v) {
  uint8_t t = v.next();
  if ((t & 0xf0) == 0x80) return t & 0x0f;
  if (t == 0xde) return v.be(2);
  if (t == 0xdf) return v.be(4);
  v.ok = false;
  return 0;
}

size_t msg_array_len(MsgView& v) {
  uint8_t t = v.next();
  if ((t & 0xf0) == 0x90) return t & 0x0f;
  if (t == 0xdc) return v.be(2);
  if (t == 0xdd) return v.be(4);
  v.ok = false;
  return 0;
}

void msg_skip(MsgView& v);

void msg_skip_n(MsgView& v, size_t n) {
  for (size_t i = 0; i < n && v.ok; i++) msg_skip(v);
}

void msg_skip(MsgView& v) {
  uint8_t t = v.peek();
  if (t <= 0x7f || t >= 0xe0) { v.next(); return; }
  if ((t & 0xe0) == 0xa0) { v.next(); v.p += t & 0x1f; if (v.p > v.end) v.ok = false; return; }
  if ((t & 0xf0) == 0x80) { v.next(); msg_skip_n(v, (t & 0x0f) * 2); return; }
  if ((t & 0xf0) == 0x90) { v.next(); msg_skip_n(v, t & 0x0f); return; }
  v.next();
  switch (t) {
    case 0xc0: case 0xc2: case 0xc3: return;
    case 0xcc: case 0xd0: v.p += 1; break;
    case 0xcd: case 0xd1: v.p += 2; break;
    case 0xce: case 0xd2: case 0xca: v.p += 4; break;
    case 0xcf: case 0xd3: case 0xcb: v.p += 8; break;
    case 0xd9: v.p += v.be(1); break;
    case 0xda: v.p += v.be(2); break;
    case 0xdb: v.p += v.be(4); break;
    case 0xc4: v.p += v.be(1); break;
    case 0xc5: v.p += v.be(2); break;
    case 0xc6: v.p += v.be(4); break;
    // maps/arrays with 16/32-bit lengths (t already consumed)
    case 0xde: msg_skip_n(v, v.be(2) * 2); break;
    case 0xdf: msg_skip_n(v, v.be(4) * 2); break;
    case 0xdc: msg_skip_n(v, v.be(2)); break;
    case 0xdd: msg_skip_n(v, v.be(4)); break;
    default: v.ok = false;
  }
  if (v.p > v.end) v.ok = false;
}

// ndarray encoded as {"__nd__":1, "d":"<f4", "s":[...], "b":bytes}
struct NdArray {
  char dtype[8] = {0};       // e.g. "<f4"
  std::vector<int64_t> shape;
  const uint8_t* data = nullptr;
  size_t nbytes = 0;
  bool present() const { return data != nullptr; }
  int64_t rows() const { return shape.empty() ? 0 : shape[0]; }
  int64_t cols() const { return shape.size() > 1 ? shape[1] : 1; }
  bool is_f4() const { return std::strcmp(dtype, "<f4") == 0; }
  bool is_f8() const { return std::strcmp(dtype, "<f8") == 0; }
  float at(int64_t r, int64_t c) const {
    size_t i = static_cast<size_t>(r) * cols() + c;
    if (is_f4()) {
      float f;
      std::memcpy(&f, data + i * 4, 4);
      return f;
    }
    double d;
    std::memcpy(&d, data + i * 8, 8);
    return static_cast<float>(d);
  }
};

bool msg_read_ndarray(MsgView& v, NdArray* out) {
  size_t n = msg_map_len(v);
  bool got = false;
  for (size_t i = 0; i < n && v.ok; i++) {
    MsgStr key;
    if (!msg_read_str(v, &key)) return false;
    if (key.len == 1 && key.p[0] == 'd') {
      MsgStr d;
      if (!msg_read_str(v, &d)) return false;
      size_t c = std::min(d.len, sizeof(out->dtype) - 1);
      std::memcpy(out->dtype, d.p, c);
      out->dtype[c] = 0;
    } else if (key.len == 1 && key.p[0] == 's') {
      size_t m = msg_array_len(v);
      out->shape.clear();
      for (size_t j = 0; j < m && v.ok; j++) {
        int64_t x;
        if (!msg_read_int(v, &x)) return false;
        out->shape.push_back(x);
      }
    } else if (key.len == 1 && key.p[0] == 'b') {
      uint8_t t = v.next();
      size_t len;
      if (t == 0xc4) len = v.be(1);
      else if (t == 0xc5) len = v.be(2);
      else if (t == 0xc6) len = v.be(4);
      else { v.ok = false; return false; }
      const uint8_t* q;
      if (!v.take(len, &q)) return false;
      out->data = q;
      out->nbytes = len;
      got = true;
    } else {
      msg_skip(v);  // __nd__ marker etc.
    }
  }
  return v.ok && got;
}

struct Record {
  MsgStr item_id, title, pv;
  int64_t image_h = 0, image_w = 0, num_boxes = 0;
  NdArray boxes, features, cls_prob;
};

bool key_is(const MsgStr& k, const char* s) {
  size_t n = std::strlen(s);
  return k.len == n && std::memcmp(k.p, s, n) == 0;
}

bool msg_read_double(MsgView& v, double* out) {
  uint8_t t = v.peek();
  if (t == 0xca) {
    v.next();
    uint32_t b = static_cast<uint32_t>(v.be(4));
    float f;
    std::memcpy(&f, &b, 4);
    *out = f;
    return v.ok;
  }
  if (t == 0xcb) {
    v.next();
    uint64_t b = v.be(8);
    double d;
    std::memcpy(&d, &b, 8);
    *out = d;
    return v.ok;
  }
  int64_t x;
  if (!msg_read_int(v, &x)) return false;
  *out = static_cast<double>(x);
  return true;
}

// Parse one feature-record map from an open view (used both for top-level
// pretrain records and the nested item1/item2 maps of pair records).
bool parse_record_map(MsgView& v, Record* r) {
  size_t n = msg_map_len(v);
  for (size_t i = 0; i < n && v.ok; i++) {
    MsgStr key;
    if (!msg_read_str(v, &key)) return false;
    if (key_is(key, "item_id")) {
      if (v.peek() <= 0x7f || (v.peek() & 0xe0) == 0xa0 || v.peek() == 0xd9 ||
          v.peek() == 0xda || v.peek() == 0xdb) {
        if ((v.peek() & 0xe0) == 0xa0 || v.peek() == 0xd9 ||
            v.peek() == 0xda || v.peek() == 0xdb) {
          msg_read_str(v, &r->item_id);
        } else {
          int64_t x;  // numeric ids tolerated
          msg_read_int(v, &x);
        }
      } else {
        msg_skip(v);
      }
    } else if (key_is(key, "title")) {
      msg_read_str(v, &r->title);
    } else if (key_is(key, "pv")) {
      msg_read_str(v, &r->pv);
    } else if (key_is(key, "image_h")) {
      msg_read_int(v, &r->image_h);
    } else if (key_is(key, "image_w")) {
      msg_read_int(v, &r->image_w);
    } else if (key_is(key, "num_boxes")) {
      msg_read_int(v, &r->num_boxes);
    } else if (key_is(key, "boxes")) {
      if (v.peek() == 0xc0) { v.next(); } else msg_read_ndarray(v, &r->boxes);
    } else if (key_is(key, "features")) {
      if (v.peek() == 0xc0) { v.next(); } else msg_read_ndarray(v, &r->features);
    } else if (key_is(key, "cls_prob")) {
      if (v.peek() == 0xc0) { v.next(); } else msg_read_ndarray(v, &r->cls_prob);
    } else {
      msg_skip(v);
    }
  }
  return v.ok;
}

bool parse_record(const uint8_t* data, size_t len, Record* r) {
  MsgView v{data, data + len};
  return parse_record_map(v, r);
}

// Pair record {label, item1: {...}, item2: {...}} (prepare.py
// build_pair_records; reference pair_serialize, data_prepare.py:519-545).
struct PairRecord {
  double label = 0.0;
  Record item1, item2;
};

bool parse_pair(const uint8_t* data, size_t len, PairRecord* pr) {
  MsgView v{data, data + len};
  size_t n = msg_map_len(v);
  for (size_t i = 0; i < n && v.ok; i++) {
    MsgStr key;
    if (!msg_read_str(v, &key)) return false;
    if (key_is(key, "label")) {
      if (!msg_read_double(v, &pr->label)) return false;
    } else if (key_is(key, "item1")) {
      if (!parse_record_map(v, &pr->item1)) return false;
    } else if (key_is(key, "item2")) {
      if (!parse_record_map(v, &pr->item2)) return false;
    } else {
      msg_skip(v);
    }
  }
  return v.ok;
}

// ------------------------------------------------------------- tokenizer

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  std::vector<uint8_t> flags;          // MAX_CP
  std::vector<int32_t> troff;          // MAX_CP; -1 = identity
  std::vector<uint8_t> trlen;          // MAX_CP
  std::vector<uint32_t> trpool;
  bool do_lower = true;
  bool char_fallback = false;
  int32_t max_chars_per_word = 100;
  int32_t unk_id = 100;

  uint8_t flag(uint32_t cp) const { return cp < MAX_CP ? flags[cp] : 0; }
};

// UTF-8 decode one codepoint; advances i. Invalid bytes decode as U+FFFD
// (records are written from valid Python str, so this is belt+braces).
inline uint32_t utf8_next(const char* s, size_t len, size_t* i) {
  uint8_t b = s[*i];
  if (b < 0x80) { (*i)++; return b; }
  if ((b & 0xe0) == 0xc0 && *i + 1 < len) {
    uint32_t cp = (b & 0x1f) << 6 | (s[*i + 1] & 0x3f);
    *i += 2;
    return cp;
  }
  if ((b & 0xf0) == 0xe0 && *i + 2 < len) {
    uint32_t cp = (b & 0x0f) << 12 | (s[*i + 1] & 0x3f) << 6 | (s[*i + 2] & 0x3f);
    *i += 3;
    return cp;
  }
  if ((b & 0xf8) == 0xf0 && *i + 3 < len) {
    uint32_t cp = (b & 0x07) << 18 | (s[*i + 1] & 0x3f) << 12 |
                  (s[*i + 2] & 0x3f) << 6 | (s[*i + 3] & 0x3f);
    *i += 4;
    return cp;
  }
  (*i)++;
  return 0xFFFD;
}

inline void utf8_append(std::string* out, uint32_t cp) {
  if (cp < 0x80) {
    out->push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out->push_back(static_cast<char>(0xc0 | (cp >> 6)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3f)));
  } else if (cp < 0x10000) {
    out->push_back(static_cast<char>(0xe0 | (cp >> 12)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3f)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3f)));
  } else {
    out->push_back(static_cast<char>(0xf0 | (cp >> 18)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3f)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3f)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3f)));
  }
}

// A basic token as a codepoint sequence (post clean/lower/NFD-strip).
using CpToken = std::vector<uint32_t>;

// _clean_text + CJK spacing + split + lower/NFD + punctuation split
// (tokenization.py:_basic_tokenize), operating on codepoints throughout.
void basic_tokenize(const Tokenizer& tk, const char* text, size_t len,
                    std::vector<CpToken>* out) {
  out->clear();
  CpToken cur;
  bool in_word = false;

  auto flush = [&]() {
    if (!cur.empty()) {
      out->push_back(cur);
      cur.clear();
    }
  };

  // raw stream -> cleaned cp stream with separators
  std::vector<uint32_t> cps;
  cps.reserve(len);
  size_t i = 0;
  while (i < len) {
    uint32_t cp = utf8_next(text, len, &i);
    uint8_t f = tk.flag(cp);
    if ((f & F_DROP) || (f & F_CTRL)) continue;
    if (f & F_WS) cp = ' ';
    if (f & F_CJK) {
      cps.push_back(' ');
      cps.push_back(cp);
      cps.push_back(' ');
    } else {
      cps.push_back(cp);
    }
  }

  // split on ' ' plus residual Python-isspace survivors (Zl/Zp etc.)
  std::vector<CpToken> words;
  CpToken w;
  for (uint32_t cp : cps) {
    if (cp == ' ' || (tk.flag(cp) & F_PYSPACE)) {
      if (!w.empty()) { words.push_back(w); w.clear(); }
    } else {
      w.push_back(cp);
    }
  }
  if (!w.empty()) words.push_back(w);

  for (auto& word : words) {
    CpToken norm;
    if (tk.do_lower) {
      for (uint32_t cp : word) {
        if (cp < MAX_CP && tk.trlen[cp] != 0xFF) {
          for (uint8_t k = 0; k < tk.trlen[cp]; k++)
            norm.push_back(tk.trpool[tk.troff[cp] + k]);
        } else {
          norm.push_back(cp);
        }
      }
    } else {
      norm = word;
    }
    // split punctuation off
    cur.clear();
    for (uint32_t cp : norm) {
      if (tk.flag(cp) & F_PUNCT) {
        flush();
        out->push_back(CpToken{cp});
      } else {
        cur.push_back(cp);
      }
    }
    flush();
  }
  (void)in_word;
}

// Greedy longest-match WordPiece (tokenization.py:_wordpiece).
void wordpiece(const Tokenizer& tk, const CpToken& token,
               std::vector<int32_t>* out) {
  if (static_cast<int32_t>(token.size()) > tk.max_chars_per_word) {
    out->push_back(tk.unk_id);
    return;
  }
  // byte offsets per codepoint boundary
  std::string s;
  std::vector<size_t> bounds;
  for (uint32_t cp : token) {
    bounds.push_back(s.size());
    utf8_append(&s, cp);
  }
  bounds.push_back(s.size());
  size_t n = token.size();
  size_t start = 0;
  std::vector<int32_t> pieces;
  std::string sub;
  while (start < n) {
    size_t end = n;
    int32_t piece = -1;
    while (start < end) {
      sub.clear();
      if (start > 0) sub = "##";
      sub.append(s, bounds[start], bounds[end] - bounds[start]);
      auto it = tk.vocab.find(sub);
      if (it != tk.vocab.end()) {
        piece = it->second;
        break;
      }
      end--;
    }
    if (piece < 0) {
      if (!tk.char_fallback) {
        out->push_back(tk.unk_id);  // HF: whole token -> [UNK]
        return;
      }
      sub.assign(s, bounds[start], bounds[start + 1] - bounds[start]);
      auto it = tk.vocab.find(sub);
      pieces.push_back(it != tk.vocab.end() ? it->second : tk.unk_id);
      start++;
    } else {
      pieces.push_back(piece);
      start = end;
    }
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

void encode(const Tokenizer& tk, const char* text, size_t len,
            std::vector<int32_t>* out) {
  out->clear();
  std::vector<CpToken> basic;
  basic_tokenize(tk, text, len, &basic);
  for (const auto& t : basic) wordpiece(tk, t, out);
}

// ----------------------------------------------------------- preprocessor

constexpr int32_t PV_COLON_ID = 131;
constexpr int32_t PV_SEMI_ID = 132;

struct Prep {
  void* reader = nullptr;
  Tokenizer tk;
  int32_t max_seq_len, max_seq_len_pv, max_num_pv, max_region_len;
  int32_t v_feature_size, v_target_size;
  int32_t visual_target, visualization;
  int32_t mask_id, cls_id, sep_id;
  int32_t vocab_size;
};

struct Out {
  int32_t *input_ids, *input_mask, *segment_ids, *lm_label_ids;
  int32_t *input_ids_pv, *input_mask_pv, *segment_ids_pv, *lm_label_ids_pv;
  int32_t *index_p, *index_v;
  float *image_feat, *image_loc, *image_target;
  int32_t *image_label, *image_mask;
  float* masked_label;
  char* item_ids;  // B x 64
};

// title masking (preprocess.py:mask_word): block-draw variant — probs[i]
// is the i-th token's uniform, rand_ids[i] the pre-drawn replacement id.
void mask_word(int32_t* ids, int32_t n, const double* probs,
               const int64_t* rand_ids, int32_t mask_id, bool visualization,
               int32_t* labels) {
  for (int32_t i = 0; i < n; i++) {
    double p = probs[i];
    if (p < 0.15 && !visualization) {
      labels[i] = ids[i];
      p /= 0.15;
      if (p < 0.8) ids[i] = mask_id;
      else if (p < 0.9) ids[i] = static_cast<int32_t>(rand_ids[i]);
    } else {
      labels[i] = -1;
    }
  }
}

// deterministic pv masking (preprocess.py:mask_word_pv)
void mask_word_pv(int32_t* ids, int32_t n, int32_t mask_id, int32_t* labels) {
  std::vector<int32_t> idx131, idx132;
  for (int32_t i = 0; i < n; i++) {
    if (ids[i] == PV_COLON_ID) idx131.push_back(i);
    else if (ids[i] == PV_SEMI_ID) idx132.push_back(i);
  }
  if (idx132.size() + 1 == idx131.size()) idx132.push_back(n);
  for (int32_t i = 0; i < n; i++) labels[i] = -1;
  // Keep-the-first-pair applies only when there are 2+ ';' delimiters; a
  // lone pair IS masked (reference quirk, preprocess.py:mask_word_pv:
  // the [1:] drop is guarded by len(idx132) > 1 but the masking loop runs
  // regardless).
  size_t start = idx132.size() > 1 ? 1 : 0;
  size_t m = std::min(idx131.size(), idx132.size());
  for (size_t k = start; k < m; k++) {
    for (int32_t i = idx131[k] + 1; i < idx132[k] && i < n; i++) {
      labels[i] = ids[i];
      ids[i] = mask_id;
    }
  }
}

// pv span extraction (preprocess.py:index_pv) over final (CLS/SEP) ids
void index_pv(const int32_t* ids, int32_t n, int32_t max_num_pv,
              int32_t* out_p, int32_t* out_v) {
  std::vector<int32_t> idx131, idx132;
  for (int32_t i = 0; i < n; i++) {
    if (ids[i] == PV_COLON_ID) idx131.push_back(i);
    else if (ids[i] == PV_SEMI_ID) idx132.push_back(i);
  }
  if (idx132.size() == idx131.size()) {
  } else if (idx132.size() + 1 == idx131.size()) {
    idx131.pop_back();
  } else {
    idx131.clear();
    idx132.clear();
  }
  std::memset(out_p, 0, sizeof(int32_t) * max_num_pv * 2);
  std::memset(out_v, 0, sizeof(int32_t) * max_num_pv * 2);
  int32_t pv_begin = 1, k = 0;
  size_t m = std::min(idx131.size(), idx132.size());
  for (size_t j = 0; j < m && k < max_num_pv; j++, k++) {
    out_p[k * 2] = pv_begin;
    out_p[k * 2 + 1] = idx131[j];
    out_v[k * 2] = idx131[j] + 1;
    out_v[k * 2 + 1] = idx132[j];
    pv_begin = idx132[j] + 1;
  }
}

// Shared image path (preprocess.py:image_processing): zero-box fallback,
// clamp to max_region_len, feature/target/location fill, mask-row fill —
// used by both the pretrain sample (which then masks RoIs) and the
// alignment pair item (which does not). Fills boxes_out (float32, post
// asarray cast) for the caller's IoU and returns the clamped num_boxes
// (always >= 1) or a negative error code.
int image_process(const Prep& P, const Record& r, float* feat, float* loc,
                  float* target, int32_t* img_mask,
                  std::vector<float>* boxes_out) {
  const int32_t R = P.max_region_len, D = P.v_feature_size;
  const int32_t T = P.v_target_size;

  double image_h = static_cast<double>(r.image_h);
  double image_w = static_cast<double>(r.image_w);
  int32_t num_boxes = static_cast<int32_t>(r.num_boxes);
  float fallback_box[4] = {0.1f, 0.1f, 799.9f, 799.9f};
  bool fallback = false;
  if (num_boxes <= 0) {  // zero-box fallback (preprocess.py:172-177)
    image_h = image_w = 800.0;
    num_boxes = 1;
    fallback = true;
  }
  num_boxes = std::min(num_boxes, R);
  if (!fallback) {
    if (!r.boxes.present() || !r.features.present()) return -12;
    if (!(r.boxes.is_f4() || r.boxes.is_f8())) return -13;
    if (!(r.features.is_f4() || r.features.is_f8())) return -13;
    if (r.boxes.rows() < num_boxes || r.features.rows() < num_boxes ||
        r.features.cols() != D)
      return -14;
  }

  // boxes (float32, post asarray cast) for IoU + loc
  std::vector<float>& boxes = *boxes_out;
  boxes.resize(static_cast<size_t>(num_boxes) * 4);
  for (int32_t i = 0; i < num_boxes; i++) {
    for (int32_t c = 0; c < 4; c++)
      boxes[i * 4 + c] = fallback ? fallback_box[c] : r.boxes.at(i, c);
  }

  // feat rows 1..R (row 0 = global token, filled by caller); padding zero
  std::memset(feat, 0, sizeof(float) * (R + 1) * D);
  if (!fallback) {
    if (r.features.is_f4()) {
      std::memcpy(feat + D, r.features.data,
                  sizeof(float) * num_boxes * D);
    } else {
      for (int32_t i = 0; i < num_boxes; i++)
        for (int32_t c = 0; c < D; c++)
          feat[(i + 1) * D + c] = r.features.at(i, c);
    }
  }

  // target (pre-masking copy semantics, preprocess.py:186-197)
  std::memset(target, 0, sizeof(float) * R * T);
  if (P.visual_target == 0) {
    if (!fallback && r.cls_prob.present()) {
      int64_t src_cols = r.cls_prob.cols();
      int64_t c_copy = std::min<int64_t>(src_cols, T);
      if (r.cls_prob.rows() < num_boxes) return -15;
      for (int32_t i = 0; i < num_boxes; i++) {
        if (r.cls_prob.is_f4()) {
          std::memcpy(target + static_cast<size_t>(i) * T,
                      r.cls_prob.data + static_cast<size_t>(i) * src_cols * 4,
                      sizeof(float) * c_copy);
        } else {
          for (int64_t c = 0; c < c_copy; c++)
            target[static_cast<size_t>(i) * T + c] = r.cls_prob.at(i, c);
        }
      }
    }
  } else {
    // target = feat.copy() BEFORE masking; T must equal D
    if (T != D) return -16;
    std::memcpy(target, feat + D, sizeof(float) * R * D);
  }

  // loc rows 1..R (row 0 global [0,0,1,1,1]). All arithmetic in float32
  // with the scalar divisors pre-cast, matching numpy's
  // `f32_array / float(w)` promotion so the two paths round identically.
  std::memset(loc, 0, sizeof(float) * (R + 1) * 5);
  loc[0] = 0; loc[1] = 0; loc[2] = 1; loc[3] = 1; loc[4] = 1;
  const float fw = static_cast<float>(image_w);
  const float fh = static_cast<float>(image_h);
  const float fwh = static_cast<float>(image_w * image_h);
  for (int32_t i = 0; i < R; i++) {
    float* l = loc + (i + 1) * 5;
    if (i < num_boxes) {
      l[0] = boxes[i * 4] / fw;
      l[1] = boxes[i * 4 + 1] / fh;
      l[2] = boxes[i * 4 + 2] / fw;
      l[3] = boxes[i * 4 + 3] / fh;
      l[4] = (boxes[i * 4 + 3] - boxes[i * 4 + 1]) *
             (boxes[i * 4 + 2] - boxes[i * 4]) / fwh;
    } else {
      // python computes loc[:,4] over zero rows too: (0-0)*(0-0)/(w*h)=0
      l[4] = 0.0f;
    }
  }

  img_mask[0] = 1;
  for (int32_t i = 0; i < R; i++) img_mask[i + 1] = i < num_boxes ? 1 : 0;
  return num_boxes;
}

// [CLS] ids[:max_len-2] [SEP] + zero-pad, mask/segment rows
// (preprocess.py:_pad_text + add_special_tokens_single_sentence).
// Returns the unpadded token count n (ids occupy positions 0..n+1).
int32_t fill_text(const Prep& P, const std::vector<int32_t>& ids,
                  int32_t max_len, int32_t* out_ids, int32_t* out_mask,
                  int32_t* out_seg) {
  int32_t n = std::min<int32_t>(ids.size(), max_len - 2);
  out_ids[0] = P.cls_id;
  for (int32_t i = 0; i < n; i++) out_ids[i + 1] = ids[i];
  out_ids[n + 1] = P.sep_id;
  for (int32_t i = 0; i < max_len; i++) {
    out_mask[i] = i < n + 2 ? 1 : 0;
    out_seg[i] = 0;
    if (i >= n + 2) out_ids[i] = 0;
  }
  return n;
}

int process_one(const Prep& P, int64_t rec_index, int32_t b,
                const double* probs_w, const int64_t* rand_w,
                const double* probs_r, const Out& o) {
  const uint8_t* payload;
  int64_t len = k3mr_record(P.reader, rec_index, &payload);
  if (len < 0) return -10;
  Record r;
  if (!parse_record(payload, len, &r)) return -11;

  const int32_t L = P.max_seq_len, Lpv = P.max_seq_len_pv;
  const int32_t R = P.max_region_len, D = P.v_feature_size;
  const int32_t NP = P.max_num_pv;

  // ------------------------------------------------------------- image
  float* feat = o.image_feat + static_cast<size_t>(b) * (R + 1) * D;
  float* loc = o.image_loc + static_cast<size_t>(b) * (R + 1) * 5;
  float* target = o.image_target + static_cast<size_t>(b) * R * P.v_target_size;
  int32_t* img_label = o.image_label + static_cast<size_t>(b) * R;
  int32_t* img_mask = o.image_mask + static_cast<size_t>(b) * (R + 1);
  float* masked_label = o.masked_label + static_cast<size_t>(b) * R;

  std::vector<float> boxes;
  int32_t num_boxes = image_process(P, r, feat, loc, target, img_mask, &boxes);
  if (num_boxes < 0) return num_boxes;

  // overlaps IoU (+1 pixel convention, preprocess.py:box_iou)
  std::vector<float> overlaps(static_cast<size_t>(num_boxes) * num_boxes);
  for (int32_t i = 0; i < num_boxes; i++) {
    float ax1 = boxes[i * 4], ay1 = boxes[i * 4 + 1];
    float ax2 = boxes[i * 4 + 2], ay2 = boxes[i * 4 + 3];
    float area_a = (ax2 - ax1 + 1) * (ay2 - ay1 + 1);
    for (int32_t j = 0; j < num_boxes; j++) {
      float bx1 = boxes[j * 4], by1 = boxes[j * 4 + 1];
      float bx2 = boxes[j * 4 + 2], by2 = boxes[j * 4 + 3];
      float area_b = (bx2 - bx1 + 1) * (by2 - by1 + 1);
      float iw = std::min(ax2, bx2) - std::max(ax1, bx1) + 1;
      float ih = std::min(ay2, by2) - std::max(ay1, by1) + 1;
      iw = std::max(iw, 0.0f);
      ih = std::max(ih, 0.0f);
      overlaps[i * num_boxes + j] = iw * ih / (area_a + area_b - iw * ih);
    }
  }

  // RoI masking (preprocess.py:mask_region)
  for (int32_t i = 0; i < R; i++) masked_label[i] = 0.0f;
  for (int32_t i = 0; i < R; i++) img_label[i] = -1;
  for (int32_t i = 0; i < num_boxes; i++) {
    double p = probs_r[i];
    if (p < 0.15 && !P.visualization) {
      p /= 0.15;
      if (p < 0.9) std::memset(feat + (i + 1) * D, 0, sizeof(float) * D);
      for (int32_t j = 0; j < num_boxes; j++) {
        if (overlaps[i * num_boxes + j] > 0.4f) masked_label[j] = 1.0f;
      }
      img_label[i] = 1;
    } else {
      img_label[i] = -1;
    }
  }

  // global image token: sum(rows)/count(masked_label==0), min 1
  int32_t cnt = 0;
  for (int32_t i = 0; i < R; i++)
    if (masked_label[i] == 0.0f) cnt++;
  if (cnt == 0) cnt = 1;
  for (int32_t c = 0; c < D; c++) {
    float s = 0.0f;
    for (int32_t i = 1; i <= R; i++) s += feat[i * D + c];
    feat[c] = s / cnt;
  }

  // -------------------------------------------------------------- text
  std::vector<int32_t> ids;
  encode(P.tk, r.title.p ? r.title.p : "", r.title.len, &ids);
  int32_t n_t = std::min<int32_t>(ids.size(), L - 2);
  std::vector<int32_t> lbl(n_t);
  mask_word(ids.data(), n_t, probs_w, rand_w, P.mask_id,
            P.visualization != 0, lbl.data());

  int32_t* t_lbl = o.lm_label_ids + static_cast<size_t>(b) * L;
  ids.resize(n_t);
  fill_text(P, ids, L, o.input_ids + static_cast<size_t>(b) * L,
            o.input_mask + static_cast<size_t>(b) * L,
            o.segment_ids + static_cast<size_t>(b) * L);
  for (int32_t i = 0; i < L; i++) t_lbl[i] = -1;
  for (int32_t i = 0; i < n_t; i++) t_lbl[i + 1] = lbl[i];

  std::vector<int32_t> ids_pv;
  encode(P.tk, r.pv.p ? r.pv.p : "", r.pv.len, &ids_pv);
  int32_t n_pv = std::min<int32_t>(ids_pv.size(), Lpv - 2);
  std::vector<int32_t> lbl_pv(n_pv);
  mask_word_pv(ids_pv.data(), n_pv, P.mask_id, lbl_pv.data());

  int32_t* p_ids = o.input_ids_pv + static_cast<size_t>(b) * Lpv;
  int32_t* p_lbl = o.lm_label_ids_pv + static_cast<size_t>(b) * Lpv;
  ids_pv.resize(n_pv);
  fill_text(P, ids_pv, Lpv, p_ids,
            o.input_mask_pv + static_cast<size_t>(b) * Lpv,
            o.segment_ids_pv + static_cast<size_t>(b) * Lpv);
  for (int32_t i = 0; i < Lpv; i++) p_lbl[i] = -1;
  for (int32_t i = 0; i < n_pv; i++) p_lbl[i + 1] = lbl_pv[i];

  index_pv(p_ids, n_pv + 2, NP,
           o.index_p + static_cast<size_t>(b) * NP * 2,
           o.index_v + static_cast<size_t>(b) * NP * 2);

  // item_id
  char* iid = o.item_ids + static_cast<size_t>(b) * 64;
  std::memset(iid, 0, 64);
  if (r.item_id.p) {
    size_t c = std::min<size_t>(r.item_id.len, 63);
    std::memcpy(iid, r.item_id.p, c);
  }
  return 0;
}

// One item's slot pointers inside a collated alignment batch.
struct PairItemOut {
  int32_t *input_ids, *input_mask, *segment_ids;
  int32_t *input_ids_pv, *input_mask_pv, *segment_ids_pv;
  int32_t *index_p, *index_v;
  float *image_feat, *image_loc, *image_target;
  int32_t* image_mask;
  char* item_ids;  // B x 64
};

// One alignment item: image (no RoI masking, global token divides by
// num_boxes), unmasked title/pv text, pv span indexing
// (preprocess.py:PairPreprocessor._one + _collate_alignment_item;
// ref K3MPreprocessBatch concept_cap_dataset_struc.py:936-1263 and the
// num_boxes-divide post_process :272-294).
int process_pair_item(const Prep& P, const Record& r, int32_t b,
                      const PairItemOut& o) {
  const int32_t L = P.max_seq_len, Lpv = P.max_seq_len_pv;
  const int32_t R = P.max_region_len, D = P.v_feature_size;
  const int32_t NP = P.max_num_pv;

  float* feat = o.image_feat + static_cast<size_t>(b) * (R + 1) * D;
  float* loc = o.image_loc + static_cast<size_t>(b) * (R + 1) * 5;
  float* target = o.image_target + static_cast<size_t>(b) * R * P.v_target_size;
  int32_t* img_mask = o.image_mask + static_cast<size_t>(b) * (R + 1);

  std::vector<float> boxes;
  int32_t num_boxes = image_process(P, r, feat, loc, target, img_mask, &boxes);
  if (num_boxes < 0) return num_boxes;

  // global image token: sum(rows) / float32(num_boxes)
  const float divisor = static_cast<float>(num_boxes);
  for (int32_t c = 0; c < D; c++) {
    float s = 0.0f;
    for (int32_t i = 1; i <= R; i++) s += feat[i * D + c];
    feat[c] = s / divisor;
  }

  std::vector<int32_t> ids;
  encode(P.tk, r.title.p ? r.title.p : "", r.title.len, &ids);
  if (static_cast<int32_t>(ids.size()) > L - 2) ids.resize(L - 2);
  fill_text(P, ids, L, o.input_ids + static_cast<size_t>(b) * L,
            o.input_mask + static_cast<size_t>(b) * L,
            o.segment_ids + static_cast<size_t>(b) * L);

  std::vector<int32_t> ids_pv;
  encode(P.tk, r.pv.p ? r.pv.p : "", r.pv.len, &ids_pv);
  if (static_cast<int32_t>(ids_pv.size()) > Lpv - 2) ids_pv.resize(Lpv - 2);
  int32_t* p_ids = o.input_ids_pv + static_cast<size_t>(b) * Lpv;
  int32_t n_pv = fill_text(P, ids_pv, Lpv, p_ids,
                           o.input_mask_pv + static_cast<size_t>(b) * Lpv,
                           o.segment_ids_pv + static_cast<size_t>(b) * Lpv);

  index_pv(p_ids, n_pv + 2, NP,
           o.index_p + static_cast<size_t>(b) * NP * 2,
           o.index_v + static_cast<size_t>(b) * NP * 2);

  char* iid = o.item_ids + static_cast<size_t>(b) * 64;
  std::memset(iid, 0, 64);
  if (r.item_id.p) {
    size_t c = std::min<size_t>(r.item_id.len, 63);
    std::memcpy(iid, r.item_id.p, c);
  }
  return 0;
}

int process_pair_one(const Prep& P, int64_t rec_index, int32_t b,
                     float* label, const PairItemOut& o1,
                     const PairItemOut& o2) {
  const uint8_t* payload;
  int64_t len = k3mr_record(P.reader, rec_index, &payload);
  if (len < 0) return -10;
  PairRecord pr;
  if (!parse_pair(payload, len, &pr)) return -11;
  label[b] = static_cast<float>(pr.label);
  int rc = process_pair_item(P, pr.item1, b, o1);
  if (rc != 0) return rc;
  return process_pair_item(P, pr.item2, b, o2);
}

}  // namespace

extern "C" {

void* k3mprep_create(const char* record_path, const char* vocab,
                     int64_t vocab_len, const uint8_t* flags,
                     int64_t flags_len, const int32_t* troff,
                     const uint8_t* trlen, const uint32_t* trpool,
                     int64_t trpool_len, int32_t do_lower,
                     int32_t char_fallback, int32_t max_seq_len,
                     int32_t max_seq_len_pv, int32_t max_num_pv,
                     int32_t max_region_len, int32_t v_feature_size,
                     int32_t v_target_size, int32_t visual_target,
                     int32_t visualization, int32_t mask_id, int32_t unk_id,
                     int32_t cls_id, int32_t sep_id,
                     int32_t max_chars_per_word) {
  if (flags_len != MAX_CP) return nullptr;
  void* reader = k3mr_open(record_path);
  if (!reader) return nullptr;
  Prep* p = new Prep();
  p->reader = reader;
  // vocab: '\n'-joined token list, id = line index
  {
    const char* s = vocab;
    const char* end = vocab + vocab_len;
    int32_t id = 0;
    while (s < end) {
      const char* nl = static_cast<const char*>(memchr(s, '\n', end - s));
      size_t n = nl ? static_cast<size_t>(nl - s) : static_cast<size_t>(end - s);
      p->tk.vocab.emplace(std::string(s, n), id++);
      s += n + 1;
    }
    p->vocab_size = id;
  }
  p->tk.flags.assign(flags, flags + MAX_CP);
  p->tk.troff.assign(troff, troff + MAX_CP);
  p->tk.trlen.assign(trlen, trlen + MAX_CP);
  p->tk.trpool.assign(trpool, trpool + trpool_len);
  p->tk.do_lower = do_lower != 0;
  p->tk.char_fallback = char_fallback != 0;
  p->tk.max_chars_per_word = max_chars_per_word;
  p->tk.unk_id = unk_id;
  p->max_seq_len = max_seq_len;
  p->max_seq_len_pv = max_seq_len_pv;
  p->max_num_pv = max_num_pv;
  p->max_region_len = max_region_len;
  p->v_feature_size = v_feature_size;
  p->v_target_size = v_target_size;
  p->visual_target = visual_target;
  p->visualization = visualization;
  p->mask_id = mask_id;
  p->cls_id = cls_id;
  p->sep_id = sep_id;
  return p;
}

int64_t k3mprep_len(void* h) {
  if (!h) return -1;
  return k3mr_count(static_cast<Prep*>(h)->reader);
}

// Tokenize-only entry for parity tests: returns n ids (or -1 - needed if
// cap too small; negative-and-large means error).
int32_t k3mprep_encode(void* h, const char* text, int64_t text_len,
                       int32_t* out, int32_t cap) {
  if (!h) return -1000;
  Prep* p = static_cast<Prep*>(h);
  std::vector<int32_t> ids;
  encode(p->tk, text, text_len, &ids);
  if (static_cast<int32_t>(ids.size()) > cap)
    return -1 - static_cast<int32_t>(ids.size());
  std::memcpy(out, ids.data(), ids.size() * sizeof(int32_t));
  return static_cast<int32_t>(ids.size());
}

int32_t k3mprep_pretrain_batch(
    void* h, const int64_t* indices, int32_t B, const double* probs_w,
    const int64_t* rand_w, const double* probs_r, int32_t* input_ids,
    int32_t* input_mask, int32_t* segment_ids, int32_t* lm_label_ids,
    int32_t* input_ids_pv, int32_t* input_mask_pv, int32_t* segment_ids_pv,
    int32_t* lm_label_ids_pv, int32_t* index_p, int32_t* index_v,
    float* image_feat, float* image_loc, float* image_target,
    int32_t* image_label, int32_t* image_mask, float* masked_label,
    char* item_ids, int32_t n_threads) {
  if (!h) return -1;
  Prep* P = static_cast<Prep*>(h);
  Out o{input_ids, input_mask, segment_ids, lm_label_ids,
        input_ids_pv, input_mask_pv, segment_ids_pv, lm_label_ids_pv,
        index_p, index_v, image_feat, image_loc, image_target,
        image_label, image_mask, masked_label, item_ids};
  const int32_t W = P->max_seq_len - 2;
  const int32_t R = P->max_region_len;
  std::atomic<int32_t> rc{0};
  auto run = [&](int32_t lo, int32_t hi) {
    for (int32_t b = lo; b < hi; b++) {
      int r = process_one(*P, indices[b], b, probs_w + static_cast<size_t>(b) * W,
                          rand_w + static_cast<size_t>(b) * W,
                          probs_r + static_cast<size_t>(b) * R, o);
      if (r != 0) rc.store(r);
    }
  };
  if (n_threads <= 1 || B <= 1) {
    run(0, B);
  } else {
    int32_t nt = std::min(n_threads, B);
    std::vector<std::thread> ts;
    int32_t per = (B + nt - 1) / nt;
    for (int32_t t = 0; t < nt; t++) {
      int32_t lo = t * per, hi = std::min(B, lo + per);
      if (lo < hi) ts.emplace_back(run, lo, hi);
    }
    for (auto& t : ts) t.join();
  }
  return rc.load();
}

// Alignment pair batch: indices -> collated twin-item batch. `it1`/`it2`
// each receive 13 output pointers in PairItemOut order.
int32_t k3mprep_pair_batch(
    void* h, const int64_t* indices, int32_t B, float* label,
    int32_t* i1_input_ids, int32_t* i1_input_mask, int32_t* i1_segment_ids,
    int32_t* i1_input_ids_pv, int32_t* i1_input_mask_pv,
    int32_t* i1_segment_ids_pv, int32_t* i1_index_p, int32_t* i1_index_v,
    float* i1_image_feat, float* i1_image_loc, float* i1_image_target,
    int32_t* i1_image_mask, char* i1_item_ids,
    int32_t* i2_input_ids, int32_t* i2_input_mask, int32_t* i2_segment_ids,
    int32_t* i2_input_ids_pv, int32_t* i2_input_mask_pv,
    int32_t* i2_segment_ids_pv, int32_t* i2_index_p, int32_t* i2_index_v,
    float* i2_image_feat, float* i2_image_loc, float* i2_image_target,
    int32_t* i2_image_mask, char* i2_item_ids, int32_t n_threads) {
  if (!h) return -1;
  Prep* P = static_cast<Prep*>(h);
  PairItemOut o1{i1_input_ids, i1_input_mask, i1_segment_ids,
                 i1_input_ids_pv, i1_input_mask_pv, i1_segment_ids_pv,
                 i1_index_p, i1_index_v, i1_image_feat, i1_image_loc,
                 i1_image_target, i1_image_mask, i1_item_ids};
  PairItemOut o2{i2_input_ids, i2_input_mask, i2_segment_ids,
                 i2_input_ids_pv, i2_input_mask_pv, i2_segment_ids_pv,
                 i2_index_p, i2_index_v, i2_image_feat, i2_image_loc,
                 i2_image_target, i2_image_mask, i2_item_ids};
  std::atomic<int32_t> rc{0};
  auto run = [&](int32_t lo, int32_t hi) {
    for (int32_t b = lo; b < hi; b++) {
      int r = process_pair_one(*P, indices[b], b, label, o1, o2);
      if (r != 0) rc.store(r);
    }
  };
  if (n_threads <= 1 || B <= 1) {
    run(0, B);
  } else {
    int32_t nt = std::min(n_threads, B);
    std::vector<std::thread> ts;
    int32_t per = (B + nt - 1) / nt;
    for (int32_t t = 0; t < nt; t++) {
      int32_t lo = t * per, hi = std::min(B, lo + per);
      if (lo < hi) ts.emplace_back(run, lo, hi);
    }
    for (auto& t : ts) t.join();
  }
  return rc.load();
}

void k3mprep_destroy(void* h) {
  if (!h) return;
  Prep* p = static_cast<Prep*>(h);
  k3mr_close(p->reader);
  delete p;
}

}  // extern "C"
