// FasterTokenizer host op: C++ wordpiece tokenization.
//
// Reference: the in-graph tokenizer op family
// (paddle/fluid/operators/string/faster_tokenizer_op.h — BertTokenizer =
// BasicTokenizer (clean / lowercase / punctuation & CJK isolation) followed by
// greedy-longest-match WordPiece). Tokenization is host compute on any
// accelerator, so on TPU it stays a native C++ component in front of the
// device program; the Python layer (paddle_tpu/text/faster_tokenizer.py) adds
// [CLS]/[SEP], pair encoding, truncation and padding.
//
// Unicode handling: UTF-8 is decoded to codepoints; ASCII is lowercased,
// Latin-1 letters are lowercased + accent-folded to their base ASCII letter,
// CJK ideographs and punctuation are isolated as single-codepoint tokens.
// (The reference relies on full ICU normalization; this table-driven fold
// covers the Latin-1 range that dominates the reference's test corpora.)
//
// C ABI (ctypes):
//   void* tk_create(const char* vocab_blob, long n, int do_lower)
//       vocab_blob: "token\n" lines (id = line index) or "token\tid\n" lines
//       (explicit ids, for vocabularies with gaps / non-contiguous ids)
//   long  tk_vocab_id(void* h, const char* token)   // -1 when absent
//   long  tk_tokenize(void* h, const char* text, long* out, long max_out)
//   void  tk_destroy(void* h)

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, long> vocab;
  bool do_lower = true;
  long unk = -1;
  size_t max_chars_per_word = 100;  // reference kMaxInputCharsPerWord
};

// ---- utf8 ----
struct Cp {
  uint32_t v;
  int len;
};

Cp decode(const unsigned char* s, size_t i, size_t n) {
  unsigned char c = s[i];
  if (c < 0x80) return {c, 1};
  if ((c >> 5) == 0x6 && i + 1 < n) return {uint32_t((c & 0x1F) << 6 | (s[i + 1] & 0x3F)), 2};
  if ((c >> 4) == 0xE && i + 2 < n)
    return {uint32_t((c & 0x0F) << 12 | (s[i + 1] & 0x3F) << 6 | (s[i + 2] & 0x3F)), 3};
  if ((c >> 3) == 0x1E && i + 3 < n)
    return {uint32_t((c & 0x07) << 18 | (s[i + 1] & 0x3F) << 12 | (s[i + 2] & 0x3F) << 6 |
                     (s[i + 3] & 0x3F)),
            4};
  return {0xFFFD, 1};
}

void encode(uint32_t cp, std::string* out) {
  if (cp < 0x80) {
    out->push_back(char(cp));
  } else if (cp < 0x800) {
    out->push_back(char(0xC0 | (cp >> 6)));
    out->push_back(char(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out->push_back(char(0xE0 | (cp >> 12)));
    out->push_back(char(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(char(0x80 | (cp & 0x3F)));
  } else {
    out->push_back(char(0xF0 | (cp >> 18)));
    out->push_back(char(0x80 | ((cp >> 12) & 0x3F)));
    out->push_back(char(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(char(0x80 | (cp & 0x3F)));
  }
}

bool is_ws(uint32_t c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == 0xA0 || c == 0x2028 ||
         (c >= 0x2000 && c <= 0x200A) || c == 0x3000;
}

bool is_control(uint32_t c) {
  if (c == '\t' || c == '\n' || c == '\r') return false;
  return c < 0x20 || c == 0x7F || (c >= 0x80 && c <= 0x9F) || c == 0xFFFD || c == 0;
}

bool is_cjk(uint32_t c) {
  return (c >= 0x4E00 && c <= 0x9FFF) || (c >= 0x3400 && c <= 0x4DBF) ||
         (c >= 0xF900 && c <= 0xFAFF) || (c >= 0x20000 && c <= 0x2A6DF) ||
         (c >= 0x2A700 && c <= 0x2CEAF) || (c >= 0x2F800 && c <= 0x2FA1F);
}

bool is_punct(uint32_t c) {
  if ((c >= 33 && c <= 47) || (c >= 58 && c <= 64) || (c >= 91 && c <= 96) ||
      (c >= 123 && c <= 126))
    return true;
  return (c >= 0x2010 && c <= 0x2027) || (c >= 0x3001 && c <= 0x303F) ||
         (c >= 0xFF01 && c <= 0xFF0F) || (c >= 0xFF1A && c <= 0xFF20) ||
         (c >= 0xFF3B && c <= 0xFF40) || (c >= 0xFF5B && c <= 0xFF65);
}

// Latin-1 + Latin-Extended-A lowercase/accent fold to base ASCII letter.
uint32_t fold(uint32_t c, bool lower) {
  if (lower && c >= 'A' && c <= 'Z') return c + 32;
  if (c < 0xC0) return c;
  if (!lower) return c;
  if (c >= 0xC0 && c <= 0xDE && c != 0xD7) c += 0x20;  // À..Þ -> à..þ
  static const struct {
    uint32_t lo, hi;
    char base;
  } folds[] = {{0xE0, 0xE5, 'a'}, {0xE7, 0xE7, 'c'}, {0xE8, 0xEB, 'e'}, {0xEC, 0xEF, 'i'},
               {0xF1, 0xF1, 'n'}, {0xF2, 0xF6, 'o'}, {0xF9, 0xFC, 'u'}, {0xFD, 0xFD, 'y'},
               {0xFF, 0xFF, 'y'}};
  for (auto& f : folds)
    if (c >= f.lo && c <= f.hi) return uint32_t(f.base);
  return c;
}

std::vector<std::string> basic_tokenize(const Tokenizer& tk, const char* text) {
  const unsigned char* s = reinterpret_cast<const unsigned char*>(text);
  size_t n = std::strlen(text);
  std::vector<std::string> words;
  std::string cur;
  auto flush = [&]() {
    if (!cur.empty()) {
      words.push_back(cur);
      cur.clear();
    }
  };
  for (size_t i = 0; i < n;) {
    Cp cp = decode(s, i, n);
    i += cp.len;
    uint32_t c = fold(cp.v, tk.do_lower);
    if (is_control(c)) continue;
    if (is_ws(c)) {
      flush();
    } else if (is_cjk(c) || is_punct(c)) {
      flush();
      std::string one;
      encode(c, &one);
      words.push_back(one);
    } else {
      encode(c, &cur);
    }
  }
  flush();
  return words;
}

void wordpiece(const Tokenizer& tk, const std::string& word, std::vector<long>* out) {
  // greedy longest-match-first over codepoint boundaries
  std::vector<size_t> bounds;  // byte offsets of codepoint starts + end
  const unsigned char* s = reinterpret_cast<const unsigned char*>(word.data());
  for (size_t i = 0; i < word.size();) {
    bounds.push_back(i);
    i += decode(s, i, word.size()).len;
  }
  bounds.push_back(word.size());
  size_t ncp = bounds.size() - 1;
  if (ncp > tk.max_chars_per_word) {
    out->push_back(tk.unk);
    return;
  }
  std::vector<long> pieces;
  size_t start = 0;
  while (start < ncp) {
    long id = -1;
    size_t end = ncp;
    for (; end > start; --end) {
      std::string sub = word.substr(bounds[start], bounds[end] - bounds[start]);
      if (start > 0) sub = "##" + sub;
      auto it = tk.vocab.find(sub);
      if (it != tk.vocab.end()) {
        id = it->second;
        break;
      }
    }
    if (id < 0) {  // no piece matched: whole word -> unk (reference behavior)
      out->push_back(tk.unk);
      return;
    }
    pieces.push_back(id);
    start = end;
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

void* tk_create(const char* vocab_blob, long n, int do_lower) {
  auto* tk = new Tokenizer();
  tk->do_lower = do_lower != 0;
  long id = 0;
  const char* p = vocab_blob;
  const char* end = vocab_blob + n;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    size_t len = nl ? size_t(nl - p) : size_t(end - p);
    if (len) {
      const char* tab = static_cast<const char*>(memchr(p, '\t', len));
      if (tab) {  // "token\tid": caller-assigned id
        tk->vocab.emplace(std::string(p, tab - p), atol(tab + 1));
      } else {
        tk->vocab.emplace(std::string(p, len), id);
      }
    }
    ++id;
    p = nl ? nl + 1 : end;
  }
  auto it = tk->vocab.find("[UNK]");
  tk->unk = it == tk->vocab.end() ? 0 : it->second;
  return tk;
}

long tk_vocab_id(void* h, const char* token) {
  auto* tk = static_cast<Tokenizer*>(h);
  auto it = tk->vocab.find(token);
  return it == tk->vocab.end() ? -1 : it->second;
}

long tk_tokenize(void* h, const char* text, long* out, long max_out) {
  auto* tk = static_cast<Tokenizer*>(h);
  std::vector<long> ids;
  for (const auto& w : basic_tokenize(*tk, text)) wordpiece(*tk, w, &ids);
  long n = long(ids.size()) < max_out ? long(ids.size()) : max_out;
  for (long i = 0; i < n; ++i) out[i] = ids[i];
  return long(ids.size());
}

void tk_destroy(void* h) { delete static_cast<Tokenizer*>(h); }

}  // extern "C"
