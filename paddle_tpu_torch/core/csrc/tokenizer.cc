// Native BERT tokenizer of the port (its own copy of the reference's
// tokenizer.cc, with the same ptk_* C ABI): the reference's
// faster_tokenizer_op (paddle/fluid/operators/string/faster_tokenizer_op.cc)
// role: tokenization is host-side string work, native for throughput on the
// feed path.
//
// Pipeline (BasicTokenizer + WordPiece):
//   1. UTF-8 iterate; drop control chars and U+FFFD; whitespace → ' '
//   2. optional ASCII lowercase
//   3. CJK ideographs get surrounding spaces (char-level tokens)
//   4. split on whitespace, then split punctuation into single tokens
//   5. WordPiece: greedy longest-match-first, continuations "##x", [UNK]
//      when nothing matches or the word exceeds 100 bytes
//
// Whitespace is ' ' \t \n \r only; the Python twin in
// paddle_tpu_torch/text/faster_tokenizer.py splits on every str.isspace()
// code point, so the two differ on Unicode spaces (U+3000, U+2003, U+00A0,
// U+0085), as the reference's two backends do. Each keeps its rule.
//
// C ABI (ptk_*) consumed via ctypes; ids written into caller buffers.
#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int64_t> vocab;
  bool lower = true;
  int64_t unk = 0;
};

inline bool is_ws(uint32_t c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

inline bool is_control(uint32_t c) {
  if (c == '\t' || c == '\n' || c == '\r') return false;
  return c < 0x20 || c == 0x7f;
}

inline bool is_cjk(uint32_t c) {
  return (c >= 0x4E00 && c <= 0x9FFF) || (c >= 0x3400 && c <= 0x4DBF) ||
         (c >= 0x20000 && c <= 0x2A6DF) || (c >= 0x2A700 && c <= 0x2B73F) ||
         (c >= 0x2B740 && c <= 0x2B81F) || (c >= 0x2B820 && c <= 0x2CEAF) ||
         (c >= 0xF900 && c <= 0xFAFF) || (c >= 0x2F800 && c <= 0x2FA1F);
}

inline bool is_punct(uint32_t c) {
  // ASCII punctuation ranges (BERT treats them all as split points) plus
  // general unicode punctuation blocks
  if ((c >= 33 && c <= 47) || (c >= 58 && c <= 64) || (c >= 91 && c <= 96) ||
      (c >= 123 && c <= 126))
    return true;
  return (c >= 0x2000 && c <= 0x206F) || (c >= 0x3000 && c <= 0x303F) ||
         (c >= 0xFF00 && c <= 0xFF0F) || (c >= 0xFF1A && c <= 0xFF20) ||
         (c >= 0xFF3B && c <= 0xFF40) || (c >= 0xFF5B && c <= 0xFF65);
}

// decode one UTF-8 code point at s[i]; advances i
inline uint32_t next_cp(const std::string& s, size_t& i) {
  unsigned char b = s[i];
  uint32_t cp = 0;
  int extra = 0;
  if (b < 0x80) {
    cp = b;
  } else if ((b >> 5) == 0x6) {
    cp = b & 0x1F; extra = 1;
  } else if ((b >> 4) == 0xE) {
    cp = b & 0x0F; extra = 2;
  } else if ((b >> 3) == 0x1E) {
    cp = b & 0x07; extra = 3;
  } else {
    ++i;
    return 0xFFFD;
  }
  size_t start = i++;
  for (int k = 0; k < extra; ++k) {
    if (i >= s.size() || (static_cast<unsigned char>(s[i]) >> 6) != 0x2) {
      i = start + 1;
      return 0xFFFD;
    }
    cp = (cp << 6) | (static_cast<unsigned char>(s[i]) & 0x3F);
    ++i;
  }
  return cp;
}

inline void append_cp(std::string& out, uint32_t cp) {
  if (cp < 0x80) {
    out += static_cast<char>(cp);
  } else if (cp < 0x800) {
    out += static_cast<char>(0xC0 | (cp >> 6));
    out += static_cast<char>(0x80 | (cp & 0x3F));
  } else if (cp < 0x10000) {
    out += static_cast<char>(0xE0 | (cp >> 12));
    out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
    out += static_cast<char>(0x80 | (cp & 0x3F));
  } else {
    out += static_cast<char>(0xF0 | (cp >> 18));
    out += static_cast<char>(0x80 | ((cp >> 12) & 0x3F));
    out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
    out += static_cast<char>(0x80 | (cp & 0x3F));
  }
}

std::vector<std::string> basic_tokenize(const Tokenizer& t, const std::string& text) {
  std::string clean;
  clean.reserve(text.size() * 2);
  size_t i = 0;
  while (i < text.size()) {
    uint32_t cp = next_cp(text, i);
    if (cp == 0 || cp == 0xFFFD || is_control(cp)) continue;
    if (is_ws(cp)) {
      clean += ' ';
      continue;
    }
    if (t.lower && cp >= 'A' && cp <= 'Z') cp += 32;
    if (is_cjk(cp)) {
      clean += ' ';
      append_cp(clean, cp);
      clean += ' ';
      continue;
    }
    if (is_punct(cp)) {
      clean += ' ';
      append_cp(clean, cp);
      clean += ' ';
      continue;
    }
    append_cp(clean, cp);
  }
  std::vector<std::string> out;
  size_t pos = 0;
  while (pos < clean.size()) {
    while (pos < clean.size() && clean[pos] == ' ') ++pos;
    size_t end = pos;
    while (end < clean.size() && clean[end] != ' ') ++end;
    if (end > pos) out.emplace_back(clean.substr(pos, end - pos));
    pos = end;
  }
  return out;
}

void wordpiece(const Tokenizer& t, const std::string& word,
               std::vector<int64_t>* ids) {
  if (word.size() > 100) {
    ids->push_back(t.unk);
    return;
  }
  // substring matches may only start/end at CODEPOINT boundaries — byte
  // slicing could split a multi-byte char and diverge from the python twin
  std::vector<size_t> bounds;
  for (size_t i = 0; i < word.size();) {
    bounds.push_back(i);
    next_cp(word, i);
  }
  bounds.push_back(word.size());
  std::vector<int64_t> pieces;
  size_t start = 0;  // index into bounds
  size_t n = bounds.size() - 1;  // number of codepoints
  while (start < n) {
    size_t end = n;
    int64_t cur = -1;
    while (end > start) {
      std::string sub =
          word.substr(bounds[start], bounds[end] - bounds[start]);
      if (start > 0) sub = "##" + sub;
      auto it = t.vocab.find(sub);
      if (it != t.vocab.end()) {
        cur = it->second;
        break;
      }
      --end;
    }
    if (cur < 0) {
      ids->push_back(t.unk);
      return;
    }
    pieces.push_back(cur);
    start = end;
  }
  ids->insert(ids->end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

void* ptk_create(const char* vocab_path, int do_lower_case) {
  std::ifstream f(vocab_path);
  if (!f.good()) return nullptr;
  auto* t = new Tokenizer();
  t->lower = do_lower_case != 0;
  std::string line;
  int64_t idx = 0;
  while (std::getline(f, line)) {
    while (!line.empty() && (line.back() == '\n' || line.back() == '\r'))
      line.pop_back();
    t->vocab.emplace(line, idx++);
  }
  auto unk = t->vocab.find("[UNK]");
  t->unk = unk != t->vocab.end() ? unk->second : 0;
  return t;
}

void ptk_destroy(void* h) { delete static_cast<Tokenizer*>(h); }

int64_t ptk_vocab_size(void* h) {
  return static_cast<int64_t>(static_cast<Tokenizer*>(h)->vocab.size());
}

int64_t ptk_token_id(void* h, const char* token) {
  auto& t = *static_cast<Tokenizer*>(h);
  auto it = t.vocab.find(token);
  return it != t.vocab.end() ? it->second : -1;
}

// tokenize text into ids (no special tokens); returns count written (<= cap)
int64_t ptk_encode(void* h, const char* text, int64_t* out, int64_t cap) {
  auto& t = *static_cast<Tokenizer*>(h);
  std::vector<int64_t> ids;
  for (const auto& w : basic_tokenize(t, text)) wordpiece(t, w, &ids);
  int64_t n = static_cast<int64_t>(ids.size());
  if (n > cap) n = cap;
  std::memcpy(out, ids.data(), n * sizeof(int64_t));
  return n;
}

}  // extern "C"
