// The port's host runtime: the byte tokenizer's encode and the Levenshtein
// distance of the WER/CER reward, with a plain C interface for ctypes
// (counterpart of native/ttsmax_native.cc). Built with g++ by
// tts_max_tpu_torch/native at first use; there is no fallback.
//
// encode gives the ids of ByteTokenizer.encode_plain on every input: a
// special token is "<|" body "|>" with a nonempty body free of '|', '<' and
// '>' (the regex <\|[^|<>]+\|>), looked up exactly among the added tokens,
// else emitted byte by byte. "<|s_N|>" takes a dense table only where N is
// a canonical decimal below the table's size, which is then exactly the
// added token the table was built from.

#include <cstdint>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

extern "C" {

// Levenshtein distance over int32 token sequences.
int32_t ttsmax_port_levenshtein(const int32_t* ref, int32_t ref_len,
                                const int32_t* hyp, int32_t hyp_len) {
  if (ref_len == 0) return hyp_len;
  if (hyp_len == 0) return ref_len;
  std::vector<int32_t> prev(hyp_len + 1), cur(hyp_len + 1);
  for (int32_t j = 0; j <= hyp_len; ++j) prev[j] = j;
  for (int32_t i = 1; i <= ref_len; ++i) {
    cur[0] = i;
    const int32_t r = ref[i - 1];
    for (int32_t j = 1; j <= hyp_len; ++j) {
      const int32_t sub = prev[j - 1] + (r == hyp[j - 1] ? 0 : 1);
      const int32_t del = prev[j] + 1;
      const int32_t ins = cur[j - 1] + 1;
      const int32_t best = sub < del ? sub : del;
      cur[j] = best < ins ? best : ins;
    }
    std::swap(prev, cur);
  }
  return prev[hyp_len];
}

// ids: 0 pad, 1 bos, 2 eos, 3..258 bytes, then the added tokens.
struct Tokenizer {
  std::unordered_map<std::string, int32_t> added;
  std::vector<int32_t> speech_ids;  // code -> id of "<|s_code|>", may be empty
};

void* ttsmax_port_tokenizer_new() { return new Tokenizer(); }

void ttsmax_port_tokenizer_free(void* t) { delete static_cast<Tokenizer*>(t); }

// n tokens at once: token k is the next lens[k] bytes of blob (no NUL
// terminators), with id ids[k]. The first id given for a token stays. One
// call a vocabulary: a ctypes call a token costs more than its insert.
void ttsmax_port_tokenizer_add_tokens(void* t, const char* blob,
                                      const int32_t* lens, const int32_t* ids,
                                      int32_t n) {
  auto* tok = static_cast<Tokenizer*>(t);
  tok->added.reserve(tok->added.size() + n);
  for (int32_t k = 0; k < n; ++k) {
    tok->added.emplace(std::string(blob, lens[k]), ids[k]);
    blob += lens[k];
  }
}

void ttsmax_port_tokenizer_set_speech_table(void* t, const int32_t* ids,
                                            int32_t n) {
  static_cast<Tokenizer*>(t)->speech_ids.assign(ids, ids + n);
}

// The code of a canonical decimal text[lo, hi) below size, or -1: "0", or
// digits without a leading zero. Stops as soon as the value reaches size,
// so nothing overflows.
static int64_t canonical_code(const uint8_t* text, int32_t lo, int32_t hi,
                              int64_t size) {
  if (lo >= hi || (text[lo] == '0' && hi - lo > 1)) return -1;
  int64_t code = 0;
  for (int32_t k = lo; k < hi; ++k) {
    if (text[k] < '0' || text[k] > '9') return -1;
    code = code * 10 + (text[k] - '0');
    if (code >= size) return -1;
  }
  return code;
}

// Encode the n bytes of text into out (capacity out_cap). Returns the
// number of ids, or -1 if out_cap is too small (n always suffices: each id
// takes at least one byte).
int32_t ttsmax_port_tokenizer_encode(void* t, const uint8_t* text, int32_t n,
                                     int32_t* out, int32_t out_cap) {
  const auto* tok = static_cast<const Tokenizer*>(t);
  const int64_t n_speech = static_cast<int64_t>(tok->speech_ids.size());
  int32_t m = 0;
  int32_t i = 0;
  while (i < n) {
    if (text[i] == '<' && i + 1 < n && text[i + 1] == '|') {
      // the body runs to the first '|', '<' or '>'; a scan that stops at
      // '<' or fails ends before the next place a token can start, so the
      // scans never overlap and the whole encode stays linear
      int32_t j = i + 2;
      while (j < n && text[j] != '|' && text[j] != '<' && text[j] != '>') ++j;
      if (j > i + 2 && j + 1 < n && text[j] == '|' && text[j + 1] == '>') {
        const int32_t end = j + 2;
        int64_t code = -1;
        if (n_speech > 0 && j - i > 4 && text[i + 2] == 's' &&
            text[i + 3] == '_') {
          code = canonical_code(text, i + 4, j, n_speech);
        }
        int32_t id = -1;
        if (code >= 0) {
          id = tok->speech_ids[code];
        } else {
          auto it = tok->added.find(
              std::string(reinterpret_cast<const char*>(text + i), end - i));
          if (it != tok->added.end()) id = it->second;
        }
        if (id >= 0) {
          if (m >= out_cap) return -1;
          out[m++] = id;
          i = end;
          continue;
        }
      }
    }
    if (m >= out_cap) return -1;
    out[m++] = 3 + text[i];
    ++i;
  }
  return m;
}

}  // extern "C"
