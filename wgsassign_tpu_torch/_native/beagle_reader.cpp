// Native streaming gzipped-Beagle parser.
//
// Replaces the reference's reader (reader_cy.pyx:16-77: `gunzip -c`
// subprocess + single-threaded strtok/atof) with an in-process zlib inflate
// stream feeding a pool of parser threads.  The producer thread decompresses
// into newline-aligned chunks; worker threads tokenize rows into per-chunk
// arenas (fast fixed-format float parsing with strtod fallback); chunks are
// concatenated in order into the final [M, 2N] float32 block (GL of
// genotype 2 is dropped — it is reconstructed as 1-g0-g1 downstream, the
// same 2-of-3 storage contract as the reference).
//
// C ABI (consumed from Python via ctypes):
//   beagle_read(path, n_threads) -> BeagleResult*   (NULL on open failure)
//   beagle_read_range(path, n_threads, lo, hi) -> BeagleResult*
//       parses only data rows [lo, hi) — the per-host shard-loading path
//       for multi-host runs (each host reads its own contiguous row block;
//       decompression stops as soon as the window is exhausted)
//   beagle_dims(path, &m, &n) -> 0 on success
//       fast dimensions scan: header parse + newline count, no float work
//   beagle_free(result)
//
// Stateful sequential streaming (beyond-host-RAM ingest: one decompression
// pass over the file, O(block) peak memory per call):
//   beagle_stream_open(path, n_threads) -> handle (never NULL)
//   beagle_stream_header(handle) -> BeagleResult* carrying n + sample_names
//       (or error); m == 0, gl == NULL
//   beagle_stream_next(handle, max_rows) -> BeagleResult* with the next
//       <= max_rows data rows; m == 0 and no error means EOF
//   beagle_stream_close(handle)
//
// Build: g++ -O3 -shared -fPIC beagle_reader.cpp -lz -lpthread

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr size_t kChunkSize = 8u << 20;  // decompressed bytes per work unit

struct Chunk {
  std::string data;           // newline-aligned decompressed text
  std::vector<float> gl;      // parsed floats (2 per individual per row)
  std::string sites;          // '\n'-joined marker names
  int64_t rows = 0;
  int64_t skip = 0;           // leading data rows to pass over unparsed
  int64_t take = -1;          // data rows to parse after skipping (-1: all)
  std::string error;
};

// Number of data rows (lines with at least one non-whitespace char) in a
// newline-terminated text block.  Cheap single pass — lets the range reader
// assign global row indices to chunks before dispatching them.
int64_t count_data_lines(const char* p, const char* end) {
  int64_t n = 0;
  while (p < end) {
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    for (const char* q = p; q < line_end; ++q) {
      if (*q != ' ' && *q != '\t' && *q != '\r') {
        ++n;
        break;
      }
    }
    p = line_end + 1;
  }
  return n;
}

#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
// SWAR helpers for the dominant token shape "d.dddddd" (ANGSD/beagle GLs
// are "%.6f"-formatted: one integer digit, '.', exactly six fraction
// digits — 8 bytes).  One unaligned 8-byte load covers the whole token;
// the '.' byte is spliced out and a '0' padded in front so the classic
// 8-ASCII-digit SWAR reduction yields the 7-digit mantissa directly.
// The arithmetic result is IDENTICAL to the general path below (same
// integer mantissa, same double 1e-6 scale, same final float cast).
inline uint64_t load_u64(const char* p) {
  uint64_t w;
  memcpy(&w, p, 8);
  return w;
}

inline bool is_8_digits(uint64_t w) {
  // every byte in '0'..'9'
  return ((w & 0xF0F0F0F0F0F0F0F0ull) |
          (((w + 0x0606060606060606ull) & 0xF0F0F0F0F0F0F0F0ull) >> 4)) ==
         0x3333333333333333ull;
}

inline uint32_t parse_8_digits(uint64_t w) {
  // bytes are most-significant-digit-first in memory (little-endian load)
  w -= 0x3030303030303030ull;
  w = w * 10 + (w >> 8);  // adjacent pairs
  w = ((w & 0x000000FF000000FFull) * 0x000F424000000064ull +
       ((w >> 16) & 0x000000FF000000FFull) * 0x0000271000000001ull) >>
      32;
  return static_cast<uint32_t>(w);
}
#endif

inline bool is_sep(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

// Fast float parse for the common fixed-format case ("0.799992",
// "-1.5e-3"); falls back to strtod for anything unusual.  Returns nullptr
// when no token is present before `end` (short row).
inline const char* parse_float(const char* p, const char* end, float* out) {
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  if (p >= end || *p == '\n' || *p == '\r') return nullptr;
  const char* start = p;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) {
    neg = (*p == '-');
    ++p;
  }
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  // fast path: exactly "d.dddddd" followed by a separator
  if (end - p >= 9 && p[1] == '.' && is_sep(p[8])) {
    uint64_t w = load_u64(p);
    // splice out the '.' (byte 1) and pad a leading '0'
    uint64_t digits = ((w & 0xFF) | ((w >> 8) & ~0xFFull)) << 8 | 0x30;
    if (is_8_digits(digits)) {
      double v = static_cast<double>(parse_8_digits(digits)) * 1e-6;
      *out = static_cast<float>(neg ? -v : v);
      return p + 8;
    }
  }
#endif
  int64_t mant = 0;
  int digits = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    mant = mant * 10 + (*p - '0');
    ++digits;
    ++p;
  }
  int exp10 = 0;
  if (p < end && *p == '.') {
    ++p;
    while (p < end && *p >= '0' && *p <= '9') {
      mant = mant * 10 + (*p - '0');
      --exp10;
      ++digits;
      ++p;
    }
  }
  if (digits == 0 || digits > 17 ||
      (p < end && (*p == 'e' || *p == 'E' || *p == 'n' || *p == 'N' ||
                   *p == 'i' || *p == 'I'))) {
    // strtod skips leading whitespace including newlines, so bound it to
    // this line by copying the token.
    const char* tok_end = start;
    while (tok_end < end && *tok_end != ' ' && *tok_end != '\t' &&
           *tok_end != '\n' && *tok_end != '\r')
      ++tok_end;
    std::string tok(start, tok_end - start);
    char* q = nullptr;
    double v = strtod(tok.c_str(), &q);
    if (q == tok.c_str()) return nullptr;  // not a number
    *out = static_cast<float>(v);
    return tok_end;
  }
  static const double kPow10[] = {1e0,  1e-1, 1e-2, 1e-3, 1e-4, 1e-5,
                                  1e-6, 1e-7, 1e-8, 1e-9, 1e-10, 1e-11,
                                  1e-12, 1e-13, 1e-14, 1e-15, 1e-16, 1e-17};
  double v = static_cast<double>(mant) * kPow10[-exp10];
  *out = static_cast<float>(neg ? -v : v);
  return p;
}

inline const char* skip_token(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') ++p;
  return p;
}

// Skip one token but REQUIRE it to be present (non-empty before the line
// end).  Used for the third GL of each individual: its value is never
// stored (g2 is reconstructed as 1-g0-g1 downstream, the reference's
// 2-of-3 contract, reader_cy.pyx:62-66), so paying the full float parse
// for it wasted ~1/3 of tokenizer time; column-count validation is kept.
inline const char* skip_required_token(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  if (p >= end || *p == '\n' || *p == '\r') return nullptr;
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  // fast path: the fixed-width "d.dddddd" shape needs no per-char scan
  // (the digit check keeps short tokens like "1.5\t2.0" off this path —
  // a bare p[8]-separator test could jump two tokens at once)
  if (end - p >= 9 && p[1] == '.' && is_sep(p[8])) {
    uint64_t w = load_u64(p);
    uint64_t digits = ((w & 0xFF) | ((w >> 8) & ~0xFFull)) << 8 | 0x30;
    if (is_8_digits(digits)) return p + 8;
  }
#endif
  while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') ++p;
  return p;
}

void parse_chunk(Chunk* chunk, int64_t n_inds) {
  const char* p = chunk->data.data();
  const char* end = p + chunk->data.size();
  int64_t skip = chunk->skip;
  int64_t take = chunk->take;
  chunk->gl.reserve((chunk->data.size() / 8));
  while (p < end) {
    if (take == 0) break;
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    // marker token
    const char* tok_start = p;
    while (tok_start < line_end && (*tok_start == ' ' || *tok_start == '\t'))
      ++tok_start;
    const char* tok_end = skip_token(tok_start, line_end);
    if (tok_end == tok_start) {  // blank line
      p = line_end + 1;
      continue;
    }
    if (skip > 0) {  // data row before the requested window
      --skip;
      p = line_end + 1;
      continue;
    }
    if (take > 0) --take;
    chunk->sites.append(tok_start, tok_end - tok_start);
    chunk->sites.push_back('\n');
    // skip allele1, allele2
    const char* q = skip_token(tok_end, line_end);
    q = skip_token(q, line_end);
    // 3 GLs per individual; keep the first two, skip (but require) the
    // third — it is dropped anyway and a presence check preserves the
    // column-count validation at a third less float-parse work
    for (int64_t i = 0; i < n_inds; ++i) {
      float g0, g1;
      const char* a = parse_float(q, line_end, &g0);
      const char* b = a ? parse_float(a, line_end, &g1) : nullptr;
      const char* c = b ? skip_required_token(b, line_end) : nullptr;
      if (!c) {
        chunk->error = "row has fewer/invalid columns vs the header";
        return;
      }
      q = c;
      chunk->gl.push_back(g0);
      chunk->gl.push_back(g1);
    }
    // column-count check: nothing but whitespace may remain
    while (q < line_end && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
    if (q != line_end) {
      chunk->error = "row has more columns than the header";
      return;
    }
    ++chunk->rows;
    p = line_end + 1;
  }
}

}  // namespace

extern "C" {

struct BeagleResult {
  int64_t m = 0;        // sites
  int64_t n = 0;        // individuals
  float* gl = nullptr;  // [m, 2n]
  char* sample_names = nullptr;  // '\n'-joined
  char* site_names = nullptr;    // '\n'-joined
  char* error = nullptr;
};

void beagle_free(BeagleResult* r) {
  if (!r) return;
  free(r->gl);
  free(r->sample_names);
  free(r->site_names);
  free(r->error);
  delete r;
}

static BeagleResult* fail(BeagleResult* r, const std::string& msg) {
  r->error = strdup(msg.c_str());
  return r;
}

// Parse data rows [lo, hi) of the file ([0, inf) when hi < 0).  The gzip
// stream is sequential, so rows before `lo` are still decompressed and
// line-counted, but never tokenized into floats; decompression stops at the
// first chunk past `hi`.
BeagleResult* beagle_read_range(const char* path, int n_threads, int64_t lo,
                                int64_t hi) {
  BeagleResult* r = new BeagleResult();
  gzFile f = gzopen(path, "rb");
  if (!f) return fail(r, std::string("cannot open ") + path);
  gzbuffer(f, 1u << 20);
  if (n_threads < 1) n_threads = 1;

  // --- header ---
  std::string header;
  {
    char buf[1 << 16];
    for (;;) {
      if (gzgets(f, buf, sizeof(buf)) == nullptr) {
        gzclose(f);
        return fail(r, "empty file or read error in header");
      }
      header += buf;
      if (!header.empty() && header.back() == '\n') break;
    }
  }
  int64_t n_cols = 0;
  std::string samples;
  {
    const char* p = header.data();
    const char* end = p + header.size();
    int64_t idx = 0;
    while (p < end) {
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
        ++p;
      const char* tok = p;
      p = skip_token(p, end);
      if (p == tok) break;
      if (idx >= 3 && (idx - 3) % 3 == 0) {
        samples.append(tok, p - tok);
        samples.push_back('\n');
      }
      ++idx;
    }
    n_cols = idx;
  }
  if (n_cols < 6 || (n_cols - 3) % 3 != 0) {
    gzclose(f);
    return fail(r, "Malformed Beagle header: expected 3 + 3*N columns");
  }
  const int64_t n_inds = (n_cols - 3) / 3;

  // --- decompress into newline-aligned chunks, parse in worker threads ---
  std::vector<Chunk*> chunks;
  std::vector<std::thread> workers;
  std::string carry;
  int64_t row_counter = 0;  // global data-row index of the next chunk start
  const bool whole_file = (lo <= 0 && hi < 0);
  auto dispatch = [&](std::string text) {
    int64_t skip = 0;
    int64_t take = -1;  // whole-file: no producer-side line count needed
    if (!whole_file) {
      int64_t c_lines =
          count_data_lines(text.data(), text.data() + text.size());
      int64_t chunk_lo = row_counter;
      row_counter += c_lines;
      // overlap of this chunk's rows with the requested [lo, hi) window
      skip = std::max<int64_t>(0, lo - chunk_lo);
      take = hi < 0 ? c_lines - skip
                    : std::min(row_counter, hi) - std::max(chunk_lo, lo);
      if (take <= 0) return;  // entirely outside the window
    }
    Chunk* c = new Chunk();
    c->data = std::move(text);
    c->skip = skip;
    c->take = take;
    chunks.push_back(c);
    workers.emplace_back(parse_chunk, c, n_inds);
    if (static_cast<int>(workers.size()) >= n_threads + 2) {
      workers.front().join();
      workers.erase(workers.begin());
    }
  };
  for (;;) {
    if (hi >= 0 && row_counter >= hi) break;  // window exhausted — stop early
    // inflate directly into the chunk-owned string (no bounce buffer)
    std::string text = std::move(carry);
    carry.clear();
    size_t base = text.size();
    text.resize(base + kChunkSize);
    int got = gzread(f, &text[base], kChunkSize);
    if (got < 0) {
      for (auto& t : workers) t.join();
      gzclose(f);
      for (Chunk* d : chunks) delete d;
      return fail(r, "gzip stream error");
    }
    text.resize(base + got);
    if (got == 0) {
      carry = std::move(text);
      break;
    }
    size_t last_nl = text.find_last_of('\n');
    if (last_nl == std::string::npos) {
      carry = std::move(text);
      continue;
    }
    carry = text.substr(last_nl + 1);
    text.resize(last_nl + 1);
    dispatch(std::move(text));
  }
  gzclose(f);
  if (!carry.empty() && !(hi >= 0 && row_counter >= hi)) {
    // final line without trailing newline
    carry.push_back('\n');
    dispatch(std::move(carry));
  }
  for (auto& t : workers) t.join();

  // --- assemble ---
  int64_t m = 0;
  size_t sites_len = 0;
  for (Chunk* c : chunks) {
    if (!c->error.empty()) {
      std::string msg = c->error;
      for (Chunk* d : chunks) delete d;
      return fail(r, "parse error: " + msg);
    }
    m += c->rows;
    sites_len += c->sites.size();
  }
  r->m = m;
  r->n = n_inds;
  r->gl = static_cast<float*>(malloc(sizeof(float) * m * 2 * n_inds));
  r->site_names = static_cast<char*>(malloc(sites_len + 1));
  r->sample_names = strdup(samples.c_str());
  if (!r->gl || !r->site_names || !r->sample_names) {
    for (Chunk* d : chunks) delete d;
    return fail(r, "out of memory");
  }
  float* gp = r->gl;
  char* sp = r->site_names;
  for (Chunk* c : chunks) {
    memcpy(gp, c->gl.data(), c->gl.size() * sizeof(float));
    gp += c->gl.size();
    memcpy(sp, c->sites.data(), c->sites.size());
    sp += c->sites.size();
    delete c;
  }
  *sp = '\0';
  return r;
}

BeagleResult* beagle_read(const char* path, int n_threads) {
  return beagle_read_range(path, n_threads, 0, -1);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Stateful sequential streaming.

namespace {

// Parse the header line already read into `header`; fills n_inds + samples.
// Returns an error message, or "" on success.
std::string parse_header(const std::string& header, int64_t* n_inds,
                         std::string* samples) {
  const char* p = header.data();
  const char* end = p + header.size();
  int64_t idx = 0;
  while (p < end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
    const char* tok = p;
    p = skip_token(p, end);
    if (p == tok) break;
    if (idx >= 3 && (idx - 3) % 3 == 0) {
      samples->append(tok, p - tok);
      samples->push_back('\n');
    }
    ++idx;
  }
  if (idx < 6 || (idx - 3) % 3 != 0)
    return "Malformed Beagle header: expected 3 + 3*N columns";
  *n_inds = (idx - 3) / 3;
  return "";
}

// Join workers, validate chunk errors, concatenate parsed chunks into `r`.
// Consumes (deletes) the chunks either way.
BeagleResult* assemble_chunks(BeagleResult* r, std::vector<Chunk*>& chunks,
                              int64_t n_inds) {
  int64_t m = 0;
  size_t sites_len = 0;
  for (Chunk* c : chunks) {
    if (!c->error.empty()) {
      std::string msg = c->error;
      for (Chunk* d : chunks) delete d;
      chunks.clear();
      return fail(r, "parse error: " + msg);
    }
    m += c->rows;
    sites_len += c->sites.size();
  }
  r->m = m;
  r->n = n_inds;
  r->gl = static_cast<float*>(malloc(sizeof(float) * (m ? m : 1) * 2 * n_inds));
  r->site_names = static_cast<char*>(malloc(sites_len + 1));
  if (!r->gl || !r->site_names) {
    for (Chunk* d : chunks) delete d;
    chunks.clear();
    return fail(r, "out of memory");
  }
  float* gp = r->gl;
  char* sp = r->site_names;
  for (Chunk* c : chunks) {
    memcpy(gp, c->gl.data(), c->gl.size() * sizeof(float));
    gp += c->gl.size();
    memcpy(sp, c->sites.data(), c->sites.size());
    sp += c->sites.size();
    delete c;
  }
  chunks.clear();
  *sp = '\0';
  return r;
}

}  // namespace

extern "C" {

struct BeagleStreamHandle {
  gzFile f = nullptr;
  int n_threads = 1;
  int64_t n_inds = 0;
  std::string samples;   // '\n'-joined sample names
  std::string carry;     // trailing partial line from the last gzread
  std::string pending;   // complete rows decompressed but not yet returned
  int64_t pending_rows = 0;
  bool eof = false;
  std::string error;     // sticky stream error
};

BeagleStreamHandle* beagle_stream_open(const char* path, int n_threads) {
  auto* s = new BeagleStreamHandle();
  s->n_threads = n_threads < 1 ? 1 : n_threads;
  s->f = gzopen(path, "rb");
  if (!s->f) {
    s->error = std::string("cannot open ") + path;
    return s;
  }
  gzbuffer(s->f, 1u << 20);
  std::string header;
  char buf[1 << 16];
  for (;;) {
    if (gzgets(s->f, buf, sizeof(buf)) == nullptr) {
      s->error = "empty file or read error in header";
      return s;
    }
    header += buf;
    if (!header.empty() && header.back() == '\n') break;
  }
  s->error = parse_header(header, &s->n_inds, &s->samples);
  return s;
}

BeagleResult* beagle_stream_header(BeagleStreamHandle* s) {
  BeagleResult* r = new BeagleResult();
  if (!s->error.empty()) return fail(r, s->error);
  r->n = s->n_inds;
  r->sample_names = strdup(s->samples.c_str());
  return r;
}

BeagleResult* beagle_stream_next(BeagleStreamHandle* s, int64_t max_rows) {
  BeagleResult* r = new BeagleResult();
  if (!s->error.empty()) return fail(r, s->error);
  if (max_rows < 1) max_rows = 1;

  std::vector<Chunk*> chunks;
  std::vector<std::thread> workers;
  int64_t remaining = max_rows;

  auto dispatch_text = [&](std::string text, int64_t lines) {
    Chunk* c = new Chunk();
    c->data = std::move(text);
    c->skip = 0;
    c->take = lines;
    chunks.push_back(c);
    workers.emplace_back(parse_chunk, c, s->n_inds);
    if (static_cast<int>(workers.size()) >= s->n_threads + 2) {
      workers.front().join();
      workers.erase(workers.begin());
    }
    remaining -= lines;
  };

  // Consume a newline-terminated text block: parse up to `remaining` data
  // rows; complete rows beyond the budget are stashed in s->pending for the
  // next call.
  auto consume = [&](std::string text) {
    int64_t lines =
        count_data_lines(text.data(), text.data() + text.size());
    if (lines == 0) return;
    if (lines <= remaining) {
      dispatch_text(std::move(text), lines);
      return;
    }
    // split after exactly `remaining` data rows
    const char* base = text.data();
    const char* p = base;
    const char* end = base + text.size();
    int64_t need = remaining;
    while (p < end && need > 0) {
      const char* le = static_cast<const char*>(memchr(p, '\n', end - p));
      if (!le) le = end;
      for (const char* q = p; q < le; ++q) {
        if (*q != ' ' && *q != '\t' && *q != '\r') {
          --need;
          break;
        }
      }
      p = (le < end) ? le + 1 : end;
    }
    size_t head_len = static_cast<size_t>(p - base);
    s->pending = text.substr(head_len);
    s->pending_rows = lines - remaining;
    text.resize(head_len);
    dispatch_text(std::move(text), remaining);
  };

  // 1) leftover rows from the previous call
  if (!s->pending.empty()) {
    std::string text = std::move(s->pending);
    s->pending.clear();
    s->pending_rows = 0;
    consume(std::move(text));
  }

  // 2) stream further chunks until the budget is met (or EOF)
  while (remaining > 0 && !s->eof && s->pending.empty()) {
    // inflate directly into the chunk-owned string (no bounce buffer)
    std::string text = std::move(s->carry);
    s->carry.clear();
    size_t base = text.size();
    text.resize(base + kChunkSize);
    int got = gzread(s->f, &text[base], kChunkSize);
    if (got < 0) {
      for (auto& t : workers) t.join();
      for (Chunk* d : chunks) delete d;
      s->error = "gzip stream error";
      return fail(r, s->error);
    }
    text.resize(base + got);
    if (got == 0) {
      s->eof = true;
      if (!text.empty()) {
        text.push_back('\n');
        consume(std::move(text));
      }
      break;
    }
    size_t last_nl = text.find_last_of('\n');
    if (last_nl == std::string::npos) {
      s->carry = std::move(text);
      continue;
    }
    s->carry = text.substr(last_nl + 1);
    text.resize(last_nl + 1);
    consume(std::move(text));
  }
  for (auto& t : workers) t.join();

  BeagleResult* out = assemble_chunks(r, chunks, s->n_inds);
  if (out->error) s->error = out->error;  // sticky
  return out;
}

// Skip the next `n_rows` data rows of the stream without tokenizing any
// floats (decompression + line counting only) — the cheap window cut for
// per-process streamed ingest: each process skips to its own row window,
// then reads blocks.  Returns rows actually skipped (< n_rows only at
// EOF), or -1 on a stream error.
int64_t beagle_stream_skip(BeagleStreamHandle* s, int64_t n_rows) {
  if (!s->error.empty()) return -1;
  if (n_rows <= 0) return 0;
  int64_t remaining = n_rows;

  // Count a newline-terminated text block against the skip budget; when
  // the block holds more data rows than the budget, split after exactly
  // `remaining` rows and stash the tail for the next read call.
  auto consume_skip = [&](std::string text) {
    int64_t lines = count_data_lines(text.data(), text.data() + text.size());
    if (lines <= remaining) {
      remaining -= lines;
      return;
    }
    const char* base = text.data();
    const char* p = base;
    const char* end = base + text.size();
    int64_t need = remaining;
    while (p < end && need > 0) {
      const char* le = static_cast<const char*>(memchr(p, '\n', end - p));
      if (!le) le = end;
      for (const char* q = p; q < le; ++q) {
        if (*q != ' ' && *q != '\t' && *q != '\r') {
          --need;
          break;
        }
      }
      p = (le < end) ? le + 1 : end;
    }
    s->pending = text.substr(static_cast<size_t>(p - base));
    s->pending_rows = lines - remaining;
    remaining = 0;
  };

  if (!s->pending.empty()) {
    std::string text = std::move(s->pending);
    s->pending.clear();
    s->pending_rows = 0;
    consume_skip(std::move(text));
  }
  std::vector<char> buf(kChunkSize);
  while (remaining > 0 && !s->eof) {
    int got = gzread(s->f, buf.data(), buf.size());
    if (got < 0) {
      s->error = "gzip stream error";
      return -1;
    }
    if (got == 0) {
      s->eof = true;
      if (!s->carry.empty()) {
        s->carry.push_back('\n');
        std::string text = std::move(s->carry);
        s->carry.clear();
        consume_skip(std::move(text));
      }
      break;
    }
    std::string text = std::move(s->carry);
    text.append(buf.data(), got);
    size_t last_nl = text.find_last_of('\n');
    if (last_nl == std::string::npos) {
      s->carry = std::move(text);
      continue;
    }
    s->carry = text.substr(last_nl + 1);
    text.resize(last_nl + 1);
    consume_skip(std::move(text));
  }
  return n_rows - remaining;
}

void beagle_stream_close(BeagleStreamHandle* s) {
  if (!s) return;
  if (s->f) gzclose(s->f);
  delete s;
}

// Fast dimensions scan: header column count + data-row count, no float
// parsing.  Returns 0 on success; 1 open failure, 2 malformed header,
// 3 gzip stream error.
int beagle_dims(const char* path, int64_t* m_out, int64_t* n_out) {
  gzFile f = gzopen(path, "rb");
  if (!f) return 1;
  gzbuffer(f, 1u << 20);
  std::string header;
  {
    char buf[1 << 16];
    for (;;) {
      if (gzgets(f, buf, sizeof(buf)) == nullptr) {
        gzclose(f);
        return 2;
      }
      header += buf;
      if (!header.empty() && header.back() == '\n') break;
    }
  }
  int64_t n_cols = 0;
  {
    const char* p = header.data();
    const char* end = p + header.size();
    while (p < end) {
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
        ++p;
      const char* tok = p;
      p = skip_token(p, end);
      if (p == tok) break;
      ++n_cols;
    }
  }
  if (n_cols < 6 || (n_cols - 3) % 3 != 0) {
    gzclose(f);
    return 2;
  }
  int64_t m = 0;
  std::string carry;
  std::vector<char> buf(kChunkSize);
  for (;;) {
    int got = gzread(f, buf.data(), buf.size());
    if (got < 0) {
      gzclose(f);
      return 3;
    }
    if (got == 0) break;
    std::string text = std::move(carry);
    text.append(buf.data(), got);
    size_t last_nl = text.find_last_of('\n');
    if (last_nl == std::string::npos) {
      carry = std::move(text);
      continue;
    }
    carry = text.substr(last_nl + 1);
    text.resize(last_nl + 1);
    m += count_data_lines(text.data(), text.data() + text.size());
  }
  gzclose(f);
  if (!carry.empty()) {
    carry.push_back('\n');
    m += count_data_lines(carry.data(), carry.data() + carry.size());
  }
  *m_out = m;
  *n_out = (n_cols - 3) / 3;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Whitespace-delimited int32 matrix reader (allele-depth files).
//
// The reference loads `--ind_ad_file` with np.loadtxt (WGSassign.py:320,399)
// — a [M, 2N] text matrix that reaches multi-GB at production scale.  This
// reuses the Beagle loader's pattern: zlib inflate (gzopen reads plain files
// transparently) into newline-aligned chunks, a pool of tokenizer threads,
// ordered concatenation into one int32 block.

namespace {

struct IntChunk {
  std::string data;
  std::vector<int32_t> vals;
  int64_t rows = 0;
  int64_t cols = 0;  // expected columns per row
  std::string error;
};

// Strict integer token parse; rejects floats/garbage so malformed input
// fails loudly instead of truncating.  Returns nullptr when no token
// starts before `end` or the token is not a pure integer.
inline const char* parse_int(const char* p, const char* end, int32_t* out) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  if (p >= end || *p == '\n') return nullptr;
  bool neg = false;
  if (*p == '-' || *p == '+') {
    neg = (*p == '-');
    ++p;
  }
  if (p >= end || *p < '0' || *p > '9') return nullptr;
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    if (v > INT32_MAX) return nullptr;
    ++p;
  }
  if (p < end && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n')
    return nullptr;  // trailing junk ("3.0", "4x") — not an integer
  *out = static_cast<int32_t>(neg ? -v : v);
  return p;
}

void parse_int_chunk(IntChunk* chunk) {
  const char* p = chunk->data.data();
  const char* end = p + chunk->data.size();
  chunk->vals.reserve(chunk->data.size() / 2);
  while (p < end) {
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    // blank line?
    const char* q = p;
    while (q < line_end && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
    if (q == line_end) {
      p = line_end + 1;
      continue;
    }
    for (int64_t c = 0; c < chunk->cols; ++c) {
      int32_t v;
      const char* nx = parse_int(q, line_end, &v);
      if (!nx) {
        chunk->error = "row has fewer columns than the first row, or a "
                       "non-integer token";
        return;
      }
      q = nx;
      chunk->vals.push_back(v);
    }
    while (q < line_end && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
    if (q != line_end) {
      chunk->error = "row has more columns than the first row";
      return;
    }
    ++chunk->rows;
    p = line_end + 1;
  }
}

}  // namespace

extern "C" {

struct AdResult {
  int64_t m = 0;
  int64_t cols = 0;
  int32_t* data = nullptr;
  char* error = nullptr;
};

void ad_free(AdResult* r) {
  if (!r) return;
  free(r->data);
  free(r->error);
  delete r;
}

static AdResult* ad_fail(AdResult* r, const std::string& msg) {
  r->error = strdup(msg.c_str());
  return r;
}

AdResult* ad_read(const char* path, int n_threads) {
  AdResult* r = new AdResult();
  gzFile f = gzopen(path, "rb");
  if (!f) return ad_fail(r, std::string("cannot open ") + path);
  gzbuffer(f, 1u << 20);
  if (n_threads < 1) n_threads = 1;

  std::vector<IntChunk*> chunks;
  std::vector<std::thread> workers;
  std::string carry;
  std::vector<char> buf(kChunkSize);
  int64_t cols = -1;  // determined from the first data line
  auto dispatch = [&](std::string text) -> bool {
    if (cols < 0) {
      // count integer tokens on the first non-blank line
      const char* p = text.data();
      const char* end = p + text.size();
      while (p < end) {
        const char* line_end =
            static_cast<const char*>(memchr(p, '\n', end - p));
        if (!line_end) line_end = end;
        int64_t c = 0;
        const char* q = p;
        for (;;) {
          int32_t v;
          const char* nx = parse_int(q, line_end, &v);
          if (!nx) break;
          q = nx;
          ++c;
        }
        if (c > 0) {
          cols = c;
          break;
        }
        p = line_end + 1;
      }
      if (cols < 0) return true;  // all-blank chunk
    }
    IntChunk* c = new IntChunk();
    c->data = std::move(text);
    c->cols = cols;
    chunks.push_back(c);
    workers.emplace_back(parse_int_chunk, c);
    if (static_cast<int>(workers.size()) >= n_threads + 2) {
      workers.front().join();
      workers.erase(workers.begin());
    }
    return true;
  };
  for (;;) {
    int got = gzread(f, buf.data(), buf.size());
    if (got < 0) {
      for (auto& t : workers) t.join();
      gzclose(f);
      for (IntChunk* d : chunks) delete d;
      return ad_fail(r, "gzip stream error");
    }
    if (got == 0) break;
    std::string text = std::move(carry);
    text.append(buf.data(), got);
    size_t last_nl = text.find_last_of('\n');
    if (last_nl == std::string::npos) {
      carry = std::move(text);
      continue;
    }
    carry = text.substr(last_nl + 1);
    text.resize(last_nl + 1);
    dispatch(std::move(text));
  }
  gzclose(f);
  if (!carry.empty()) {
    carry.push_back('\n');
    dispatch(std::move(carry));
  }
  for (auto& t : workers) t.join();

  int64_t m = 0;
  for (IntChunk* c : chunks) {
    if (!c->error.empty()) {
      std::string msg = c->error;
      for (IntChunk* d : chunks) delete d;
      return ad_fail(r, "parse error: " + msg);
    }
    m += c->rows;
  }
  r->m = m;
  r->cols = cols < 0 ? 0 : cols;
  r->data = static_cast<int32_t*>(
      malloc(sizeof(int32_t) * (m ? m : 1) * (r->cols ? r->cols : 1)));
  if (!r->data) {
    for (IntChunk* d : chunks) delete d;
    return ad_fail(r, "out of memory");
  }
  int32_t* dp = r->data;
  for (IntChunk* c : chunks) {
    memcpy(dp, c->vals.data(), c->vals.size() * sizeof(int32_t));
    dp += c->vals.size();
    delete c;
  }
  return r;
}

}  // extern "C"
