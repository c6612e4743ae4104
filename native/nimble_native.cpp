// nimble_native: C++ host-side IO for nimble_tpu.
//
// The device engine consumes fixed-shape 2-bit-coded read batches; this library
// keeps the chips fed: zlib-backed FASTQ(.gz) streaming + base encoding at
// native speed (the reference delegates its hot path to a Rust binary; here
// the device does the alignment and C++ does the IO).
//
// Exposed as a plain-C ABI for ctypes. No Python.h dependency.
//
// Build: make -C native   (produces libnimble_native.so)

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#include <parallel/algorithm>
#endif

#include <ctime>
#include <zlib.h>

namespace {

constexpr int8_t N_CODE = 4;

struct EncodeLut {
  int8_t lut[256];
  EncodeLut() {
    memset(lut, N_CODE, sizeof(lut));
    lut[(unsigned char)'A'] = 0;
    lut[(unsigned char)'a'] = 0;
    lut[(unsigned char)'C'] = 1;
    lut[(unsigned char)'c'] = 1;
    lut[(unsigned char)'G'] = 2;
    lut[(unsigned char)'g'] = 2;
    lut[(unsigned char)'T'] = 3;
    lut[(unsigned char)'t'] = 3;
    lut[(unsigned char)'U'] = 3;
    lut[(unsigned char)'u'] = 3;
  }
};
const EncodeLut kLut;

// Buffered gzFile line reader (gzgets is slow; we manage our own buffer).
struct Reader {
  gzFile f = nullptr;
  char *buf = nullptr;
  size_t cap = 0;     // buffer capacity
  size_t len = 0;     // valid bytes
  size_t pos = 0;     // cursor
  bool eof = false;

  bool fill() {
    if (eof) return len > pos;
    if (pos > 0) {
      memmove(buf, buf + pos, len - pos);
      len -= pos;
      pos = 0;
    }
    if (len == cap) {
      cap *= 2;
      buf = (char *)realloc(buf, cap);
    }
    int n = gzread(f, buf + len, (unsigned)(cap - len));
    if (n <= 0) {
      eof = true;
    } else {
      len += (size_t)n;
    }
    return len > pos;
  }

  // Returns pointer to the line (not NUL-terminated) and its length
  // (without the newline), or nullptr at EOF.
  const char *line(size_t *out_len) {
    for (;;) {
      char *nl = (char *)memchr(buf + pos, '\n', len - pos);
      if (nl != nullptr) {
        const char *start = buf + pos;
        size_t n = (size_t)(nl - start);
        pos = (size_t)(nl - buf) + 1;
        if (n > 0 && start[n - 1] == '\r') n--;
        *out_len = n;
        return start;
      }
      size_t before = len - pos;
      if (!fill() || (eof && len - pos == before)) {
        if (len > pos) {  // final unterminated line
          const char *start = buf + pos;
          *out_len = len - pos;
          pos = len;
          return start;
        }
        return nullptr;
      }
    }
  }
};

}  // namespace

extern "C" {

void *nt_fastq_open(const char *path) {
  gzFile f = gzopen(path, "rb");
  if (f == nullptr) return nullptr;
  gzbuffer(f, 1 << 20);
  Reader *r = new Reader();
  r->f = f;
  r->cap = 1 << 20;
  r->buf = (char *)malloc(r->cap);
  return r;
}

void nt_fastq_close(void *handle) {
  Reader *r = (Reader *)handle;
  if (r == nullptr) return;
  gzclose(r->f);
  free(r->buf);
  delete r;
}

// Read up to max_records FASTQ records.
//   codes:    int8  [max_records, max_len]  2-bit base codes, N_CODE padded
//   lens:     int32 [max_records]           clipped sequence lengths
//   raw:      char  [raw_cap]               packed name\0seq\0qual\0 triples
//   raw_offs: int64 [max_records*3]         offsets of name/seq/qual in raw
// Returns the number of records read (0 at EOF). Stops early when < 1 MiB
// of raw space remains, so callers should size raw_cap at
// max_records * (typical record size) + 1 MiB. A single record larger than
// 1 MiB returns -1 (fatal; caller raises).
int64_t nt_fastq_read_batch(void *handle, int64_t max_records, int64_t max_len,
                            int8_t *codes, int32_t *lens, char *raw,
                            int64_t raw_cap, int64_t *raw_offs) {
  Reader *r = (Reader *)handle;
  int64_t nrec = 0;
  int64_t raw_pos = 0;
  const int64_t kGuard = 1 << 20;
  while (nrec < max_records) {
    if (raw_cap - raw_pos < kGuard) break;
    size_t hlen, slen, plen, qlen;
    const char *h = r->line(&hlen);
    if (h == nullptr) break;
    // header: take first whitespace-delimited token after '@'
    const char *name = h + 1;
    size_t name_len = hlen > 0 ? hlen - 1 : 0;
    for (size_t i = 0; i < name_len; i++) {
      if (name[i] == ' ' || name[i] == '\t') {
        name_len = i;
        break;
      }
    }
    // copy name BEFORE subsequent line() calls invalidate the pointer
    if (raw_pos + (int64_t)name_len + 1 > raw_cap) return -1;
    raw_offs[nrec * 3 + 0] = raw_pos;
    memcpy(raw + raw_pos, name, name_len);
    raw[raw_pos + name_len] = 0;
    raw_pos += (int64_t)name_len + 1;

    const char *s = r->line(&slen);
    if (s == nullptr) break;
    if (raw_pos + (int64_t)slen + 1 > raw_cap) return -1;
    raw_offs[nrec * 3 + 1] = raw_pos;
    memcpy(raw + raw_pos, s, slen);
    raw[raw_pos + slen] = 0;
    // encode into the fixed-shape block
    int8_t *crow = codes + nrec * max_len;
    int64_t m = (int64_t)slen < max_len ? (int64_t)slen : max_len;
    const char *src = raw + raw_pos;  // stable copy
    for (int64_t i = 0; i < m; i++) crow[i] = kLut.lut[(unsigned char)src[i]];
    for (int64_t i = m; i < max_len; i++) crow[i] = N_CODE;
    lens[nrec] = (int32_t)m;
    raw_pos += (int64_t)slen + 1;

    const char *p = r->line(&plen);  // '+' separator
    (void)p;
    const char *q = r->line(&qlen);
    if (q == nullptr) qlen = 0;
    if (raw_pos + (int64_t)qlen + 1 > raw_cap) return -1;
    raw_offs[nrec * 3 + 2] = raw_pos;
    if (qlen > 0) memcpy(raw + raw_pos, q, qlen);
    raw[raw_pos + qlen] = 0;
    raw_pos += (int64_t)qlen + 1;

    nrec++;
  }
  return nrec;
}

// Parse a byte buffer of COMPLETE 4-line FASTQ records (the caller cuts the
// stream at record boundaries by newline count). Outputs match
// nt_fastq_read_batch. Designed for thread pools: ctypes releases the GIL
// around the call, so chunks parse in parallel across host cores
// (CLI `align -c`; the reference threads its whole hot path the same way,
// reference nimble/__main__.py:180).
// Returns records parsed, or -1 if outputs would overflow.
int64_t nt_fastq_parse_buffer(const char *buf, int64_t buf_len,
                              int64_t max_records, int64_t max_len,
                              int8_t *codes, int32_t *lens, char *raw,
                              int64_t raw_cap, int64_t *raw_offs) {
  int64_t pos = 0;
  int64_t nrec = 0;
  int64_t raw_pos = 0;
  // line() over the buffer: returns [start, end) of the next line, trimming
  // '\r' and the '\n' terminator; end-of-buffer terminates the last line.
  auto line = [&](int64_t *start, int64_t *len) -> bool {
    if (pos >= buf_len) return false;
    const char *nl =
        (const char *)memchr(buf + pos, '\n', (size_t)(buf_len - pos));
    int64_t end = nl ? (int64_t)(nl - buf) : buf_len;
    int64_t e = end;
    if (e > pos && buf[e - 1] == '\r') e--;
    *start = pos;
    *len = e - pos;
    pos = end + 1;
    return true;
  };
  while (nrec < max_records && pos < buf_len) {
    int64_t hs, hlen;
    if (!line(&hs, &hlen)) break;
    if (hlen == 0) continue;  // tolerate stray blank lines between records
    // header: first whitespace-delimited token after '@'
    int64_t name_s = hs + 1;
    int64_t name_len = hlen > 0 ? hlen - 1 : 0;
    for (int64_t i = 0; i < name_len; i++) {
      char c = buf[name_s + i];
      if (c == ' ' || c == '\t') {
        name_len = i;
        break;
      }
    }
    if (raw_pos + name_len + 1 > raw_cap) return -1;
    raw_offs[nrec * 3 + 0] = raw_pos;
    memcpy(raw + raw_pos, buf + name_s, (size_t)name_len);
    raw[raw_pos + name_len] = 0;
    raw_pos += name_len + 1;

    int64_t ss, slen;
    if (!line(&ss, &slen)) break;
    if (raw_pos + slen + 1 > raw_cap) return -1;
    raw_offs[nrec * 3 + 1] = raw_pos;
    memcpy(raw + raw_pos, buf + ss, (size_t)slen);
    raw[raw_pos + slen] = 0;
    raw_pos += slen + 1;
    int8_t *crow = codes + nrec * max_len;
    int64_t m = slen < max_len ? slen : max_len;
    for (int64_t i = 0; i < m; i++)
      crow[i] = kLut.lut[(unsigned char)buf[ss + i]];
    for (int64_t i = m; i < max_len; i++) crow[i] = N_CODE;
    lens[nrec] = (int32_t)m;

    int64_t ps, plen;
    line(&ps, &plen);  // '+' separator
    int64_t qs = 0, qlen = 0;
    if (!line(&qs, &qlen)) qlen = 0;
    if (raw_pos + qlen + 1 > raw_cap) return -1;
    raw_offs[nrec * 3 + 2] = raw_pos;
    if (qlen > 0) memcpy(raw + raw_pos, buf + qs, (size_t)qlen);
    raw[raw_pos + qlen] = 0;
    raw_pos += qlen + 1;

    nrec++;
  }
  return nrec;
}

// 2-bit wire packing for the host->device transfer: a quarter of the bytes
// of int8 codes (1 byte/base); packed words carry 16 bases per int32 (base j in word j/16
// at bit 2*(j%16)), N positions in a separate 1-bit-per-base flag plane
// (rare in real data -> shipped as a sparse sidecar by the Python layer).
//   codes:  int8  [n, in_stride]  2-bit base codes (N_CODE = N/invalid)
//   lens:   int32 [n]             read lengths (<= L; N beyond len ignored:
//                                 tail windows are invalidated by `inside`)
//   words:  int32 [n, (L+15)/16]  packed 2-bit codes (N packed as 0/A)
//   nflags: int32 [n, (L+31)/32]  bit j%32 of word j/32 = base j is N
//   has_n:  uint8 [n]             any N within [0, len)
void nt_pack_2bit(const int8_t *codes, const int32_t *lens, int64_t n,
                  int64_t in_stride, int64_t L, int32_t *words,
                  int32_t *nflags, uint8_t *has_n) {
  const int64_t Lw = (L + 15) / 16, Lf = (L + 31) / 32;
  for (int64_t i = 0; i < n; i++) {
    const int8_t *row = codes + i * in_stride;
    int32_t *wrow = words + i * Lw;
    int32_t *frow = nflags + i * Lf;
    memset(wrow, 0, (size_t)Lw * 4);
    memset(frow, 0, (size_t)Lf * 4);
    int64_t m = lens[i] < L ? lens[i] : L;
    uint32_t hn = 0;
    for (int64_t j = 0; j < m; j++) {
      uint32_t c = (uint32_t)(uint8_t)row[j];
      uint32_t isn = c >= 4 ? 1u : 0u;
      uint32_t v = isn ? 0u : (c & 3u);
      wrow[j >> 4] |= (int32_t)(v << (2 * (j & 15)));
      frow[j >> 5] |= (int32_t)(isn << (j & 31));
      hn |= isn;
    }
    has_n[i] = (uint8_t)hn;
  }
}

// Offset of the n-th (1-based) newline in buf, or -1. Drives the threaded
// reader's record-boundary cutting on contiguous (libdeflate-inflated)
// buffers; memchr runs SIMD so this walks at several GB/s.
int64_t nt_find_nth_newline(const char *buf, int64_t len, int64_t n) {
  const char *p = buf;
  const char *end = buf + len;
  int64_t count = 0;
  while (p < end) {
    const char *q = (const char *)memchr(p, '\n', (size_t)(end - p));
    if (!q) return -1;
    if (++count == n) return (int64_t)(q - buf);
    p = q + 1;
  }
  return -1;
}

// Vectorized batch base-encoding: seqs is a packed buffer of n sequences at
// given offsets/lengths -> codes [n, max_len] + lens [n].
void nt_encode_batch(const char *seqs, const int64_t *offs,
                     const int64_t *seq_lens, int64_t n, int64_t max_len,
                     int8_t *codes, int32_t *lens) {
  for (int64_t i = 0; i < n; i++) {
    const char *s = seqs + offs[i];
    int64_t m = seq_lens[i] < max_len ? seq_lens[i] : max_len;
    int8_t *row = codes + i * max_len;
    for (int64_t j = 0; j < m; j++) row[j] = kLut.lut[(unsigned char)s[j]];
    for (int64_t j = m; j < max_len; j++) row[j] = N_CODE;
    lens[i] = (int32_t)m;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BAM batch reader: BGZF (gzip-member) stream -> fixed-shape code batches.
// Parses records, 4-bit-unpacks sequences straight into 2-bit codes, and
// extracts CB/UB/GN string tags + flag/pos. Replaces the Python BamReader on
// the hot scRNA-seq input path.
// ---------------------------------------------------------------------------

namespace {

const int8_t kNibToCode[16] = {
    // = A C M G R S V T W Y H K D B N
    N_CODE, 0, 1, N_CODE, 2, N_CODE, N_CODE, N_CODE,
    3, N_CODE, N_CODE, N_CODE, N_CODE, N_CODE, N_CODE, N_CODE};

struct BamReaderC {
  gzFile f = nullptr;  // fallback: non-BGZF gzip stream
  // BGZF mode: raw file + compressed carry buffer; blocks are independent
  // gzip members, so a batch of them inflates in an OpenMP parallel for
  // (the sequential gzread path measured as the paired-pipeline floor)
  FILE *fp = nullptr;
  bool bgzf = false;
  uint8_t *cbuf = nullptr;
  size_t ccap = 0, clen = 0, cpos = 0;
  bool file_eof = false;
  // carry buffer for partial records across read calls (decompressed)
  uint8_t *buf = nullptr;
  size_t cap = 0;
  size_t len = 0;
  size_t pos = 0;
  bool eof = false;
  bool header_done = false;

  bool fill_compressed() {
    if (file_eof) return false;
    if (cpos > 0) {
      memmove(cbuf, cbuf + cpos, clen - cpos);
      clen -= cpos;
      cpos = 0;
    }
    if (ccap - clen < (1u << 20)) {
      ccap = ccap * 2 + (1u << 22);
      cbuf = (uint8_t *)realloc(cbuf, ccap);
    }
    size_t n = fread(cbuf + clen, 1, ccap - clen, fp);
    if (n == 0) {
      file_eof = true;
      return false;
    }
    clen += n;
    return true;
  }

  // parse one BGZF member header at absolute offset p in cbuf; returns
  // the total block size (0 = need more bytes, -1 = malformed)
  int64_t block_size_at(size_t p) {
    while (clen - p < 18) {
      size_t rel = p - cpos;
      if (!fill_compressed()) return (clen - (cpos + rel) >= 18) ? 0 : -2;
      p = cpos + rel;
    }
    const uint8_t *h = cbuf + p;
    if (h[0] != 0x1F || h[1] != 0x8B || h[2] != 0x08 || !(h[3] & 0x04))
      return -1;
    uint16_t xlen;
    memcpy(&xlen, h + 10, 2);
    size_t rel = p - cpos;
    while (clen - (cpos + rel) < (size_t)12 + xlen) {
      if (!fill_compressed()) return -2;
    }
    h = cbuf + cpos + rel;
    size_t q = 12;
    while (q + 4 <= (size_t)12 + xlen) {
      uint8_t si1 = h[q], si2 = h[q + 1];
      uint16_t slen;
      memcpy(&slen, h + q + 2, 2);
      if (si1 == 'B' && si2 == 'C' && slen == 2) {
        uint16_t bs;
        memcpy(&bs, h + q + 4, 2);
        return (int64_t)bs + 1;
      }
      q += 4 + slen;
    }
    return -1;
  }

  // inflate up to kBlocks BGZF members into the decompressed carry
  bool bgzf_fill() {
    if (pos > 0) {
      memmove(buf, buf + pos, len - pos);
      len -= pos;
      pos = 0;
    }
    struct Blk {
      size_t rel;     // offset from cpos in cbuf
      size_t bsize;
      size_t isize;
      size_t out_off;
    };
    const int kBlocks = 64;
    Blk blks[kBlocks];
    int nb = 0;
    size_t scan_rel = 0;
    size_t out_total = 0;
    while (nb < kBlocks) {
      int64_t bs = block_size_at(cpos + scan_rel);
      if (bs <= 0) break;  // EOF / partial trailing header / malformed
      bool truncated = false;
      while (clen - (cpos + scan_rel) < (size_t)bs) {
        if (!fill_compressed()) {
          truncated = true;
          break;
        }
      }
      if (truncated) break;  // inflate the complete blocks gathered so far
      uint32_t isize;
      memcpy(&isize, cbuf + cpos + scan_rel + bs - 4, 4);
      blks[nb] = {scan_rel, (size_t)bs, (size_t)isize, out_total};
      out_total += isize;
      scan_rel += (size_t)bs;
      nb++;
    }
    if (nb == 0) return false;
    while (cap - len < out_total) {
      cap = cap * 2 + (1u << 22);
      buf = (uint8_t *)realloc(buf, cap);
    }
    bool ok = true;
#pragma omp parallel for schedule(dynamic, 1) reduction(&& : ok)
    for (int i = 0; i < nb; i++) {
      const uint8_t *h = cbuf + cpos + blks[i].rel;
      uint16_t xlen;
      memcpy(&xlen, h + 10, 2);
      size_t data_off = 12 + (size_t)xlen;
      size_t payload = blks[i].bsize - data_off - 8;
      if (blks[i].isize == 0) continue;  // EOF marker block
      z_stream zs;
      memset(&zs, 0, sizeof(zs));
      if (inflateInit2(&zs, -15) != Z_OK) {
        ok = false;
        continue;
      }
      zs.next_in = (Bytef *)(h + data_off);
      zs.avail_in = (uInt)payload;
      zs.next_out = (Bytef *)(buf + len + blks[i].out_off);
      zs.avail_out = (uInt)blks[i].isize;
      int rc = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      ok = ok && (rc == Z_STREAM_END) && zs.total_out == blks[i].isize;
    }
    if (!ok) return false;
    len += out_total;
    cpos += scan_rel;
    return out_total > 0;
  }

  bool ensure(size_t need) {
    while (len - pos < need) {
      if (eof) return false;
      if (bgzf) {
        if (!bgzf_fill()) eof = true;
        continue;
      }
      if (pos > 0) {
        memmove(buf, buf + pos, len - pos);
        len -= pos;
        pos = 0;
      }
      if (cap - len < (1u << 20)) {
        cap = cap * 2 + (1u << 20);
        buf = (uint8_t *)realloc(buf, cap);
      }
      int n = gzread(f, buf + len, (unsigned)(cap - len));
      if (n <= 0) {
        eof = true;
      } else {
        len += (size_t)n;
      }
    }
    return true;
  }

  bool skip_header() {
    if (!ensure(12)) return false;
    if (memcmp(buf + pos, "BAM\x01", 4) != 0) return false;
    int32_t l_text;
    memcpy(&l_text, buf + pos + 4, 4);
    pos += 8;
    if (!ensure((size_t)l_text + 4)) return false;
    pos += (size_t)l_text;
    int32_t n_ref;
    memcpy(&n_ref, buf + pos, 4);
    pos += 4;
    for (int32_t i = 0; i < n_ref; i++) {
      if (!ensure(4)) return false;
      int32_t l_name;
      memcpy(&l_name, buf + pos, 4);
      pos += 4;
      if (!ensure((size_t)l_name + 4)) return false;
      pos += (size_t)l_name + 4;
    }
    header_done = true;
    return true;
  }
};

}  // namespace

extern "C" {

void *nt_bam_open(const char *path) {
  BamReaderC *r = new BamReaderC();
  r->cap = 1 << 22;
  r->buf = (uint8_t *)malloc(r->cap);
  // BGZF detection: gzip magic + FEXTRA with a 'BC' subfield
  FILE *fp = fopen(path, "rb");
  if (fp != nullptr) {
    uint8_t head[18];
    size_t got = fread(head, 1, sizeof(head), fp);
    bool is_bgzf = got == sizeof(head) && head[0] == 0x1F &&
                   head[1] == 0x8B && head[2] == 0x08 && (head[3] & 0x04) &&
                   head[12] == 'B' && head[13] == 'C';
    if (is_bgzf) {
      r->fp = fp;
      r->bgzf = true;
      r->ccap = 1 << 22;
      r->cbuf = (uint8_t *)malloc(r->ccap);
      memcpy(r->cbuf, head, got);
      r->clen = got;
      if (r->skip_header()) return r;
      fclose(fp);
      free(r->cbuf);
      free(r->buf);
      delete r;
      return nullptr;
    }
    fclose(fp);
  }
  gzFile f = gzopen(path, "rb");
  if (f == nullptr) {
    free(r->buf);
    delete r;
    return nullptr;
  }
  gzbuffer(f, 1 << 22);
  r->f = f;
  if (!r->skip_header()) {
    gzclose(f);
    free(r->buf);
    delete r;
    return nullptr;
  }
  return r;
}

void nt_bam_close(void *handle) {
  BamReaderC *r = (BamReaderC *)handle;
  if (r == nullptr) return;
  if (r->f != nullptr) gzclose(r->f);
  if (r->fp != nullptr) fclose(r->fp);
  free(r->cbuf);
  free(r->buf);
  delete r;
}

// Read up to max_records primary BAM records (secondary/supplementary
// skipped). Outputs per record:
//   codes  int8  [max_records, max_len]
//   lens   int32 [max_records]
//   flags  int32 [max_records]
//   poss   int32 [max_records]
//   raw    char  [raw_cap]   name\0 CB\0 UB\0 GN\0 per record
//   raw_offs int64 [max_records*4]
// Returns count (0 at EOF), or -1 on malformed input / raw overflow.
int64_t nt_bam_read_batch(void *handle, int64_t max_records, int64_t max_len,
                          int8_t *codes, int32_t *lens, int32_t *flags,
                          int32_t *poss, char *raw, int64_t raw_cap,
                          int64_t *raw_offs) {
  BamReaderC *r = (BamReaderC *)handle;
  int64_t nrec = 0;
  int64_t raw_pos = 0;
  const int64_t kGuard = 1 << 20;
  while (nrec < max_records) {
    if (raw_cap - raw_pos < kGuard) break;
    if (!r->ensure(4)) break;
    int32_t block_size;
    memcpy(&block_size, r->buf + r->pos, 4);
    if (block_size < 32) return -1;
    if (!r->ensure(4 + (size_t)block_size)) break;
    const uint8_t *rec = r->buf + r->pos + 4;
    r->pos += 4 + (size_t)block_size;

    int32_t pos_field;
    memcpy(&pos_field, rec + 4, 4);
    uint8_t l_read_name = rec[8];
    uint16_t n_cigar;
    memcpy(&n_cigar, rec + 12, 2);
    uint16_t flag;
    memcpy(&flag, rec + 14, 2);
    int32_t l_seq;
    memcpy(&l_seq, rec + 16, 4);
    if (flag & 0x100 || flag & 0x800) continue;  // secondary/supplementary

    const uint8_t *p = rec + 32;
    const char *name = (const char *)p;
    size_t name_len = l_read_name > 0 ? (size_t)l_read_name - 1 : 0;
    p += l_read_name;
    p += 4 * (size_t)n_cigar;
    const uint8_t *seq_nibs = p;
    p += (l_seq + 1) / 2;
    p += l_seq;  // qualities (skipped)
    const uint8_t *tags = p;
    const uint8_t *tags_end = rec + block_size;

    // decode sequence nibbles -> 2-bit codes
    int8_t *crow = codes + nrec * max_len;
    int64_t m = l_seq < max_len ? l_seq : max_len;
    for (int64_t i = 0; i < m; i++) {
      uint8_t nib = (i % 2 == 0) ? (seq_nibs[i / 2] >> 4) : (seq_nibs[i / 2] & 0xF);
      crow[i] = kNibToCode[nib];
    }
    for (int64_t i = m; i < max_len; i++) crow[i] = N_CODE;
    lens[nrec] = (int32_t)m;
    flags[nrec] = flag;
    poss[nrec] = pos_field;

    // name
    raw_offs[nrec * 4 + 0] = raw_pos;
    memcpy(raw + raw_pos, name, name_len);
    raw[raw_pos + name_len] = 0;
    raw_pos += (int64_t)name_len + 1;

    // CB / UB / GN tags (Z type); emit empty strings when absent
    const char *want[3] = {"CB", "UB", "GN"};
    const uint8_t *found[3] = {nullptr, nullptr, nullptr};
    size_t found_len[3] = {0, 0, 0};
    const uint8_t *t = tags;
    while (t + 3 <= tags_end) {
      char key0 = (char)t[0], key1 = (char)t[1];
      char typ = (char)t[2];
      t += 3;
      size_t vlen = 0;
      if (typ == 'Z' || typ == 'H') {
        const uint8_t *z = t;
        while (z < tags_end && *z != 0) z++;
        vlen = (size_t)(z - t);
        for (int w = 0; w < 3; w++) {
          if (key0 == want[w][0] && key1 == want[w][1]) {
            found[w] = t;
            found_len[w] = vlen;
          }
        }
        t = z + 1;
      } else if (typ == 'A' || typ == 'c' || typ == 'C') {
        t += 1;
      } else if (typ == 's' || typ == 'S') {
        t += 2;
      } else if (typ == 'i' || typ == 'I' || typ == 'f') {
        t += 4;
      } else if (typ == 'B') {
        if (t + 5 > tags_end) break;
        char sub = (char)t[0];
        int32_t cnt;
        memcpy(&cnt, t + 1, 4);
        size_t esz = (sub == 'c' || sub == 'C') ? 1 : (sub == 's' || sub == 'S') ? 2 : 4;
        t += 5 + (size_t)cnt * esz;
      } else {
        break;  // unknown tag type: stop parsing tags for this record
      }
    }
    for (int w = 0; w < 3; w++) {
      raw_offs[nrec * 4 + 1 + w] = raw_pos;
      if (found[w] != nullptr) {
        memcpy(raw + raw_pos, found[w], found_len[w]);
      }
      raw[raw_pos + (int64_t)found_len[w]] = 0;
      raw_pos += (int64_t)found_len[w] + 1;
    }

    nrec++;
  }
  return nrec;
}

// Encode n read-pairs as unmapped BAM record blobs (R1 flag 77, R2 flag
// 141, CB/UB string tags) — byte-identical to the python encoder
// (nimble_tpu/io/bam.py _encode_record with BamRecord defaults). All
// string fields arrive as concatenated pools with (n+1) int64 offsets;
// quals are phred+33 ASCII, shifted (saturating at 0) here, matching the
// python path's translate table. The per-record struct/nibble/tag work
// was the fastq-to-bam hot spot in python (GIL-bound, so -c threads
// could not scale it). Returns bytes written, or -1 on out_cap overflow.
int64_t nt_encode_bam_pairs(
    int64_t n, const char *names, const int64_t *name_offs, const char *s1,
    const int64_t *s1_offs, const char *q1, const int64_t *q1_offs,
    const char *s2, const int64_t *s2_offs, const char *q2,
    const int64_t *q2_offs, const char *cbs, const int64_t *cb_offs,
    const char *umis, const int64_t *umi_offs, uint8_t *out,
    int64_t out_cap) {
  static uint8_t nib[256];
  static bool nib_init = false;
  if (!nib_init) {
    for (int i = 0; i < 256; i++) nib[i] = 15;
    const char *order = "=ACMGRSVTWYHKDBN";
    for (int i = 0; i < 16; i++) {
      nib[(uint8_t)order[i]] = (uint8_t)i;
      nib[(uint8_t)tolower(order[i])] = (uint8_t)i;
    }
    nib_init = true;
  }
  uint8_t *p = out;
  uint8_t *end = out + out_cap;
  auto emit = [&](uint16_t flag, const char *name, int64_t name_len,
                  const char *seq, int64_t l_seq, const char *qual,
                  int64_t l_qual, const char *cb, int64_t cb_len,
                  const char *umi, int64_t umi_len) -> bool {
    int64_t nlen = name_len + 1;  // + NUL
    int64_t nnib = (l_seq + 1) / 2;
    int64_t tag_len = 3 + cb_len + 1 + 3 + umi_len + 1;
    int64_t payload = 32 + nlen + nnib + l_seq + tag_len;
    if (nlen > 255) return false;  // caller maps to -2 (bad input)
    if (p + 4 + payload > end) return false;
    auto w32 = [&](int32_t v) {
      memcpy(p, &v, 4);
      p += 4;
    };
    auto w16 = [&](uint16_t v) {
      memcpy(p, &v, 2);
      p += 2;
    };
    w32((int32_t)payload);
    w32(-1);  // refID
    w32(-1);  // pos
    *p++ = (uint8_t)nlen;
    *p++ = 0;     // mapq
    w16(4680);    // bin (reg2bin(-1, 0))
    w16(0);       // n_cigar_op
    w16(flag);
    w32((int32_t)l_seq);
    w32(-1);  // next_refID
    w32(-1);  // next_pos
    w32(0);   // tlen
    memcpy(p, name, (size_t)name_len);
    p += name_len;
    *p++ = 0;
    for (int64_t i = 0; i + 1 < l_seq; i += 2)
      *p++ = (uint8_t)((nib[(uint8_t)seq[i]] << 4) | nib[(uint8_t)seq[i + 1]]);
    if (l_seq & 1) *p++ = (uint8_t)(nib[(uint8_t)seq[l_seq - 1]] << 4);
    for (int64_t i = 0; i < l_seq; i++) {
      if (i < l_qual) {
        int q = (int)(uint8_t)qual[i] - 33;
        *p++ = (uint8_t)(q < 0 ? 0 : q);
      } else {
        *p++ = 0xFF;  // python pads absent quals with 0xff
      }
    }
    p[0] = 'C';
    p[1] = 'B';
    p[2] = 'Z';
    p += 3;
    memcpy(p, cb, (size_t)cb_len);
    p += cb_len;
    *p++ = 0;
    p[0] = 'U';
    p[1] = 'B';
    p[2] = 'Z';
    p += 3;
    memcpy(p, umi, (size_t)umi_len);
    p += umi_len;
    *p++ = 0;
    return true;
  };
  for (int64_t i = 0; i < n; i++) {
    const char *nm = names + name_offs[i];
    int64_t nl = name_offs[i + 1] - name_offs[i];
    if (nl + 1 > 255) return -2;  // name too long for BAM's u8 l_read_name
    const char *cb = cbs + cb_offs[i];
    int64_t cl = cb_offs[i + 1] - cb_offs[i];
    const char *um = umis + umi_offs[i];
    int64_t ul = umi_offs[i + 1] - umi_offs[i];
    if (!emit(77, nm, nl, s1 + s1_offs[i], s1_offs[i + 1] - s1_offs[i],
              q1 + q1_offs[i], q1_offs[i + 1] - q1_offs[i], cb, cl, um, ul))
      return -1;
    if (!emit(141, nm, nl, s2 + s2_offs[i], s2_offs[i + 1] - s2_offs[i],
              q2 + q2_offs[i], q2_offs[i + 1] - q2_offs[i], cb, cl, um, ul))
      return -1;
  }
  return p - out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// K-mer index builder: library sequences -> the two-choice bucketed hash
// table + equivalence-class CSR + class bitsets consumed by
// nimble_tpu.index.builder (semantics-equivalent to the numpy build; class
// NUMBERING may differ but every k-mer decodes to the same feature set —
// differentially tested in tests/test_index.py). Replaces the ~6-minute
// numpy build of a 20k-allele library with seconds.
// The reference builds its index at aligner startup in Rust
// (rust-pseudoaligner lineage, SURVEY §2.8); this is the native
// equivalent feeding device-resident tensors.
//
// This VM's demand page-fault path costs ~130us/fault (Firecracker-style
// lazy memory), making fresh-memory writes ~70x slower than warm ones, so
// every large buffer is mmap'd with MAP_POPULATE and export destinations
// are bulk-populated with MADV_POPULATE_WRITE before writing.
// ---------------------------------------------------------------------------

#include <sys/mman.h>

#include <new>

#ifndef MADV_POPULATE_WRITE
#define MADV_POPULATE_WRITE 23
#endif

namespace {

constexpr int kIdxBucketSlots = 4;  // == builder.BUCKET_SLOTS
constexpr int kIdxStashSize = 8;    // == builder.STASH_SIZE

// STL allocator backed by mmap(MAP_POPULATE): pages are faulted in bulk by
// the kernel at allocation time instead of one ~130us fault per 4KB write.
template <class T>
struct PopAlloc {
  using value_type = T;
  PopAlloc() = default;
  template <class U>
  PopAlloc(const PopAlloc<U> &) {}
  T *allocate(size_t n) {
    void *p = mmap(nullptr, n * sizeof(T), PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_POPULATE, -1, 0);
    if (p == MAP_FAILED) throw std::bad_alloc();
    return (T *)p;
  }
  void deallocate(T *p, size_t n) { munmap(p, n * sizeof(T)); }
  template <class U>
  bool operator==(const PopAlloc<U> &) const {
    return true;
  }
  template <class U>
  bool operator!=(const PopAlloc<U> &) const {
    return false;
  }
};
template <class T>
using PopVec = std::vector<T, PopAlloc<T>>;

// Bulk-populate a caller-owned destination range before writing it.
static void nt_populate_write(void *p, size_t len) {
  const size_t page = 4096;
  uintptr_t a = (uintptr_t)p & ~(page - 1);
  size_t l = ((uintptr_t)p + len + page - 1 - a) & ~(page - 1);
  madvise((void *)a, l, MADV_POPULATE_WRITE);  // best-effort
}

// Must match nimble_tpu.index.hashing exactly (the device probes with it).
static inline uint32_t nt_mix32(uint32_t a, uint32_t b) {
  uint32_t x = a * 0x9E3779B1u + b;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

static inline void nt_bucket_hashes(uint32_t hi, uint32_t lo, uint32_t mask,
                                    uint32_t *h1, uint32_t *h2) {
  *h1 = nt_mix32(lo, hi) & mask;
  *h2 = nt_mix32(hi ^ 0xC2B2AE35u, lo ^ 0x85EBCA6Bu) & mask;
}

// Reverse-complement of a packed 2k-bit k-mer (first base in high bits),
// matching nimble_tpu.seq.revcomp_kmer_u64.
static inline uint64_t nt_revcomp64(uint64_t x, int k) {
  x = ~x;
  x = ((x & 0x3333333333333333ULL) << 2) | ((x >> 2) & 0x3333333333333333ULL);
  x = ((x & 0x0F0F0F0F0F0F0F0FULL) << 4) | ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL);
  x = __builtin_bswap64(x);
  return x >> (64 - 2 * k);
}

struct IndexBuild {
  int64_t n_buckets = 0;
  int64_t n_kmers = 0;
  int64_t bits_words = 1;
  PopVec<uint32_t> table_hi, table_lo;
  PopVec<int32_t> table_vsame, table_vdiff;
  uint32_t stash_hi[kIdxStashSize] = {0};
  uint32_t stash_lo[kIdxStashSize] = {0};
  int32_t stash_vsame[kIdxStashSize];
  int32_t stash_vdiff[kIdxStashSize];
  int stash_used = 0;
  PopVec<int64_t> class_offsets;   // n_classes + 1
  PopVec<int32_t> class_features;  // CSR payload, sorted within class
};

// Sequential two-choice greedy insertion (any placement the dual-bucket
// probe can find is valid; numpy's round-based order is not required).
// Returns false when more than kIdxStashSize keys fail to place.
static bool nt_fill_table(IndexBuild *ix, const PopVec<uint64_t> &canon,
                          const PopVec<int32_t> &vsame,
                          const PopVec<int32_t> &vdiff, int64_t n_buckets) {
  const int64_t n_slots = n_buckets * kIdxBucketSlots;
  ix->n_buckets = n_buckets;
  ix->table_hi.assign(n_slots, 0);
  ix->table_lo.assign(n_slots, 0);
  ix->table_vsame.assign(n_slots, -1);
  ix->table_vdiff.assign(n_slots, -1);
  ix->stash_used = 0;
  for (int s = 0; s < kIdxStashSize; s++) {
    ix->stash_hi[s] = 0;
    ix->stash_lo[s] = 0;
    ix->stash_vsame[s] = -1;
    ix->stash_vdiff[s] = -1;
  }
  PopVec<uint8_t> loads(n_buckets, 0);
  const uint32_t mask = (uint32_t)(n_buckets - 1);
  for (size_t i = 0; i < canon.size(); i++) {
    uint32_t hi = (uint32_t)(canon[i] >> 32);
    uint32_t lo = (uint32_t)canon[i];
    uint32_t h1, h2;
    nt_bucket_hashes(hi, lo, mask, &h1, &h2);
    uint32_t b = loads[h1] <= loads[h2] ? h1 : h2;
    if (loads[b] >= kIdxBucketSlots) b = (b == h1) ? h2 : h1;
    if (loads[b] < kIdxBucketSlots) {
      int64_t slot = (int64_t)b * kIdxBucketSlots + loads[b];
      ix->table_hi[slot] = hi;
      ix->table_lo[slot] = lo;
      ix->table_vsame[slot] = vsame[i];
      ix->table_vdiff[slot] = vdiff[i];
      loads[b]++;
    } else {
      if (ix->stash_used >= kIdxStashSize) return false;
      int s = ix->stash_used++;
      ix->stash_hi[s] = hi;
      ix->stash_lo[s] = lo;
      ix->stash_vsame[s] = vsame[i];
      ix->stash_vdiff[s] = vdiff[i];
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Build the k-mer index over n_seqs sequences (raw ASCII at seqs+offs[i],
// length seq_lens[i], feature id feature_ids[i]; feature ids are dense in
// [0, n_features)). hamming1 != 0 additionally maps every single-base
// variant of each reference k-mer to its feature (Config.num_mismatches >
// 0). Returns an opaque handle or NULL.
void *nt_index_build(const char *seqs, const int64_t *offs,
                     const int64_t *seq_lens, const int32_t *feature_ids,
                     int64_t n_seqs, int32_t k, int32_t hamming1,
                     int32_t n_features) {
  if (k < 1 || k > 31) return nullptr;
  const bool dbg = getenv("NT_INDEX_DEBUG") != nullptr;
  struct Clk {
    bool on;
    double t0;
    static double now() {
      struct timespec ts;
      clock_gettime(CLOCK_MONOTONIC, &ts);
      return ts.tv_sec + 1e-9 * ts.tv_nsec;
    }
    void lap(const char *what) {
      if (!on) return;
      double t = now();
      fprintf(stderr, "[nt_index] %-10s %.2fs\n", what, t - t0);
      t0 = t;
    }
  } clk{dbg, Clk::now()};
  const uint64_t kmask = (1ULL << (2 * k)) - 1;  // k <= 31 so 2k <= 62
  const int64_t expand = hamming1 ? (3 * (int64_t)k + 1) : 1;

  // per-sequence output offsets into the pair buffer (every window emits
  // `expand` entries; invalid windows emit sentinels, trimmed after sort)
  std::vector<int64_t> out_off(n_seqs + 1, 0);
  for (int64_t i = 0; i < n_seqs; i++) {
    int64_t w = seq_lens[i] >= k ? seq_lens[i] - k + 1 : 0;
    out_off[i + 1] = out_off[i] + w * expand;
  }
  const int64_t total = out_off[n_seqs];

  // packed (aug_code << 32 | feature): aug = canonical<<1 | not_canonical,
  // <= 63 bits for k <= 31. Sentinel = all-ones sorts last.
  PopVec<unsigned __int128> pairs(total);
  const unsigned __int128 kSentinel = ~(unsigned __int128)0;
  clk.lap("alloc");

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
  for (int64_t i = 0; i < n_seqs; i++) {
    const char *s = seqs + offs[i];
    const int64_t len = seq_lens[i];
    const uint32_t feat = (uint32_t)feature_ids[i];
    unsigned __int128 *out = pairs.data() + out_off[i];
    uint64_t code = 0;
    int run = 0;  // consecutive valid bases ending at current position
    for (int64_t p = 0; p < len; p++) {
      int8_t c = kLut.lut[(unsigned char)s[p]];
      run = (c == N_CODE) ? 0 : run + 1;
      code = ((code << 2) | (uint64_t)(c & 3)) & kmask;
      if (p < k - 1) continue;
      if (run < k) {
        for (int64_t e = 0; e < expand; e++) *out++ = kSentinel;
        continue;
      }
      for (int64_t e = 0; e < expand; e++) {
        uint64_t fwd = code;
        if (e > 0) {  // variant e-1: position (e-1)/3, delta 1 + (e-1)%3
          int64_t v = e - 1;
          fwd ^= (uint64_t)(1 + (v % 3)) << (2 * (v / 3));
        }
        uint64_t rc = nt_revcomp64(fwd, k);
        uint64_t canon = fwd <= rc ? fwd : rc;
        uint64_t aug = (canon << 1) | (uint64_t)(fwd > rc);
        *out++ = ((unsigned __int128)aug << 32) | feat;
      }
    }
  }
  clk.lap("enumerate");

#ifdef _OPENMP
  // balanced quicksort is in-place; the default multiway mergesort allocates
  // an O(n) temp buffer whose demand faults dominate on this VM
  __gnu_parallel::sort(pairs.begin(), pairs.end(),
                       std::less<unsigned __int128>(),
                       __gnu_parallel::balanced_quicksort_tag());
#else
  std::sort(pairs.begin(), pairs.end());
#endif
  clk.lap("sort");
  // trim sentinels, dedup (aug, feature) pairs
  pairs.erase(std::lower_bound(pairs.begin(), pairs.end(), kSentinel),
              pairs.end());
  pairs.erase(std::unique(pairs.begin(), pairs.end()), pairs.end());
  clk.lap("dedup");

  IndexBuild *ix = new IndexBuild();
  ix->bits_words = n_features > 0 ? (n_features + 31) / 32 : 1;

  // group runs of equal aug code -> exact-compare class interning
  // (hash of the sorted feature list -> candidate class ids -> memcmp)
  std::unordered_map<uint64_t, std::vector<int32_t>> class_by_hash;
  ix->class_offsets.push_back(0);
  const size_t npairs = pairs.size();
  ix->class_features.reserve(npairs ? npairs : 1);
  PopVec<uint64_t> aug_codes;  // unique aug codes in sorted order
  PopVec<int32_t> aug_class;   // class id per aug code
  aug_codes.reserve(npairs ? npairs : 1);
  aug_class.reserve(npairs ? npairs : 1);
  for (size_t i = 0; i < npairs;) {
    const uint64_t aug = (uint64_t)(pairs[i] >> 32);
    size_t j = i;
    uint64_t h = 1469598103934665603ULL;  // FNV-1a over the feature list
    for (; j < npairs && (uint64_t)(pairs[j] >> 32) == aug; j++) {
      h = (h ^ (uint64_t)(uint32_t)pairs[j]) * 1099511628211ULL;
    }
    const int64_t glen = (int64_t)(j - i);
    int32_t cls = -1;
    auto &cands = class_by_hash[h];
    for (int32_t c : cands) {
      const int64_t s0 = ix->class_offsets[c];
      if (ix->class_offsets[c + 1] - s0 != glen) continue;
      const int32_t *cf = ix->class_features.data() + s0;
      int64_t t = 0;
      while (t < glen && cf[t] == (int32_t)(uint32_t)pairs[i + t]) t++;
      if (t == glen) {
        cls = c;
        break;
      }
    }
    if (cls < 0) {
      cls = (int32_t)(ix->class_offsets.size() - 1);
      for (size_t t = i; t < j; t++) {
        ix->class_features.push_back((int32_t)(uint32_t)pairs[t]);
      }
      ix->class_offsets.push_back((int64_t)ix->class_features.size());
      cands.push_back(cls);
    }
    aug_codes.push_back(aug);
    aug_class.push_back(cls);
    i = j;
  }
  clk.lap("classes");
  pairs.clear();
  pairs.shrink_to_fit();

  // merge strand pairs: one entry per canonical code with (vsame, vdiff)
  PopVec<uint64_t> canon;
  PopVec<int32_t> vsame, vdiff;
  canon.reserve(aug_codes.size() ? aug_codes.size() : 1);
  vsame.reserve(aug_codes.size() ? aug_codes.size() : 1);
  vdiff.reserve(aug_codes.size() ? aug_codes.size() : 1);
  for (size_t i = 0; i < aug_codes.size(); i++) {
    uint64_t c = aug_codes[i] >> 1;
    if (canon.empty() || canon.back() != c) {
      canon.push_back(c);
      vsame.push_back(-1);
      vdiff.push_back(-1);
    }
    if (aug_codes[i] & 1) {
      vdiff.back() = aug_class[i];
    } else {
      vsame.back() = aug_class[i];
    }
  }
  ix->n_kmers = (int64_t)canon.size();

  // table sizing matches the numpy builder: load <= 0.5, power-of-two
  int64_t min_buckets =
      (ix->n_kmers * 2 + kIdxBucketSlots - 1) / kIdxBucketSlots;
  if (min_buckets < 1) min_buckets = 1;
  int log2b = 1;
  while ((1LL << log2b) < min_buckets) log2b++;
  int64_t n_buckets = 1LL << log2b;
  while (!nt_fill_table(ix, canon, vsame, vdiff, n_buckets)) n_buckets *= 2;
  clk.lap("table");
  return ix;
}

// sizes: [n_buckets, n_kmers, n_classes, class_features_len, stash_used,
//         bits_words]
void nt_index_sizes(void *handle, int64_t *out) {
  IndexBuild *ix = (IndexBuild *)handle;
  out[0] = ix->n_buckets;
  out[1] = ix->n_kmers;
  out[2] = (int64_t)ix->class_offsets.size() - 1;
  out[3] = (int64_t)ix->class_features.size();
  out[4] = ix->stash_used;
  out[5] = ix->bits_words;
}

// class_bits is (n_classes, bits_words) uint32, written here (scatter-OR
// over the CSR) because numpy's bitwise_or.at takes ~45s at 50M features.
void nt_index_export(void *handle, uint32_t *table_hi, uint32_t *table_lo,
                     int32_t *table_vsame, int32_t *table_vdiff,
                     uint32_t *stash_hi, uint32_t *stash_lo,
                     int32_t *stash_vsame, int32_t *stash_vdiff,
                     int64_t *class_offsets, int32_t *class_features,
                     uint32_t *class_bits) {
  IndexBuild *ix = (IndexBuild *)handle;
  const int64_t n_classes = (int64_t)ix->class_offsets.size() - 1;
  const int64_t words = ix->bits_words;
  nt_populate_write(table_hi, ix->table_hi.size() * 4);
  nt_populate_write(table_lo, ix->table_lo.size() * 4);
  nt_populate_write(table_vsame, ix->table_vsame.size() * 4);
  nt_populate_write(table_vdiff, ix->table_vdiff.size() * 4);
  nt_populate_write(class_offsets, ix->class_offsets.size() * 8);
  nt_populate_write(class_features, ix->class_features.size() * 4);
  nt_populate_write(class_bits, (size_t)(n_classes * words) * 4);
  memcpy(table_hi, ix->table_hi.data(), ix->table_hi.size() * 4);
  memcpy(table_lo, ix->table_lo.data(), ix->table_lo.size() * 4);
  memcpy(table_vsame, ix->table_vsame.data(), ix->table_vsame.size() * 4);
  memcpy(table_vdiff, ix->table_vdiff.data(), ix->table_vdiff.size() * 4);
  memcpy(stash_hi, ix->stash_hi, sizeof(ix->stash_hi));
  memcpy(stash_lo, ix->stash_lo, sizeof(ix->stash_lo));
  memcpy(stash_vsame, ix->stash_vsame, sizeof(ix->stash_vsame));
  memcpy(stash_vdiff, ix->stash_vdiff, sizeof(ix->stash_vdiff));
  memcpy(class_offsets, ix->class_offsets.data(),
         ix->class_offsets.size() * 8);
  memcpy(class_features, ix->class_features.data(),
         ix->class_features.size() * 4);
  memset(class_bits, 0, (size_t)(n_classes * words) * 4);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t c = 0; c < n_classes; c++) {
    uint32_t *row = class_bits + c * words;
    for (int64_t i = ix->class_offsets[c]; i < ix->class_offsets[c + 1]; i++) {
      int32_t f = ix->class_features[i];
      row[f >> 5] |= 1u << (f & 31);
    }
  }
}

void nt_index_free(void *handle) { delete (IndexBuild *)handle; }

}  // extern "C"

// ---------------------------------------------------------------------------
// TSV emission
// ---------------------------------------------------------------------------

namespace {

// Minimal signed itoa; returns the new write cursor.
inline char *put_int(char *p, int64_t v) {
  if (v < 0) {
    *p++ = '-';
    v = -v;
  }
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = '0' + (char)(v % 10);
    v /= 10;
  } while (v);
  while (n) *p++ = tmp[--n];
  return p;
}

// Fixed-width byte column (numpy S-dtype): item i at base + i*w, padded
// with NULs. Returns the new cursor after appending the logical string.
inline char *put_fixed(char *p, const char *base, int32_t w, int64_t i) {
  if (!base || w <= 0) return p;
  const char *s = base + (int64_t)w * i;
  int32_t n = 0;
  while (n < w && s[n]) n++;
  memcpy(p, s, n);
  return p + n;
}

}  // namespace

extern "C" {

// Format one collected span's passing rows as alignment-results TSV rows
// (align/pipeline.py TSV_HEADER; reference schema recovered in SURVEY §2.4):
//   features \t score \t cb \t umi \t cb \t umi \t pos1 \t pos2
//            \t r1_fwd \t r2_fwd \t gn \n
// The Python f-string loop emitted ~0.6M rows/s and sat on the pipeline's
// critical path; this loop runs >50M rows/s.
//
// uniq_id[i] indexes the deduplicated feature-string pool (feat_bytes +
// feat_offs, n_uniq+1 offsets) — the resolve step already dedups bitsets,
// so strings are materialized once per ambiguity class, not per read.
// cb/umi/gn are optional fixed-width numpy S-dtype columns (NULL = emit
// empty fields); pos1/pos2 optional int32 (NULL = empty fields, the
// reference's FASTQ-input behavior).
// Returns bytes written, or -1 if out_cap is too small.
// Deduplicated ambiguity-class resolution: for each unique bitset row
// (CSR: bounds/cols over the membership matrix, cols already group-mapped
// by the caller), sort its feature ids by LEXICOGRAPHIC NAME order
// (lexrank), dedup, apply the Config set-size filters, and emit the
// comma-joined name string. Replaces a per-row numpy unique + sorted +
// join loop that cost ~20 us/row on the emission critical path.
// names/name_offs are in lex order; lexrank maps
// feature id -> lex position. Returns bytes written to out, or -1 on
// overflow. out_offs has n_u+1 entries; dropped rows get empty strings.
int64_t nt_resolve_classes(int64_t n_u, const int64_t *bounds,
                           const int32_t *cols, const int32_t *lexrank,
                           const char *names, const int64_t *name_offs,
                           int32_t discard_multiple, int32_t discard_multi,
                           int32_t max_hits, uint8_t *keep, char *out,
                           int64_t out_cap, int64_t *out_offs) {
  char *p = out;
  char *end = out + out_cap;
  std::vector<int32_t> ranks;
  out_offs[0] = 0;
  for (int64_t i = 0; i < n_u; i++) {
    keep[i] = 0;
    const int64_t s = bounds[i], e = bounds[i + 1];
    if (e > s) {
      ranks.clear();
      for (int64_t j = s; j < e; j++) ranks.push_back(lexrank[cols[j]]);
      std::sort(ranks.begin(), ranks.end());
      ranks.erase(std::unique(ranks.begin(), ranks.end()), ranks.end());
      const int64_t k = (int64_t)ranks.size();
      const bool drop = (discard_multiple && k > 1) ||
                        (discard_multi > 0 && k > discard_multi) ||
                        (k > max_hits);
      if (!drop) {
        for (int64_t j = 0; j < k; j++) {
          const int32_t r = ranks[j];
          const int64_t len = name_offs[r + 1] - name_offs[r];
          if (p + len + 1 > end) return -1;
          if (j) *p++ = ',';
          memcpy(p, names + name_offs[r], (size_t)len);
          p += len;
        }
        keep[i] = 1;
      }
    }
    out_offs[i + 1] = p - out;
  }
  return p - out;
}

int64_t nt_format_rows(int64_t n_rows, const int32_t *uniq_id,
                       const uint8_t *keep, const char *feat_bytes,
                       const int64_t *feat_offs, const int32_t *score,
                       const int32_t *f1, const int32_t *f2, const char *cb,
                       int32_t cb_w, const char *umi, int32_t umi_w,
                       const char *gn, int32_t gn_w, const int32_t *pos1,
                       const int32_t *pos2, char *out, int64_t out_cap) {
  char *p = out;
  char *end = out + out_cap;
  for (int64_t i = 0; i < n_rows; i++) {
    if (!keep[i]) continue;
    const int32_t u = uniq_id[i];
    const int64_t flen = feat_offs[u + 1] - feat_offs[u];
    // worst-case row: feat + 2*(cb+umi) + gn + 5 ints (<=20 chars) + 11 seps
    if (p + flen + 2 * (cb_w + umi_w) + gn_w + 5 * 20 + 12 > end) return -1;
    memcpy(p, feat_bytes + feat_offs[u], flen);
    p += flen;
    *p++ = '\t';
    p = put_int(p, score[i]);
    *p++ = '\t';
    p = put_fixed(p, cb, cb_w, i);
    *p++ = '\t';
    p = put_fixed(p, umi, umi_w, i);
    *p++ = '\t';
    p = put_fixed(p, cb, cb_w, i);
    *p++ = '\t';
    p = put_fixed(p, umi, umi_w, i);
    *p++ = '\t';
    if (pos1) p = put_int(p, pos1[i]);
    *p++ = '\t';
    if (pos2) p = put_int(p, pos2[i]);
    *p++ = '\t';
    p = put_int(p, f1[i]);
    *p++ = '\t';
    p = put_int(p, f2[i]);
    *p++ = '\t';
    p = put_fixed(p, gn, gn_w, i);
    *p++ = '\n';
  }
  return p - out;
}

// Parallel BGZF compress: split data into 0xFF00-byte payload blocks
// (the BGZF maximum the python BgzfWriter uses), deflate each at level 6
// raw (-15) in an OpenMP parallel for, and concatenate the BGZF members
// into out. Byte-identical to BgzfWriter._flush_block on the same
// payloads (same zlib, same level/strategy) — this only moves the
// fastq-to-bam writer's serial compress off the consumer thread.
// Returns bytes written, or -1 on error / out_cap overflow.
int64_t nt_bgzf_compress(const uint8_t *data, int64_t n, uint8_t *out,
                         int64_t out_cap) {
  const int64_t kPayload = 0xFF00;
  if (n <= 0) return 0;
  int64_t nb = (n + kPayload - 1) / kPayload;
  std::vector<int64_t> csize(nb, -1);
  std::vector<std::vector<uint8_t>> comp(nb);
#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t i = 0; i < nb; i++) {
    const uint8_t *src = data + i * kPayload;
    int64_t plen = std::min(kPayload, n - i * kPayload);
    uLong bound = compressBound((uLong)plen) + 64;
    comp[i].resize(bound);
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, 6, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) !=
        Z_OK)
      continue;
    zs.next_in = (Bytef *)src;
    zs.avail_in = (uInt)plen;
    zs.next_out = comp[i].data();
    zs.avail_out = (uInt)bound;
    int rc = deflate(&zs, Z_FINISH);
    int64_t out_len = (int64_t)zs.total_out;
    deflateEnd(&zs);
    if (rc == Z_STREAM_END) csize[i] = out_len;
  }
  int64_t w = 0;
  for (int64_t i = 0; i < nb; i++) {
    if (csize[i] < 0) return -1;
    int64_t plen = std::min(kPayload, n - i * kPayload);
    int64_t bsize = csize[i] + 25 + 1;
    if (bsize - 1 > 0xFFFF || w + bsize > out_cap) return -1;
    uint8_t *h = out + w;
    static const uint8_t kHead[12] = {0x1F, 0x8B, 0x08, 0x04, 0, 0,
                                      0,    0,    0,    0xFF, 6, 0};
    memcpy(h, kHead, 12);
    h[12] = 'B';
    h[13] = 'C';
    h[14] = 2;
    h[15] = 0;
    uint16_t bs16 = (uint16_t)(bsize - 1);
    memcpy(h + 16, &bs16, 2);
    memcpy(h + 18, comp[i].data(), csize[i]);
    uint32_t crc =
        (uint32_t)crc32(crc32(0L, Z_NULL, 0), data + i * kPayload,
                        (uInt)plen);
    uint32_t is32 = (uint32_t)plen;
    memcpy(h + 18 + csize[i], &crc, 4);
    memcpy(h + 18 + csize[i] + 4, &is32, 4);
    w += bsize;
  }
  return w;
}

}  // extern "C"
