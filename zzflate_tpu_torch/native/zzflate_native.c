/* zzflate_tpu native runtime: fast host-side inflate + checksums.
 * zzflate_tpu_torch's own copy: the JAX package's file plus this line,
 * zzt_scan_members (every member of a gzip buffer in one scan; BGZF
 * members in ranges on threads, zzt_bgzf_hop and zzt_scan_members_split;
 * one stream's blocks in byte ranges on threads, zzt_scan_stream_split and
 * zzt_scan_gzip_split),
 * zzt_parse_headers (the block headers of the device decode's plan) and
 * zzt_plan_lengths/zzt_plan_header (the encoder's host Huffman plan).
 *
 * A from-scratch table-driven raw-DEFLATE decoder (RFC 1951) plus
 * Adler-32/CRC-32, written for the host side of the TPU codec: the device
 * owns encode; decode of arbitrary zlib/gzip streams is bit-serial by
 * nature, so it lives here as native code (the reference-class codec's C2 +
 * C17 components, SURVEY.md section 2). Built as a plain shared library,
 * bound via ctypes (no pybind11 in this image).
 *
 * Bit order: LSB-first within each byte; Huffman codes are MSB-first so the
 * decode tables are indexed by bit-reversed codes (SURVEY.md A.1).
 */
#include <stdint.h>
#include <stddef.h>
#include <string.h>
#include <stdlib.h>
#include <pthread.h>

#define ZZT_OK 0
#define ZZT_E_BTYPE (-1)
#define ZZT_E_STORED (-2)
#define ZZT_E_TABLE (-3)
#define ZZT_E_SYMBOL (-4)
#define ZZT_E_DIST (-5)
#define ZZT_E_OUTFULL (-6)
#define ZZT_E_INPUT (-7)
#define ZZT_E_AGAIN (-8) /* stream mode: need more input to finish a block */
#define ZZT_STOPPED 1 /* a scan reached its stop bit (scan_stream) */

/* ---------------- bit reader ---------------- */

typedef struct {
  const uint8_t *p, *end, *base;
  uint64_t acc;
  int n; /* bits valid in acc */
} bits_t;

static void br_init(bits_t *b, const uint8_t *in, size_t in_len,
                    size_t start_bit) {
  b->base = in;
  b->p = in + (start_bit >> 3);
  b->end = in + in_len;
  b->acc = 0;
  b->n = 0;
  if (b->p < b->end) {
    b->acc = (uint64_t)(*b->p++) >> (start_bit & 7);
    b->n = 8 - (int)(start_bit & 7);
  }
}

static inline void br_refill(bits_t *b) {
  if (b->n <= 56 && (size_t)(b->end - b->p) >= 8) {
    /* Branch-free bulk refill: one 64-bit load tops the accumulator up
     * to >= 56 valid bits; the cursor advances by the bytes consumed. */
    uint64_t chunk;
    memcpy(&chunk, b->p, 8);
    b->acc |= chunk << b->n;
    b->p += (63 - b->n) >> 3;
    b->n |= 56;
    return;
  }
  while (b->n <= 56 && b->p < b->end) {
    b->acc |= (uint64_t)(*b->p++) << b->n;
    b->n += 8;
  }
}

static inline uint32_t br_peek(bits_t *b, int k) {
  br_refill(b);
  return (uint32_t)(b->acc & ((1u << k) - 1));
}

static inline void br_consume(bits_t *b, int k) {
  b->acc >>= k;
  b->n -= k; /* may go negative past stream end; checked via br_pos */
}

static inline uint32_t br_get(bits_t *b, int k) {
  uint32_t v = br_peek(b, k);
  br_consume(b, k);
  return v;
}

static inline size_t br_pos(const bits_t *b) {
  return (size_t)(b->p - b->base) * 8 - (size_t)b->n;
}

static void br_align(bits_t *b) {
  int r = (int)(br_pos(b) & 7);
  if (r) br_consume(b, 8 - r);
}

/* ---------------- Huffman decode tables ---------------- */

/* Two-level decode table: a ROOT_BITS-wide root plus per-prefix
 * subtables for codes longer than ROOT_BITS. Root + pool fit in L1
 * (a flat 15-bit table is 128 KiB and misses constantly).
 * entry: (bits<<16) | sym ; bit 31 set => subtable link:
 *        0x80000000 | (subbits<<16) | pool_offset. 0 == invalid. */
#define ROOT_BITS 10
#define POOL_SIZE 4096

typedef struct {
  uint32_t root[1 << ROOT_BITS];
  uint32_t pool[POOL_SIZE];
} htab_t;

static int build_table(const uint8_t *lens, int n, htab_t *t) {
  int count[16] = {0};
  int i, l, max_len = 0;
  for (i = 0; i < n; i++) {
    if (lens[i] > 15) return ZZT_E_TABLE;
    count[lens[i]]++;
    if (lens[i] > max_len) max_len = lens[i];
  }
  memset(t->root, 0, sizeof(t->root));
  if (max_len == 0) return ZZT_OK; /* empty: legal for dist-free blocks */
  /* Kraft check: over-subscribed is an error; incomplete is legal only in
   * the 1-code case (DEFLATE allows a single distance code of length 1). */
  {
    int left = 1;
    for (l = 1; l <= 15; l++) {
      left <<= 1;
      left -= count[l];
      if (left < 0) return ZZT_E_TABLE;
    }
  }
  int first[16], code = 0;
  for (l = 1; l <= max_len; l++) {
    code = (code + count[l - 1]) << 1;
    first[l] = code;
  }
  int next[16];
  memcpy(next, first, sizeof(next));

  if (max_len > ROOT_BITS) {
    /* Pass 1: per-root-prefix deepest long code => subtable sizes. */
    uint8_t subbits[1 << ROOT_BITS];
    memset(subbits, 0, sizeof(subbits));
    int tmp[16];
    memcpy(tmp, first, sizeof(tmp));
    for (i = 0; i < n; i++) {
      l = lens[i];
      if (l <= ROOT_BITS) {
        if (l) tmp[l]++;
        continue;
      }
      uint32_t c = (uint32_t)tmp[l]++;
      uint32_t r = 0;
      for (int k = 0; k < l; k++) r |= ((c >> k) & 1u) << (l - 1 - k);
      uint32_t ridx = r & ((1u << ROOT_BITS) - 1);
      if (l - ROOT_BITS > subbits[ridx]) subbits[ridx] = (uint8_t)(l - ROOT_BITS);
    }
    uint32_t pool_used = 0;
    for (i = 0; i < (1 << ROOT_BITS); i++) {
      if (subbits[i]) {
        if (pool_used + (1u << subbits[i]) > POOL_SIZE) return ZZT_E_TABLE;
        t->root[i] = 0x80000000u | ((uint32_t)subbits[i] << 16) | pool_used;
        memset(t->pool + pool_used, 0, sizeof(uint32_t) << subbits[i]);
        pool_used += 1u << subbits[i];
      }
    }
  }

  for (i = 0; i < n; i++) {
    l = lens[i];
    if (!l) continue;
    uint32_t c = (uint32_t)next[l]++;
    uint32_t r = 0;
    for (int k = 0; k < l; k++) r |= ((c >> k) & 1u) << (l - 1 - k);
    uint32_t e = ((uint32_t)l << 16) | (uint32_t)i;
    if (l <= ROOT_BITS) {
      for (uint32_t idx = r; idx < (1u << ROOT_BITS); idx += 1u << l)
        t->root[idx] = e;
    } else {
      uint32_t ridx = r & ((1u << ROOT_BITS) - 1);
      uint32_t link = t->root[ridx];
      uint32_t sb = (link >> 16) & 0x7FFF;
      uint32_t base = link & 0xFFFF;
      for (uint32_t idx = r >> ROOT_BITS; idx < (1u << sb);
           idx += 1u << (l - ROOT_BITS))
        t->pool[base + idx] = e;
    }
  }
  return ZZT_OK;
}

static inline int decode_sym(bits_t *b, const htab_t *t) {
  br_refill(b);
  uint32_t bits = (uint32_t)(b->acc & 0x7FFF);
  uint32_t e = t->root[bits & ((1u << ROOT_BITS) - 1)];
  if (e & 0x80000000u) {
    uint32_t sb = (e >> 16) & 0x7FFF;
    e = t->pool[(e & 0xFFFF) + ((bits >> ROOT_BITS) & ((1u << sb) - 1))];
  }
  if (!e) return -1;
  br_consume(b, (int)(e >> 16));
  return (int)(e & 0xFFFF);
}

/* ---------------- DEFLATE constants (RFC 1951 / SURVEY.md A.2-A.5) ---- */

static const uint16_t LBASE[29] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13,
                                   15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
                                   67, 83, 99, 115, 131, 163, 195, 227, 258};
static const uint8_t LEXT[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
static const uint16_t DBASE[30] = {1, 2, 3, 4, 5, 7, 9, 13, 17, 25,
                                   33, 49, 65, 97, 129, 193, 257, 385, 513,
                                   769, 1025, 1537, 2049, 3073, 4097, 6145,
                                   8193, 12289, 16385, 24577};
static const uint8_t DEXT[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6,
                                 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12,
                                 13, 13};
static const uint8_t CLORD[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                  11, 4, 12, 3, 13, 2, 14, 1, 15};

static htab_t g_fixed_ll, g_fixed_d;
static int g_fixed_ready = 0;

static void init_fixed(void) {
  uint8_t lens[288];
  int i;
  for (i = 0; i < 144; i++) lens[i] = 8;
  for (; i < 256; i++) lens[i] = 9;
  for (; i < 280; i++) lens[i] = 7;
  for (; i < 288; i++) lens[i] = 8;
  build_table(lens, 288, &g_fixed_ll);
  for (i = 0; i < 30; i++) lens[i] = 5;
  build_table(lens, 30, &g_fixed_d);
  g_fixed_ready = 1;
}

/* ---------------- inflate ---------------- */

/* Decode a raw deflate stream.
 *   in/in_len/start_bit : input bitstream and starting bit offset
 *   out/out_cap         : output buffer; out[0..dict_len) must hold the
 *                         preset dictionary (back-reference context)
 *   dict_len            : bytes of dictionary already in `out`
 *   out_len (out)       : bytes produced AFTER the dictionary
 *   end_bit (out)       : bit position one past the final block
 *   stop_bytes          : if nonzero, return after >= this many output
 *                         bytes even without BFINAL (streaming support)
 *   stream              : nonzero enables incremental semantics: on input
 *                         exhaustion mid-block, return ZZT_E_AGAIN with
 *                         out_len/end_bit at the last COMPLETE block
 *                         boundary (the zlib.h:400 inflate() contract's
 *                         Z_OK-with-avail_in==0 state)
 *   bfinal_out          : if non-NULL, set to 1 iff decoding stopped at a
 *                         BFINAL block end
 * Returns ZZT_OK or a negative error. */
#define ZFAIL(code) do { rc = (code); goto zz_fail; } while (0)

static int inflate_core(const uint8_t *in, size_t in_len, size_t start_bit,
                        uint8_t *out, size_t out_cap, size_t dict_len,
                        size_t *out_len, size_t *end_bit, size_t stop_bytes,
                        int stream, uint32_t *bfinal_out) {
  bits_t b;
  size_t w = dict_len; /* write cursor into out */
  size_t chk_bit = start_bit, chk_w = dict_len; /* last block boundary */
  int rc;
  static __thread htab_t dyn_ll, dyn_d;

  if (bfinal_out) *bfinal_out = 0;
  if (!g_fixed_ready) init_fixed();
  br_init(&b, in, in_len, start_bit);

  for (;;) {
    uint32_t bfinal;
    chk_bit = br_pos(&b);
    chk_w = w;
    bfinal = br_get(&b, 1);
    uint32_t btype = br_get(&b, 2);
    const htab_t *ll, *dd;
    if (btype == 0) {
      br_align(&b);
      size_t pos = br_pos(&b) >> 3;
      if (pos + 4 > in_len) ZFAIL(ZZT_E_INPUT);
      uint32_t len = in[pos] | ((uint32_t)in[pos + 1] << 8);
      uint32_t nlen = in[pos + 2] | ((uint32_t)in[pos + 3] << 8);
      if ((len ^ nlen) != 0xFFFF) ZFAIL(ZZT_E_STORED);
      if (pos + 4 + len > in_len) ZFAIL(ZZT_E_INPUT);
      if (w + len > out_cap) ZFAIL(ZZT_E_OUTFULL);
      memcpy(out + w, in + pos + 4, len);
      w += len;
      br_init(&b, in, in_len, (pos + 4 + len) * 8);
      goto block_done;
    } else if (btype == 1) {
      ll = &g_fixed_ll;
      dd = &g_fixed_d;
    } else if (btype == 2) {
      uint32_t hlit = br_get(&b, 5) + 257;
      uint32_t hdist = br_get(&b, 5) + 1;
      uint32_t hclen = br_get(&b, 4) + 4;
      uint8_t cl_lens[19] = {0};
      uint8_t lens[288 + 32];
      uint32_t i;
      htab_t cl_tab;
      if (hlit > 286 || hdist > 30) ZFAIL(ZZT_E_TABLE);
      for (i = 0; i < hclen; i++) cl_lens[CLORD[i]] = (uint8_t)br_get(&b, 3);
      if (build_table(cl_lens, 19, &cl_tab) != ZZT_OK) ZFAIL(ZZT_E_TABLE);
      for (i = 0; i < hlit + hdist;) {
        int s = decode_sym(&b, &cl_tab);
        if (s < 0) ZFAIL(ZZT_E_SYMBOL);
        if (s < 16) {
          lens[i++] = (uint8_t)s;
        } else if (s == 16) {
          if (i == 0) ZFAIL(ZZT_E_TABLE);
          uint32_t r = 3 + br_get(&b, 2);
          uint8_t prev = lens[i - 1];
          if (i + r > hlit + hdist) ZFAIL(ZZT_E_TABLE);
          while (r--) lens[i++] = prev;
        } else {
          uint32_t r = (s == 17) ? 3 + br_get(&b, 3) : 11 + br_get(&b, 7);
          if (i + r > hlit + hdist) ZFAIL(ZZT_E_TABLE);
          while (r--) lens[i++] = 0;
        }
      }
      if (build_table(lens, (int)hlit, &dyn_ll) != ZZT_OK) ZFAIL(ZZT_E_TABLE);
      if (build_table(lens + hlit, (int)hdist, &dyn_d) != ZZT_OK)
        ZFAIL(ZZT_E_TABLE);
      ll = &dyn_ll;
      dd = &dyn_d;
    } else {
      ZFAIL(ZZT_E_BTYPE);
    }

    /* Hot token loop: one refill covers a full token (litlen <=15 +
     * len-extra <=5 + dist <=15 + dist-extra <=13 = 48 bits), so all
     * field extraction runs on the local accumulator without branches. */
    for (;;) {
      uint32_t e, s, len, dist;
      br_refill(&b);
      if (b.n < 48 && (size_t)(b.end - b.p) < 8 && br_pos(&b) > in_len * 8)
        ZFAIL(ZZT_E_INPUT);
      e = ll->root[(uint32_t)b.acc & ((1u << ROOT_BITS) - 1)];
      if (e & 0x80000000u) {
        uint32_t sb = (e >> 16) & 0x7FFF;
        e = ll->pool[(e & 0xFFFF) +
                     (((uint32_t)b.acc >> ROOT_BITS) & ((1u << sb) - 1))];
      }
      if (!e) ZFAIL(ZZT_E_SYMBOL);
      b.acc >>= (e >> 16);
      b.n -= (int)(e >> 16);
      s = e & 0xFFFF;
      if (s < 256) {
        if (w >= out_cap) ZFAIL(ZZT_E_OUTFULL);
        out[w++] = (uint8_t)s;
        /* Literal burst: keep decoding literals from the same refill
         * while >=15 accumulator bits remain (a code is <=15 bits). */
        while (b.n >= 15) {
          e = ll->root[(uint32_t)b.acc & ((1u << ROOT_BITS) - 1)];
          if (e & 0x80000000u) {
            uint32_t sb = (e >> 16) & 0x7FFF;
            e = ll->pool[(e & 0xFFFF) +
                         (((uint32_t)b.acc >> ROOT_BITS) & ((1u << sb) - 1))];
          }
          if (!e || (e & 0xFFFF) >= 256) break;
          if (w >= out_cap) ZFAIL(ZZT_E_OUTFULL);
          b.acc >>= (e >> 16);
          b.n -= (int)(e >> 16);
          out[w++] = (uint8_t)(e & 0xFFFF);
        }
        continue;
      }
      if (s == 256) break;
      {
        s -= 257;
        if (s >= 29) ZFAIL(ZZT_E_SYMBOL);
        len = LBASE[s] + ((uint32_t)b.acc & ((1u << LEXT[s]) - 1));
        b.acc >>= LEXT[s];
        b.n -= LEXT[s];
        {
        int ds;
        e = dd->root[(uint32_t)b.acc & ((1u << ROOT_BITS) - 1)];
        if (e & 0x80000000u) {
          uint32_t sb = (e >> 16) & 0x7FFF;
          e = dd->pool[(e & 0xFFFF) +
                       (((uint32_t)b.acc >> ROOT_BITS) & ((1u << sb) - 1))];
        }
        if (!e) ZFAIL(ZZT_E_SYMBOL);
        b.acc >>= (e >> 16);
        b.n -= (int)(e >> 16);
        ds = (int)(e & 0xFFFF);
        if (ds >= 30) ZFAIL(ZZT_E_SYMBOL);
        dist = DBASE[ds] + ((uint32_t)b.acc & ((1u << DEXT[ds]) - 1));
        b.acc >>= DEXT[ds];
        b.n -= DEXT[ds];
        }
        if (dist > w) ZFAIL(ZZT_E_DIST);
        if (w + len > out_cap) ZFAIL(ZZT_E_OUTFULL);
        {
          const uint8_t *src = out + w - dist;
          uint8_t *dst = out + w;
          if (dist >= len) {
            memcpy(dst, src, len);
          } else if (dist == 1) {
            memset(dst, src[0], len);
          } else if (dist >= 8 && w + ((len + 7u) & ~7u) <= out_cap) {
            /* Overlapping but with >= 8 bytes of slack: 8-byte strides
             * never read bytes written in the same stride. The rounded
             * tail stays inside out_cap (checked) and is overwritten by
             * the next token. */
            uint32_t k = 0;
            do {
              memcpy(dst + k, src + k, 8);
              k += 8;
            } while (k < len);
          } else {
            /* Small period: copy one period, then grow by doubling.
             * Each memcpy source [0,c) and target [filled,filled+c) are
             * disjoint (c <= filled), and `filled` stays a multiple of
             * dist except possibly on the final tail copy, which is
             * phase-aligned anyway. */
            uint32_t filled, c;
            for (filled = 0; filled < dist; filled++) dst[filled] = src[filled];
            while (filled < len) {
              c = filled < len - filled ? filled : len - filled;
              memcpy(dst + filled, dst, c);
              filled += c;
            }
          }
          w += len;
        }
      }
    }
  block_done:
    if (br_pos(&b) > in_len * 8) ZFAIL(ZZT_E_INPUT);
    if (bfinal) {
      if (bfinal_out) *bfinal_out = 1;
      break;
    }
    if (stop_bytes && w - dict_len >= stop_bytes) break;
  }
  *out_len = w - dict_len;
  *end_bit = br_pos(&b);
  return ZZT_OK;

zz_fail:
  /* Stream mode: an explicit input overrun, or any decode error raised
   * within a refill (64 bits) of the input end, means the current block
   * is incomplete -- report the last complete block boundary and ask for
   * more input. Errors strictly inside the available input are definitive
   * corruption (decode is prefix-deterministic). OUTFULL stays OUTFULL so
   * the caller can grow the buffer and retry. */
  if (stream && rc != ZZT_E_OUTFULL &&
      (rc == ZZT_E_INPUT || br_pos(&b) + 64 > in_len * 8)) {
    *out_len = chk_w - dict_len;
    *end_bit = chk_bit;
    if (bfinal_out) *bfinal_out = 0;
    return ZZT_E_AGAIN;
  }
  *out_len = w - dict_len;
  *end_bit = br_pos(&b);
  return rc;
}

int zzt_inflate(const uint8_t *in, size_t in_len, size_t start_bit,
                uint8_t *out, size_t out_cap, size_t dict_len,
                size_t *out_len, size_t *end_bit, size_t stop_bytes) {
  return inflate_core(in, in_len, start_bit, out, out_cap, dict_len, out_len,
                      end_bit, stop_bytes, 0, 0);
}

/* Incremental entry (SURVEY.md C18 decode side): decodes as many COMPLETE
 * blocks as the input allows; ZZT_E_AGAIN = feed more and call again from
 * *end_bit with out[0..dict_len) holding the last 32 KiB of output. */
int zzt_inflate_stream(const uint8_t *in, size_t in_len, size_t start_bit,
                       uint8_t *out, size_t out_cap, size_t dict_len,
                       size_t *out_len, size_t *end_bit, size_t stop_bytes,
                       uint32_t *bfinal_out) {
  return inflate_core(in, in_len, start_bit, out, out_cap, dict_len, out_len,
                      end_bit, stop_bytes, 1, bfinal_out);
}

/* ---------------- anchor pre-scan (device decode of foreign streams) ----
 *
 * Walk a raw deflate stream WITHOUT materializing output: record each
 * block's (start_bit, btype, out_start [, stored byte offset/len]) and
 * the (bit, out) position of every T-th token within each non-stored
 * block. The records are exactly what the TPU anchor-walk decoder needs
 * as lanes (models/inflate_tpu.py), so any zlib/gzip stream — not just
 * our own indexed output — can decode chunk-parallel on device after
 * this host scan (SURVEY.md C17: "per-block parallel decode" of
 * arbitrary streams). The scan is the token walk only: no LZ copies, no
 * byte writes — it needs only bit positions and output OFFSETS, so it
 * runs well above the full inflate's throughput and never allocates.
 *
 * blocks: 5 int64 per block  [start_bit, btype, out_start, aux0, aux1]
 *         (stored blocks: aux0 = payload byte offset in `in`, aux1 = len)
 * anchors: 2 int64 per anchor [bit, out]  (bit BEFORE the token's code)
 * Returns ZZT_OK, or ZZT_E_OUTFULL if a cap was too small (counts then
 * hold the required sizes; re-call with bigger buffers). */

/* Where a scan writes its records. bcols is 5, or 6 with the member in
 * the last column; acols is 2, or 3 with the index of the anchor's block
 * in the last column. Counts go on past a cap (overflow set). */
typedef struct {
  int64_t *blocks, *anchors;
  size_t bcap, acap, nb, na;
  int bcols, acols, overflow;
  int64_t member;
} scan_rec_t;

static void scan_block(scan_rec_t *r, size_t bit, uint32_t btype,
                       int64_t out, int64_t aux0, int64_t aux1) {
  if (r->nb < r->bcap) {
    int64_t *b = r->blocks + (size_t)r->bcols * r->nb;
    b[0] = (int64_t)bit;
    b[1] = (int64_t)btype;
    b[2] = out;
    b[3] = aux0;
    b[4] = aux1;
    if (r->bcols > 5) b[5] = r->member;
  } else {
    r->overflow = 1;
  }
  r->nb++;
}

static void scan_anchor(scan_rec_t *r, size_t bit, int64_t out) {
  if (r->na < r->acap) {
    int64_t *a = r->anchors + (size_t)r->acols * r->na;
    a[0] = (int64_t)bit;
    a[1] = out;
    if (r->acols > 2) a[2] = (int64_t)r->nb - 1;
  } else {
    r->overflow = 1;
  }
  r->na++;
}

/* A dynamic block's code lengths, its header read from b on (past BTYPE):
 * lens[0, *hlit + *hdist). ZZT_OK, or the scan's ZZT_E_TABLE or
 * ZZT_E_SYMBOL. */
static int read_lengths(bits_t *b, uint8_t *lens, uint32_t *hlit_out,
                        uint32_t *hdist_out) {
  uint32_t hlit = br_get(b, 5) + 257;
  uint32_t hdist = br_get(b, 5) + 1;
  uint32_t hclen = br_get(b, 4) + 4;
  uint8_t cl_lens[19] = {0};
  uint32_t i;
  htab_t cl_tab;
  if (hlit > 286 || hdist > 30) return ZZT_E_TABLE;
  for (i = 0; i < hclen; i++) cl_lens[CLORD[i]] = (uint8_t)br_get(b, 3);
  if (build_table(cl_lens, 19, &cl_tab) != ZZT_OK) return ZZT_E_TABLE;
  for (i = 0; i < hlit + hdist;) {
    int s = decode_sym(b, &cl_tab);
    if (s < 0) return ZZT_E_SYMBOL;
    if (s < 16) {
      lens[i++] = (uint8_t)s;
    } else if (s == 16) {
      uint32_t r16;
      uint8_t prev;
      if (i == 0) return ZZT_E_TABLE;
      r16 = 3 + br_get(b, 2);
      prev = lens[i - 1];
      if (i + r16 > hlit + hdist) return ZZT_E_TABLE;
      while (r16--) lens[i++] = prev;
    } else {
      uint32_t rz = (s == 17) ? 3 + br_get(b, 3) : 11 + br_get(b, 7);
      if (i + rz > hlit + hdist) return ZZT_E_TABLE;
      while (rz--) lens[i++] = 0;
    }
  }
  *hlit_out = hlit;
  *hdist_out = hdist;
  return ZZT_OK;
}

/* One raw deflate stream from start_bit to its final block, its records
 * appended to r with output offsets from out_base (dict_len bytes of
 * history precede its output). *out_len: the stream's output bytes;
 * *end_bit: the bit after its final block (also set on an error).
 *
 * A block that starts at or after stop_bit is left alone: ZZT_STOPPED,
 * *end_bit its first bit. With least non-NULL the window is unknown (a
 * range of a stream scanned from a block inside it): a distance past the
 * output so far fails nothing, and *least keeps the least output offset
 * that one reaches, for the caller to hold to the window once known. */
static int scan_stream(const uint8_t *in, size_t in_len, size_t start_bit,
                       size_t stop_bit, uint32_t T, size_t dict_len,
                       int64_t out_base, scan_rec_t *r, int64_t *least,
                       size_t *out_len, size_t *end_bit) {
  bits_t b;
  size_t w = dict_len;
  int rc;
  static __thread htab_t dyn_ll, dyn_d;

  if (!g_fixed_ready) init_fixed();
  br_init(&b, in, in_len, start_bit);

  for (;;) {
    uint32_t bfinal, btype;
    size_t blk_bit = br_pos(&b);
    const htab_t *ll, *dd;
    if (blk_bit >= stop_bit) ZFAIL(ZZT_STOPPED);
    bfinal = br_get(&b, 1);
    btype = br_get(&b, 2);
    if (btype == 0) {
      size_t pos;
      uint32_t len, nlen;
      br_align(&b);
      pos = br_pos(&b) >> 3;
      if (pos + 4 > in_len) ZFAIL(ZZT_E_INPUT);
      len = in[pos] | ((uint32_t)in[pos + 1] << 8);
      nlen = in[pos + 2] | ((uint32_t)in[pos + 3] << 8);
      if ((len ^ nlen) != 0xFFFF) ZFAIL(ZZT_E_STORED);
      if (pos + 4 + len > in_len) ZFAIL(ZZT_E_INPUT);
      scan_block(r, blk_bit, 0, out_base + (int64_t)(w - dict_len),
                 (int64_t)(pos + 4), (int64_t)len);
      w += len;
      br_init(&b, in, in_len, (pos + 4 + len) * 8);
      goto scan_block_done;
    } else if (btype == 1) {
      ll = &g_fixed_ll;
      dd = &g_fixed_d;
    } else if (btype == 2) {
      uint8_t lens[288 + 32];
      uint32_t hlit, hdist;
      rc = read_lengths(&b, lens, &hlit, &hdist);
      if (rc != ZZT_OK) goto zz_fail;
      if (build_table(lens, (int)hlit, &dyn_ll) != ZZT_OK) ZFAIL(ZZT_E_TABLE);
      if (build_table(lens + hlit, (int)hdist, &dyn_d) != ZZT_OK)
        ZFAIL(ZZT_E_TABLE);
      ll = &dyn_ll;
      dd = &dyn_d;
    } else {
      ZFAIL(ZZT_E_BTYPE);
    }

    scan_block(r, blk_bit, btype, out_base + (int64_t)(w - dict_len), 0, 0);

    {
      size_t tok = 0;
      for (;;) {
        uint32_t e, s, len, dist;
        br_refill(&b);
        if (b.n < 48 && (size_t)(b.end - b.p) < 8 && br_pos(&b) > in_len * 8)
          ZFAIL(ZZT_E_INPUT);
        if (T && tok && tok % T == 0)
          scan_anchor(r, br_pos(&b), out_base + (int64_t)(w - dict_len));
        e = ll->root[(uint32_t)b.acc & ((1u << ROOT_BITS) - 1)];
        if (e & 0x80000000u) {
          uint32_t sb = (e >> 16) & 0x7FFF;
          e = ll->pool[(e & 0xFFFF) +
                       (((uint32_t)b.acc >> ROOT_BITS) & ((1u << sb) - 1))];
        }
        if (!e) ZFAIL(ZZT_E_SYMBOL);
        b.acc >>= (e >> 16);
        b.n -= (int)(e >> 16);
        s = e & 0xFFFF;
        if (s < 256) {
          w++;
          tok++;
          continue;
        }
        if (s == 256) break;
        s -= 257;
        if (s >= 29) ZFAIL(ZZT_E_SYMBOL);
        len = LBASE[s] + ((uint32_t)b.acc & ((1u << LEXT[s]) - 1));
        b.acc >>= LEXT[s];
        b.n -= LEXT[s];
        {
          int ds;
          e = dd->root[(uint32_t)b.acc & ((1u << ROOT_BITS) - 1)];
          if (e & 0x80000000u) {
            uint32_t sb = (e >> 16) & 0x7FFF;
            e = dd->pool[(e & 0xFFFF) +
                         (((uint32_t)b.acc >> ROOT_BITS) & ((1u << sb) - 1))];
          }
          if (!e) ZFAIL(ZZT_E_SYMBOL);
          b.acc >>= (e >> 16);
          b.n -= (int)(e >> 16);
          ds = (int)(e & 0xFFFF);
          if (ds >= 30) ZFAIL(ZZT_E_SYMBOL);
          dist = DBASE[ds] + ((uint32_t)b.acc & ((1u << DEXT[ds]) - 1));
          b.acc >>= DEXT[ds];
          b.n -= DEXT[ds];
        }
        if (dist > w) {
          int64_t reach = out_base + (int64_t)(w - dict_len) - (int64_t)dist;
          if (!least) ZFAIL(ZZT_E_DIST);
          if (reach < *least) *least = reach;
        }
        w += len;
        tok++;
      }
    }
  scan_block_done:
    if (br_pos(&b) > in_len * 8) ZFAIL(ZZT_E_INPUT);
    if (bfinal) break;
  }
  rc = ZZT_OK;
zz_fail:
  *out_len = w - dict_len;
  *end_bit = br_pos(&b);
  return rc;
}

int zzt_scan_anchors(const uint8_t *in, size_t in_len, size_t start_bit,
                     uint32_t T, size_t dict_len,
                     int64_t *blocks, size_t blocks_cap,
                     int64_t *anchors, size_t anchors_cap,
                     size_t *nblocks, size_t *nanchors,
                     size_t *total_out, size_t *end_bit) {
  scan_rec_t r = {blocks, anchors, blocks_cap, anchors_cap, 0, 0, 5, 2, 0, 0};
  int rc = scan_stream(in, in_len, start_bit, SIZE_MAX, T, dict_len, 0, &r,
                       NULL, total_out, end_bit);
  *nblocks = r.nb;
  *nanchors = r.na;
  if (rc == ZZT_OK && r.overflow) rc = ZZT_E_OUTFULL;
  return rc;
}

/* ---------------- every member of a gzip buffer, in one pass ----------
 *
 * RFC 1952 members one after another (a `cat`-ed .gz file; BGZF, whose
 * members are at most 64 KiB): each member's header (FEXTRA, FNAME,
 * FCOMMENT, FHCRC skipped, as utils/containers.parse_gzip_header does),
 * its deflate body scanned as zzt_scan_anchors scans one stream, with an
 * empty window at its start (a distance before the member fails), and its
 * trailer. A member follows when the two bytes after a trailer are the
 * gzip magic; anything else after a trailer ends the buffer's members
 * (trailing bytes are tolerated, as gzip(1) tolerates them). All records
 * are in the buffer's coordinates: bits and bytes from its start, output
 * offsets in the members' concatenated output.
 *
 * members: 7 int64 per member [header_byte, body_byte, end_bit, out_start,
 *          out_len, crc32, isize] (end_bit: after its final block; crc32
 *          and isize read from its trailer)
 * blocks:  6 int64 per block, zzt_scan_anchors' five and the member
 * anchors: 3 int64 per anchor, [bit, out] and the index of its block
 * *crc: the CRC-32 of the concatenated output that the trailers state,
 *       the members' crc32 fields combined over their scanned lengths.
 * Returns ZZT_OK, ZZT_E_OUTFULL (a cap too small: counts hold the sizes),
 * ZZT_E_HEADER (a bad header; *nmembers is its member), ZZT_E_TRAILER (a
 * trailer cut off) or the scan's error, counts then as far as it got. */

#define ZZT_E_HEADER (-12)
#define ZZT_E_TRAILER (-13)

/* GF(2) polynomial product a * b modulo the CRC-32 polynomial, bit-reflected
 * (x^0 in the top bit), and x^(2^k) for k < 32: zlib 1.2.12's multmodp and
 * x2n_table, for crc32_combine. */
static uint32_t g_x2n[32];
static int g_x2n_ready = 0;

static uint32_t multmodp(uint32_t a, uint32_t b) {
  uint32_t m = 1u << 31, p = 0;
  for (;;) {
    if (a & m) {
      p ^= b;
      if ((a & (m - 1)) == 0) break;
    }
    m >>= 1;
    b = b & 1 ? (b >> 1) ^ 0xEDB88320u : b >> 1;
  }
  return p;
}

static void init_x2n(void) {
  uint32_t q = 1u << 30; /* x^1 */
  int n;
  g_x2n[0] = q;
  for (n = 1; n < 32; n++) g_x2n[n] = q = multmodp(q, q);
  g_x2n_ready = 1;
}

static uint32_t crc32_combine_c(uint32_t crc1, uint32_t crc2, uint64_t len2) {
  uint32_t p = 1u << 31; /* x^0 */
  unsigned k = 3;        /* len2 bytes: x^(8 len2) = x^(2^3 len2) */
  if (!g_x2n_ready) init_x2n();
  while (len2) {
    if (len2 & 1) p = multmodp(g_x2n[k & 31], p);
    len2 >>= 1;
    k++;
  }
  return multmodp(p, crc1) ^ crc2;
}

static inline uint32_t le32(const uint8_t *p) {
  return p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

/* A member's header at pos: ZZT_OK with *body its first body byte. */
static int gz_header(const uint8_t *in, size_t in_len, size_t pos,
                     size_t *body) {
  size_t p = pos + 10;
  uint8_t flg;
  if (pos + 10 > in_len || in[pos] != 0x1F || in[pos + 1] != 0x8B ||
      in[pos + 2] != 8)
    return ZZT_E_HEADER;
  flg = in[pos + 3];
  if (flg & 0x04) { /* FEXTRA */
    if (p + 2 > in_len) return ZZT_E_HEADER;
    p += 2 + (in[p] | ((size_t)in[p + 1] << 8));
  }
  if (flg & 0x08) { /* FNAME */
    while (p < in_len && in[p]) p++;
    if (p++ >= in_len) return ZZT_E_HEADER;
  }
  if (flg & 0x10) { /* FCOMMENT */
    while (p < in_len && in[p]) p++;
    if (p++ >= in_len) return ZZT_E_HEADER;
  }
  if (flg & 0x02) p += 2; /* FHCRC */
  if (p > in_len) return ZZT_E_HEADER;
  *body = p;
  return ZZT_OK;
}

/* A scan of one stream that takes the records of ranges scanned ahead
 * where it lands on their starts (chain_scan, below); NULL: no ranges. */
typedef struct chain chain_t;
static int chain_scan(chain_t *ch, const uint8_t *in, size_t in_len,
                      size_t bit, uint32_t T, size_t dict_len,
                      int64_t out_base, scan_rec_t *r, size_t *out_len,
                      size_t *end_bit);

/* The member whose header starts at pos: its header, its body scanned into
 * r from output offset out, its trailer at *tr (ZZT_E_TRAILER if cut). */
static int scan_member(chain_t *ch, const uint8_t *in, size_t in_len,
                       size_t pos, uint32_t T, int64_t out, scan_rec_t *r,
                       size_t *body, size_t *out_len, size_t *end_bit,
                       size_t *tr) {
  int rc = gz_header(in, in_len, pos, body);
  if (rc != ZZT_OK) return rc;
  rc = chain_scan(ch, in, in_len, *body * 8, T, 0, out, r, out_len,
                  end_bit);
  if (rc != ZZT_OK) return rc;
  *tr = (*end_bit + 7) >> 3;
  return *tr + 8 > in_len ? ZZT_E_TRAILER : ZZT_OK;
}

static void put_member(int64_t *m, size_t pos, size_t body, size_t end_bit,
                       int64_t out, size_t out_len, const uint8_t *trailer) {
  m[0] = (int64_t)pos;
  m[1] = (int64_t)body;
  m[2] = (int64_t)end_bit;
  m[3] = out;
  m[4] = (int64_t)out_len;
  m[5] = (int64_t)le32(trailer);
  m[6] = (int64_t)le32(trailer + 4);
}

/* zzt_scan_members' pass, its bodies through chain_scan. */
static int scan_gzip(chain_t *ch, const uint8_t *in, size_t in_len,
                     uint32_t T, scan_rec_t *r, int64_t *members,
                     size_t members_cap, size_t *nmembers, uint32_t *crc) {
  size_t pos = 0, nm = 0;
  int64_t out = 0;
  uint32_t c = 0;
  int rc;
  for (;;) {
    size_t body, out_len, end_bit, tr;
    r->member = (int64_t)nm;
    rc = scan_member(ch, in, in_len, pos, T, out, r, &body, &out_len,
                     &end_bit, &tr);
    if (rc != ZZT_OK) break;
    if (nm < members_cap)
      put_member(members + 7 * nm, pos, body, end_bit, out, out_len, in + tr);
    else
      r->overflow = 1;
    c = crc32_combine_c(c, le32(in + tr), out_len);
    out += (int64_t)out_len;
    nm++;
    pos = tr + 8;
    if (pos + 2 > in_len || in[pos] != 0x1F || in[pos + 1] != 0x8B) break;
  }
  *nmembers = nm;
  *crc = c;
  if (rc == ZZT_OK && r->overflow) rc = ZZT_E_OUTFULL;
  return rc;
}

int zzt_scan_members(const uint8_t *in, size_t in_len, uint32_t T,
                     int64_t *members, size_t members_cap,
                     int64_t *blocks, size_t blocks_cap,
                     int64_t *anchors, size_t anchors_cap,
                     size_t *nmembers, size_t *nblocks, size_t *nanchors,
                     uint32_t *crc) {
  scan_rec_t r = {blocks, anchors, blocks_cap, anchors_cap, 0, 0, 6, 3, 0, 0};
  int rc = scan_gzip(NULL, in, in_len, T, &r, members, members_cap,
                     nmembers, crc);
  *nblocks = r.nb;
  *nanchors = r.na;
  return rc;
}

/* ---------------- BGZF members, scanned in ranges at once -------------
 *
 * A BGZF member (SAMv1 4.1) states its own length: its FEXTRA field holds
 * a BC subfield (SLEN 2) with BSIZE, the member's length - 1. So its
 * members' starts come from a hop through the headers, with no decoding,
 * and contiguous ranges of members scan on a pool of threads, each
 * member's window being empty at its start.
 *
 * zzt_bgzf_hop: from byte 0, each member's header has the gzip magic, CM
 * 8, FEXTRA and a BC subfield (other subfields may come before or after
 * it) with BSIZE + 1 at least its header and trailer; the next member
 * starts at start + BSIZE + 1. The hop stops where zzt_scan_members stops:
 * at the end of the buffer, or where the two bytes after a member are not
 * the gzip magic. starts: the n members' starts and then the end of the
 * last (cap entries; every member takes 26 bytes or more, so in_len / 26
 * + 3 is room enough). Returns ZZT_OK, ZZT_E_HEADER (a member found that
 * is no such member) or ZZT_E_OUTFULL (cap too small). */

#define ZZT_E_SPLIT (-14)

int zzt_bgzf_hop(const uint8_t *in, size_t in_len, int64_t *starts,
                 size_t cap, size_t *n) {
  size_t pos = 0, k = 0;
  for (;;) {
    size_t q, end, bsize = 0;
    int found = 0;
    if (pos + 12 > in_len || in[pos] != 0x1F || in[pos + 1] != 0x8B ||
        in[pos + 2] != 8 || !(in[pos + 3] & 0x04))
      return ZZT_E_HEADER;
    q = pos + 12;
    end = q + (in[pos + 10] | ((size_t)in[pos + 11] << 8));
    if (end > in_len) return ZZT_E_HEADER;
    while (q + 4 <= end) {
      size_t slen = in[q + 2] | ((size_t)in[q + 3] << 8);
      if (q + 4 + slen > end) break;
      if (in[q] == 66 && in[q + 1] == 67 && slen == 2) {
        bsize = in[q + 4] | ((size_t)in[q + 5] << 8);
        found = 1;
        break;
      }
      q += 4 + slen;
    }
    if (!found || bsize + 1 < end - pos + 8) return ZZT_E_HEADER;
    if (k + 2 > cap) return ZZT_E_OUTFULL;
    starts[k++] = (int64_t)pos;
    pos += bsize + 1;
    if (pos + 2 > in_len || in[pos] != 0x1F || in[pos + 1] != 0x8B) break;
  }
  starts[k] = (int64_t)pos;
  *n = k;
  return ZZT_OK;
}

/* One range of members [m0, m1), or (zzt_scan_stream_split) of one
 * stream's blocks: scanned into records of its own, with output offsets
 * from 0; then copied into the caller's arrays at its bases. A range
 * allocates its records when a thread takes it. */
typedef struct {
  const uint8_t *in;
  size_t in_len, m0, m1;
  const int64_t *starts;
  uint32_t T, crc;
  int rc;
  scan_rec_t r;
  int64_t *mem, out;
  int64_t *members, *blocks, *anchors; /* the caller's rows at its bases */
  int64_t out_base, block_base, member_base;
  /* A range of a stream: its first byte, the bit its scan stops at (the
   * next range's cut), the block start found (SIZE_MAX: none), where its
   * scan ended, and the least output offset a distance reached. */
  size_t cut, stop, start, end;
  int64_t least;
} range_t;

/* More room for a range's records, as many rows as its counts say it
 * needs (they go on past a cap), and the counts back to nb0, na0. */
static int range_room(range_t *g, size_t nb0, size_t na0) {
  size_t bcap = 2 * g->r.bcap > g->r.nb ? 2 * g->r.bcap : g->r.nb;
  size_t acap = 2 * g->r.acap > g->r.na ? 2 * g->r.acap : g->r.na;
  int64_t *b = (int64_t *)realloc(g->r.blocks,
                                  bcap * (size_t)g->r.bcols * sizeof *b);
  int64_t *a;
  if (b) g->r.blocks = b;
  a = b ? (int64_t *)realloc(g->r.anchors,
                             acap * (size_t)g->r.acols * sizeof *a)
        : NULL;
  if (!a) return 1;
  g->r.anchors = a;
  g->r.bcap = bcap;
  g->r.acap = acap;
  g->r.nb = nb0;
  g->r.na = na0;
  g->r.overflow = 0;
  return ZZT_OK;
}

static int range_scan(range_t *g) {
  size_t m = g->m0, bytes = (size_t)(g->starts[g->m1] - g->starts[g->m0]);
  /* First room as the serial wrapper guesses it, for this range. */
  g->r.bcap = bytes / 8192 + (g->m1 - g->m0) + 64;
  g->r.acap = 8 * bytes / (g->T ? g->T : 1) + 64;
  g->r.bcols = 6;
  g->r.acols = 3;
  g->r.blocks = (int64_t *)malloc(g->r.bcap * 6 * sizeof(int64_t));
  g->r.anchors = (int64_t *)malloc(g->r.acap * 3 * sizeof(int64_t));
  g->mem = (int64_t *)malloc((g->m1 - g->m0) * 7 * sizeof(int64_t));
  g->rc = ZZT_E_SPLIT;
  if (!g->r.blocks || !g->r.anchors || !g->mem) return 1;
  while (m < g->m1) {
    size_t nb0 = g->r.nb, na0 = g->r.na, body, out_len, end_bit, tr;
    g->r.member = (int64_t)m;
    if (scan_member(NULL, g->in, g->in_len, (size_t)g->starts[m], g->T,
                    g->out, &g->r, &body, &out_len, &end_bit,
                    &tr) != ZZT_OK)
      return 1;
    if (g->r.overflow) { /* more room, and the member again */
      if (range_room(g, nb0, na0) != ZZT_OK) return 1;
      continue;
    }
    if ((int64_t)(tr + 8) != g->starts[m + 1]) return 1; /* BSIZE disagrees */
    put_member(g->mem + 7 * (m - g->m0), (size_t)g->starts[m], body, end_bit,
               g->out, out_len, g->in + tr);
    g->crc = crc32_combine_c(g->crc, le32(g->in + tr), out_len);
    g->out += (int64_t)out_len;
    m++;
  }
  g->rc = ZZT_OK;
  return 0;
}

/* A range's records into the caller's rows; none where the caller set no
 * rows (a stream's range that the join did not take). */
static int range_copy(range_t *g) {
  size_t i, bc = (size_t)g->r.bcols, ac = (size_t)g->r.acols;
  if (!g->blocks) return 0;
  if (g->m1 > g->m0) {
    memcpy(g->members, g->mem, (g->m1 - g->m0) * 7 * sizeof(int64_t));
    for (i = 0; i < g->m1 - g->m0; i++) g->members[7 * i + 3] += g->out_base;
  }
  memcpy(g->blocks, g->r.blocks, g->r.nb * bc * sizeof(int64_t));
  memcpy(g->anchors, g->r.anchors, g->r.na * ac * sizeof(int64_t));
  for (i = 0; i < g->r.nb; i++) {
    g->blocks[bc * i + 2] += g->out_base;
    if (bc > 5) g->blocks[bc * i + 5] += g->member_base;
  }
  for (i = 0; i < g->r.na; i++) {
    g->anchors[ac * i + 1] += g->out_base;
    if (ac > 2) g->anchors[ac * i + 2] += g->block_base;
  }
  return 0;
}

/* The ranges, taken in order by threads as each finishes its last, so a
 * range slower than the rest (denser data, a core shared with another
 * process) holds up no share fixed in advance. After fn returns nonzero
 * for a range, the rest are left alone. */
typedef struct {
  range_t *g;
  size_t n, next;
  int failed;
  int (*fn)(range_t *);
} pool_t;

static void *pool_work(void *arg) {
  pool_t *w = (pool_t *)arg;
  for (;;) {
    size_t k = __atomic_fetch_add(&w->next, 1, __ATOMIC_RELAXED);
    if (k >= w->n || __atomic_load_n(&w->failed, __ATOMIC_RELAXED)) break;
    if (w->fn(&w->g[k])) __atomic_store_n(&w->failed, 1, __ATOMIC_RELAXED);
  }
  return NULL;
}

/* fn on every range, on nthreads threads: the calling thread and
 * nthreads - 1 more (fewer where a thread cannot start). */
static void run_pool(range_t *g, size_t n, size_t nthreads, pthread_t *th,
                     int (*fn)(range_t *)) {
  pool_t w = {g, n, 0, 0, fn};
  size_t k, nt = 1;
  for (k = 1; k < nthreads; k++)
    if (pthread_create(&th[nt], NULL, pool_work, &w) == 0) nt++;
  pool_work(&w);
  for (k = 1; k < nt; k++) pthread_join(th[k], NULL);
}

/* zzt_scan_members' answer for a buffer whose nm members start at
 * starts[0..nm) (zzt_bgzf_hop's, starts[nm] the end of the last), the
 * members [cuts[k], cuts[k + 1]) of each of the nranges ranges scanned on
 * one of nthreads threads; every member's trailer has to end where the
 * next member starts (the last one's at starts[nm]). The same arrays,
 * counts and CRC-32 as zzt_scan_members; ZZT_E_OUTFULL as there (counts
 * hold the totals); ZZT_E_SPLIT where any range fails or disagrees with
 * the hop, which leaves the verdict to zzt_scan_members. */
int zzt_scan_members_split(const uint8_t *in, size_t in_len, uint32_t T,
                           const int64_t *starts, size_t nm,
                           const int64_t *cuts, size_t nranges,
                           size_t nthreads,
                           int64_t *members, size_t members_cap,
                           int64_t *blocks, size_t blocks_cap,
                           int64_t *anchors, size_t anchors_cap,
                           size_t *nmembers, size_t *nblocks,
                           size_t *nanchors, uint32_t *crc) {
  range_t *g = (range_t *)calloc(nranges, sizeof *g);
  pthread_t *th = (pthread_t *)calloc(nthreads ? nthreads : 1, sizeof *th);
  size_t k, nb = 0, na = 0;
  int64_t out = 0;
  uint32_t c = 0;
  int rc = ZZT_OK;
  /* The shared tables are built before any thread reads them: their
   * flags are not atomic. */
  if (!g_fixed_ready) init_fixed();
  if (!g_x2n_ready) init_x2n();
  if (!g || !th || nranges == 0 || cuts[0] != 0 ||
      (size_t)cuts[nranges] != nm)
    rc = ZZT_E_SPLIT;
  for (k = 0; rc == ZZT_OK && k < nranges; k++) {
    range_t *q = &g[k];
    q->in = in;
    q->in_len = in_len;
    q->m0 = (size_t)cuts[k];
    q->m1 = (size_t)cuts[k + 1];
    q->starts = starts;
    q->T = T;
    q->rc = ZZT_E_SPLIT; /* until a thread scans it */
    if (q->m1 <= q->m0) rc = ZZT_E_SPLIT;
  }
  if (rc == ZZT_OK) {
    run_pool(g, nranges, nthreads, th, range_scan);
    for (k = 0; k < nranges; k++) {
      if (g[k].rc != ZZT_OK) {
        rc = ZZT_E_SPLIT;
        break;
      }
      g[k].out_base = out;
      g[k].block_base = (int64_t)nb;
      g[k].members = members + 7 * g[k].m0;
      g[k].blocks = blocks + 6 * nb;
      g[k].anchors = anchors + 3 * na;
      c = crc32_combine_c(c, g[k].crc, (uint64_t)g[k].out);
      out += g[k].out;
      nb += g[k].r.nb;
      na += g[k].r.na;
    }
  }
  if (rc == ZZT_OK) {
    *nmembers = nm;
    *nblocks = nb;
    *nanchors = na;
    *crc = c;
    if (nm > members_cap || nb > blocks_cap || na > anchors_cap)
      rc = ZZT_E_OUTFULL;
    else
      run_pool(g, nranges, nthreads, th, range_copy);
  }
  for (k = 0; g && k < nranges; k++) {
    free(g[k].r.blocks);
    free(g[k].r.anchors);
    free(g[k].mem);
  }
  free(g);
  free(th);
  return rc;
}

/* ---------------- one deflate stream, scanned in ranges at once -------
 *
 * A deflate stream states no boundary inside it, but its scan needs no
 * window: it records bit positions and output offsets, and each block's
 * anchors count from the block's first token. So from a true block start a
 * scan gives the serial pass's records, their output offsets shifted by
 * one constant, save the check that no distance reaches before the window,
 * which waits for that constant.
 *
 * The input is cut at bytes. Each range looks from its cut for a bit where
 * a block could start (find_block; range 0 of one stream begins at its
 * first bit), scans from there with no window (scan_stream with least) and
 * stops at the first block start at or after the next range's cut. Then
 * chain_scan walks the stream from its first bit as the serial pass does:
 * where it stands on a range's start, that start is a true block start and
 * it takes the range's records, once the window is seen to hold every
 * distance, and goes on from the range's end; anywhere else (the finder
 * passed over a stored or fixed block, found what is no block, or a range
 * failed) it scans on itself up to the next range's start. So the answer
 * is the serial pass's whatever the ranges found; a range that found
 * nothing true costs its own work only. */

/* Bytes past its cut in which a range looks for a block start: zlib's
 * blocks are some 10-60 KB coded, so a start lies well inside; inside
 * stored data (level 0) a range gives up after this. */
#define SPLIT_SEARCH_BYTES ((size_t)256 << 10)

/* The bits of in from bit on, LSB first: 57 or more, zeros past its end. */
static inline uint64_t peek_at(const uint8_t *in, size_t in_len, size_t bit) {
  size_t p = bit >> 3, k;
  uint64_t v = 0;
  if (p + 8 <= in_len) {
    memcpy(&v, in + p, 8);
  } else {
    for (k = 0; p + k < in_len; k++) v |= (uint64_t)in[p + k] << (8 * k);
  }
  return v >> (bit & 7);
}

/* The first bit in [bit, lim) where a range may begin (SIZE_MAX: none): a
 * dynamic, non-final block header with hlit <= 286 and hdist <= 30, whose
 * code-length code and literal/length code are complete and give EOB a
 * length, one whole block decoding from it to EOB, and after it a header
 * that is not BTYPE 3. These filter the speculation and judge no stream:
 * a block they pass over the join scans, and a bit they let through that
 * starts no block the join never stands on. */
static size_t find_block(const uint8_t *in, size_t in_len, size_t bit,
                         size_t lim) {
  for (; bit < lim; bit++) {
    uint64_t v = peek_at(in, in_len, bit), cl;
    uint32_t hlit, hdist, hclen, i, kraft = 0;
    uint8_t lens[288 + 32];
    scan_rec_t none = {0};
    int64_t least = 0;
    size_t len, end;
    bits_t b;
    if ((v & 7) != 4 || ((v >> 3) & 31) > 29 || ((v >> 8) & 31) > 29)
      continue;
    hclen = (uint32_t)((v >> 13) & 15) + 4;
    cl = peek_at(in, in_len, bit + 17);
    for (i = 0; i < hclen; i++, cl >>= 3)
      if (cl & 7) kraft += 128u >> (cl & 7);
    if (kraft != 128) continue;
    br_init(&b, in, in_len, bit + 3);
    if (read_lengths(&b, lens, &hlit, &hdist) != ZZT_OK || !lens[256])
      continue;
    for (i = 0, kraft = 0; i < hlit; i++)
      if (lens[i]) kraft += 32768u >> lens[i];
    if (kraft != 32768) continue;
    if (scan_stream(in, in_len, bit, bit + 1, 0, 0, 0, &none, &least, &len,
                    &end) != ZZT_STOPPED ||
        ((peek_at(in, in_len, end) >> 1) & 3) == 3)
      continue;
    return bit;
  }
  return SIZE_MAX;
}

/* find_block, for the tests. */
size_t zzt_find_block(const uint8_t *in, size_t in_len, size_t bit,
                      size_t lim) {
  if (!g_fixed_ready) init_fixed();
  return find_block(in, in_len, bit, lim);
}

/* A range of a stream: its start (given, or found within
 * SPLIT_SEARCH_BYTES of its cut and before its stop), then its blocks
 * scanned with no window until the first block start at or after its stop
 * or a final block: rc ZZT_STOPPED or ZZT_OK, else it failed. */
static int stream_range(range_t *g) {
  size_t end = g->stop < 8 * g->in_len ? g->stop : 8 * g->in_len;
  size_t lim = 8 * (g->cut + SPLIT_SEARCH_BYTES) < end
                   ? 8 * (g->cut + SPLIT_SEARCH_BYTES) : end;
  size_t bytes = end / 8 - g->cut, len;
  if (g->start == SIZE_MAX)
    g->start = find_block(g->in, g->in_len, 8 * g->cut, lim);
  if (g->start == SIZE_MAX) return 0;
  /* First room as the serial wrapper guesses it, for this range. */
  g->r.bcap = bytes / 8192 + 64;
  g->r.acap = 8 * bytes / (g->T ? g->T : 1) + 64;
  g->r.blocks = (int64_t *)malloc(g->r.bcap * g->r.bcols * sizeof(int64_t));
  g->r.anchors = (int64_t *)malloc(g->r.acap * g->r.acols * sizeof(int64_t));
  if (!g->r.blocks || !g->r.anchors) return 0;
  for (;;) {
    g->least = 0;
    g->rc = scan_stream(g->in, g->in_len, g->start, g->stop, g->T, 0, 0,
                        &g->r, &g->least, &len, &g->end);
    if (!g->r.overflow) break;
    if (range_room(g, 0, 0) != ZZT_OK) { /* more room, and the range again */
      g->rc = ZZT_E_SPLIT;
      break;
    }
  }
  g->out = (int64_t)len;
  return 0;
}

struct chain {
  range_t *g;
  size_t n, next, nthreads, taken;
  pthread_t *th;
};

/* Range q's records at the end of r's: their rows reserved there, out its
 * first output offset; range_copy fills them once the chain is done. */
static void chain_take(range_t *q, scan_rec_t *r, int64_t out) {
  q->out_base = out;
  q->block_base = (int64_t)r->nb;
  q->member_base = r->member;
  if (r->nb + q->r.nb <= r->bcap && r->na + q->r.na <= r->acap) {
    q->blocks = r->blocks + (size_t)r->bcols * r->nb;
    q->anchors = r->anchors + (size_t)r->acols * r->na;
  } else {
    r->overflow = 1;
  }
  r->nb += q->r.nb;
  r->na += q->r.na;
}

/* scan_stream from bit (a block start) to the stream's final block, with no
 * stop: the same records, counts and code, the ranges' records taken where
 * it stands on their starts. ch NULL: scan_stream itself. */
static int chain_scan(chain_t *ch, const uint8_t *in, size_t in_len,
                      size_t bit, uint32_t T, size_t dict_len,
                      int64_t out_base, scan_rec_t *r, size_t *out_len,
                      size_t *end_bit) {
  size_t w = 0, len;
  int rc;
  if (!ch)
    return scan_stream(in, in_len, bit, SIZE_MAX, T, dict_len, out_base, r,
                       NULL, out_len, end_bit);
  for (;;) {
    range_t *q = NULL;
    /* The next range that scanned to its end from a start not behind. */
    while (ch->next < ch->n) {
      q = &ch->g[ch->next];
      if (q->rc >= ZZT_OK && q->start >= bit) break;
      ch->next++;
      q = NULL;
    }
    if (q && q->start == bit) {
      if ((int64_t)(dict_len + w) + q->least < 0) {
        q->rc = ZZT_E_DIST; /* a distance before the window: scan it here */
        continue;
      }
      ch->next++;
      ch->taken++;
      chain_take(q, r, out_base + (int64_t)w);
      w += (size_t)q->out;
      bit = q->end;
      rc = q->rc;
      if (rc == ZZT_OK) break; /* its last block was the final one */
      continue;
    }
    rc = scan_stream(in, in_len, bit, q ? q->start : SIZE_MAX, T,
                     dict_len + w, out_base + (int64_t)w, r, NULL, &len,
                     &bit);
    w += len;
    if (rc != ZZT_STOPPED) break;
  }
  *out_len = w;
  *end_bit = bit;
  return rc;
}

/* The ranges of a split scan made and scanned on nthreads threads: range k
 * >= 1 from byte cuts[k - 1], range 0 from start_bit's byte (beginning at
 * start_bit itself where exact), each stopping at the next one's cut.
 * ZZT_E_SPLIT where the cuts do not rise strictly inside (start_bit / 8,
 * in_len) or memory runs out. */
static int split_run(chain_t *ch, const uint8_t *in, size_t in_len,
                     size_t start_bit, int exact, uint32_t T, int bcols,
                     int acols, const int64_t *cuts, size_t ncuts,
                     size_t nthreads) {
  size_t k;
  memset(ch, 0, sizeof *ch);
  ch->n = ncuts + 1;
  ch->nthreads = nthreads;
  ch->g = (range_t *)calloc(ch->n, sizeof(range_t));
  ch->th = (pthread_t *)calloc(nthreads ? nthreads : 1, sizeof(pthread_t));
  if (!ch->g || !ch->th) return ZZT_E_SPLIT;
  for (k = 0; k < ch->n; k++) {
    range_t *q = &ch->g[k];
    q->in = in;
    q->in_len = in_len;
    q->T = T;
    q->r.bcols = bcols;
    q->r.acols = acols;
    q->cut = k ? (size_t)cuts[k - 1] : start_bit / 8;
    q->stop = k < ncuts ? 8 * (size_t)cuts[k] : SIZE_MAX;
    q->start = k || !exact ? SIZE_MAX : start_bit;
    q->rc = ZZT_E_SPLIT; /* until a thread scans it */
    if (k && (cuts[k - 1] <= (int64_t)ch->g[k - 1].cut ||
              (size_t)cuts[k - 1] >= in_len))
      return ZZT_E_SPLIT;
  }
  /* The shared tables are built before any thread reads them: their
   * flags are not atomic. */
  if (!g_fixed_ready) init_fixed();
  if (!g_x2n_ready) init_x2n();
  run_pool(ch->g, ch->n, nthreads, ch->th, stream_range);
  return ZZT_OK;
}

/* After the chain: the taken ranges' records copied (rc ZZT_OK), the ranges
 * freed. */
static void split_end(chain_t *ch, int rc) {
  size_t k;
  if (rc == ZZT_OK) run_pool(ch->g, ch->n, ch->nthreads, ch->th, range_copy);
  for (k = 0; ch->g && k < ch->n; k++) {
    free(ch->g[k].r.blocks);
    free(ch->g[k].r.anchors);
  }
  free(ch->g);
  free(ch->th);
}

/* zzt_scan_anchors' answer (the same arrays and counts; ZZT_E_OUTFULL as
 * there), the stream cut at the ncuts bytes cuts[] into ranges scanned on
 * nthreads threads; *taken: the ranges whose records it took. ZZT_E_SPLIT
 * where the cuts are out of order or memory runs out; on a corrupt stream
 * an error code, the verdict being the serial pass's to give. */
int zzt_scan_stream_split(const uint8_t *in, size_t in_len, size_t start_bit,
                          uint32_t T, size_t dict_len, const int64_t *cuts,
                          size_t ncuts, size_t nthreads,
                          int64_t *blocks, size_t blocks_cap,
                          int64_t *anchors, size_t anchors_cap,
                          size_t *nblocks, size_t *nanchors,
                          size_t *total_out, size_t *end_bit,
                          size_t *taken) {
  scan_rec_t r = {blocks, anchors, blocks_cap, anchors_cap, 0, 0, 5, 2, 0, 0};
  chain_t ch;
  int rc = split_run(&ch, in, in_len, start_bit, 1, T, 5, 2, cuts, ncuts,
                     nthreads);
  if (rc == ZZT_OK)
    rc = chain_scan(&ch, in, in_len, start_bit, T, dict_len, 0, &r,
                    total_out, end_bit);
  if (rc == ZZT_OK && r.overflow) rc = ZZT_E_OUTFULL;
  *taken = ch.taken;
  split_end(&ch, rc);
  *nblocks = r.nb;
  *nanchors = r.na;
  return rc;
}

/* zzt_scan_members' answer (the same arrays, counts and CRC-32;
 * ZZT_E_OUTFULL as there), the buffer cut at the ncuts bytes cuts[] into
 * ranges of its members' blocks, scanned on nthreads threads; range 0 too
 * looks for a block start, from byte 0. *taken, ZZT_E_SPLIT and errors as
 * zzt_scan_stream_split. */
int zzt_scan_gzip_split(const uint8_t *in, size_t in_len, uint32_t T,
                        const int64_t *cuts, size_t ncuts, size_t nthreads,
                        int64_t *members, size_t members_cap,
                        int64_t *blocks, size_t blocks_cap,
                        int64_t *anchors, size_t anchors_cap,
                        size_t *nmembers, size_t *nblocks, size_t *nanchors,
                        uint32_t *crc, size_t *taken) {
  scan_rec_t r = {blocks, anchors, blocks_cap, anchors_cap, 0, 0, 6, 3, 0, 0};
  chain_t ch;
  int rc = split_run(&ch, in, in_len, 0, 0, T, 6, 3, cuts, ncuts, nthreads);
  *nmembers = 0;
  if (rc == ZZT_OK)
    rc = scan_gzip(&ch, in, in_len, T, &r, members, members_cap, nmembers,
                   crc);
  *taken = ch.taken;
  split_end(&ch, rc);
  *nblocks = r.nb;
  *nanchors = r.na;
  return rc;
}

/* ---------------- block headers of the device decode's plan ----------
 *
 * Parse the headers of nb coded blocks into the canonical descriptors the
 * device decode takes per block (models/inflate_device.py): for each code,
 * first code, count and symbol offset per length 1..max_len (zero above),
 * and the symbols sorted by (length, symbol), zero-padded. It accepts and
 * rejects what models/inflate.py's _read_dynamic_tables and
 * CanonicalDecoder do, not what the scan above does: hlit up to 288 and
 * hdist up to 32, incomplete codes. A block's header may not read past
 * the end of its segment (ZZT_E_INPUT): the bit reader hands back zeros
 * there, so each read is followed by a position check, and a failed
 * symbol decode counts the max_len bits the Python decoder would read. */

#define ZZT_E_REPEAT (-9)  /* repeat code 16 with no previous length */
#define ZZT_E_LENRUN (-10) /* code lengths run past hlit + hdist */

/* Descriptors of the code with lengths lens[0..n); -1 if over-subscribed.
 * first/cnt/off are 16 wide, sym nsym wide (n <= nsym). */
static int hp_canon(const uint8_t *lens, int n, int nsym, int32_t *first,
                    int32_t *cnt, int32_t *off, int32_t *sym) {
  int count[16] = {0}, next[16];
  int s, l, max_len = 0, left = 1, code = 0, o = 0;
  for (s = 0; s < n; s++) {
    count[lens[s]]++;
    if (lens[s] > max_len) max_len = lens[s];
  }
  for (l = 1; l <= max_len; l++) {
    left = (left << 1) - count[l];
    if (left < 0) return -1;
  }
  memset(first, 0, 16 * sizeof(int32_t));
  memset(cnt, 0, 16 * sizeof(int32_t));
  memset(off, 0, 16 * sizeof(int32_t));
  memset(sym, 0, (size_t)nsym * sizeof(int32_t));
  for (l = 1; l <= max_len; l++) {
    first[l] = code;
    cnt[l] = count[l];
    off[l] = next[l] = o;
    code = (code + count[l]) << 1;
    o += count[l];
  }
  for (s = 0; s < n; s++)
    if (lens[s]) sym[next[lens[s]]++] = s;
  return max_len;
}

/* One symbol of a canonical code of at most 7 bits, read MSB-first one
 * bit a length as the Python decoder does; -1 (nothing consumed) if the
 * bits are no code. */
static int hp_decode(bits_t *b, const int32_t *first, const int32_t *cnt,
                     const int32_t *off, const int32_t *sym, int max_len) {
  uint32_t w = br_peek(b, 7);
  int l, code = 0;
  for (l = 1; l <= max_len; l++) {
    code = (code << 1) | (int)((w >> (l - 1)) & 1u);
    if (cnt[l] && code - first[l] < cnt[l]) {
      br_consume(b, l);
      return sym[off[l] + code - first[l]];
    }
  }
  return -1;
}

/* One block: the header from bit0 (its BFINAL bit), within [0, lim) bits.
 * desc: ll first, cnt, off, then d first, cnt, off, each 16 wide and
 * `stride` apart. */
static int hp_block(const uint8_t *in, size_t end, int64_t bit0,
                    int64_t *hdr_end, int32_t *desc, size_t stride,
                    int32_t *ll_sym, int32_t *d_sym) {
  const size_t lim = end * 8;
  uint8_t lens[288 + 32];
  uint32_t hlit, hdist, btype, i;
  bits_t b;
  if (bit0 < 0 || (size_t)bit0 + 3 > lim) return ZZT_E_INPUT;
  br_init(&b, in, end, (size_t)bit0);
  br_get(&b, 1);
  btype = br_get(&b, 2);
  if (btype == 1) {
    hlit = 288;
    hdist = 30;
    memset(lens, 8, 144);
    memset(lens + 144, 9, 112);
    memset(lens + 256, 7, 24);
    memset(lens + 280, 8, 8);
    memset(lens + 288, 5, 30);
  } else if (btype == 2) {
    uint8_t cl_lens[19] = {0};
    int32_t cf[16], cc[16], co[16], cs[19];
    uint32_t hclen;
    int cl_max;
    hlit = br_get(&b, 5) + 257;
    hdist = br_get(&b, 5) + 1;
    hclen = br_get(&b, 4) + 4;
    for (i = 0; i < hclen; i++) cl_lens[CLORD[i]] = (uint8_t)br_get(&b, 3);
    if (br_pos(&b) > lim) return ZZT_E_INPUT;
    cl_max = hp_canon(cl_lens, 19, 19, cf, cc, co, cs);
    if (cl_max < 0) return ZZT_E_TABLE;
    for (i = 0; i < hlit + hdist;) {
      uint32_t r;
      int s = hp_decode(&b, cf, cc, co, cs, cl_max);
      if (s < 0)
        return br_pos(&b) + (size_t)cl_max > lim ? ZZT_E_INPUT : ZZT_E_SYMBOL;
      if (br_pos(&b) > lim) return ZZT_E_INPUT;
      if (s < 16) {
        lens[i++] = (uint8_t)s;
        continue;
      }
      if (s == 16 && i == 0) return ZZT_E_REPEAT;
      r = s == 16 ? 3 + br_get(&b, 2)
                  : s == 17 ? 3 + br_get(&b, 3) : 11 + br_get(&b, 7);
      if (br_pos(&b) > lim) return ZZT_E_INPUT;
      if (i + r > hlit + hdist) return ZZT_E_LENRUN;
      memset(lens + i, s == 16 ? lens[i - 1] : 0, r);
      i += r;
    }
  } else {
    return ZZT_E_BTYPE;
  }
  if (hp_canon(lens, (int)hlit, 288, desc, desc + stride, desc + 2 * stride,
               ll_sym) < 0 ||
      hp_canon(lens + hlit, (int)hdist, 32, desc + 3 * stride,
               desc + 4 * stride, desc + 5 * stride, d_sym) < 0)
    return ZZT_E_TABLE;
  *hdr_end = (int64_t)br_pos(&b);
  return ZZT_OK;
}

/* Headers of nb blocks of `in`: block k starts at bit start_bits[k] and its
 * segment ends at byte end_bytes[k] (clamped to in_len). Outputs: hdr_end
 * (nb,) the bit of each block's first token; desc (6, nb, 16) int32, the
 * rows ll first, cnt, off, d first, cnt, off; ll_sym (nb, 288), d_sym
 * (nb, 32). Stops at the first bad block, whose index goes to *failed, and
 * returns its code (ZZT_E_INPUT: the header reads past its segment). */
int zzt_parse_headers(const uint8_t *in, size_t in_len,
                      const int64_t *start_bits, const int64_t *end_bytes,
                      size_t nb, int64_t *hdr_end, int32_t *desc,
                      int32_t *ll_sym, int32_t *d_sym, size_t *failed) {
  size_t k;
  for (k = 0; k < nb; k++) {
    int64_t e = end_bytes[k];
    size_t end = e < 0 ? 0 : (size_t)e < in_len ? (size_t)e : in_len;
    int rc = hp_block(in, end, start_bits[k], hdr_end + k, desc + 16 * k,
                      16 * nb, ll_sym + 288 * k, d_sym + 32 * k);
    if (rc != ZZT_OK) {
      *failed = k;
      return rc;
    }
  }
  return ZZT_OK;
}

/* ---------------- host Huffman plan ----------------
 * The encoder's tables for every block group of a batch in two calls
 * (ops/huffman_host.build_batch_plans): zzt_plan_lengths, the forcing
 * rules and the dynamic code lengths; zzt_plan_header, the header, the
 * dynamic-or-fixed choice and the codes. Each step follows the reference's
 * zzflate_tpu/ops/huffman_host.build_tables and code_lengths, so the
 * arrays equal its own bit for bit: a binary min-heap on the unique keys (weight, id),
 * leaves numbered in symbol order and internal nodes from nsyms up, depths
 * assigned top-down, the clamp and the Kraft repair, then the lengths
 * handed out by (freq asc, sym asc). zh_lengths (the host engine's) builds
 * by another rule and is not used here. */

#define ZZT_E_FIELDS (-11) /* the dynamic header needs more than `slots` */

typedef struct {
  int64_t w;
  int32_t id;
} pl_node_t;

static inline int pl_less(pl_node_t a, pl_node_t b) {
  return a.w < b.w || (a.w == b.w && a.id < b.id);
}

static void pl_sift_down(pl_node_t *h, int n, int i) {
  pl_node_t x = h[i];
  for (;;) {
    int c = 2 * i + 1;
    if (c >= n) break;
    if (c + 1 < n && pl_less(h[c + 1], h[c])) c++;
    if (!pl_less(h[c], x)) break;
    h[i] = h[c];
    i = c;
  }
  h[i] = x;
}

static pl_node_t pl_pop(pl_node_t *h, int *n) {
  pl_node_t top = h[0];
  h[0] = h[--*n];
  pl_sift_down(h, *n, 0);
  return top;
}

static void pl_push(pl_node_t *h, int *n, pl_node_t x) {
  int i = (*n)++;
  while (i > 0 && pl_less(x, h[(i - 1) / 2])) {
    h[i] = h[(i - 1) / 2];
    i = (i - 1) / 2;
  }
  h[i] = x;
}

typedef struct {
  int64_t f;
  int32_t s;
} pl_leaf_t;

static int pl_leaf_cmp(const void *a, const void *b) {
  const pl_leaf_t *x = (const pl_leaf_t *)a, *y = (const pl_leaf_t *)b;
  if (x->f != y->f) return x->f < y->f ? -1 : 1;
  return x->s < y->s ? -1 : x->s > y->s;
}

/* The reference's code_lengths: lengths of at most max_len (<= 15) bits for
 * the n <= 288 symbols of freq. */
static void pl_code_lengths(const int64_t *freq, int n, int max_len,
                            int32_t *len) {
  int32_t syms[288], kid[287][2], depth[2 * 288];
  pl_node_t heap[288];
  pl_leaf_t leaf[288];
  int64_t bl_count[16] = {0}, kraft = 0;
  int ns = 0, hn, nxt, i, l;
  for (i = 0; i < n; i++) {
    len[i] = 0;
    if (freq[i] != 0) syms[ns++] = i;
  }
  if (ns == 0) return;
  if (ns == 1) {
    len[syms[0]] = 1;
    return;
  }
  for (i = 0; i < ns; i++) {
    heap[i].w = freq[syms[i]];
    heap[i].id = i;
  }
  hn = ns;
  for (i = ns / 2 - 1; i >= 0; i--) pl_sift_down(heap, hn, i);
  for (nxt = ns; hn > 1; nxt++) {
    pl_node_t a = pl_pop(heap, &hn), b = pl_pop(heap, &hn), m;
    kid[nxt - ns][0] = a.id;
    kid[nxt - ns][1] = b.id;
    m.w = a.w + b.w;
    m.id = nxt;
    pl_push(heap, &hn, m);
  }
  depth[nxt - 1] = 0;
  for (i = nxt - 1; i >= ns; i--)
    depth[kid[i - ns][0]] = depth[kid[i - ns][1]] = depth[i] + 1;
  /* The clamped multiset and its Kraft sum in units of 2^-max_len. */
  for (i = 0; i < ns; i++) {
    int d = depth[i] < max_len ? depth[i] : max_len;
    bl_count[d]++;
    kraft += (int64_t)1 << (max_len - d);
  }
  while (kraft > ((int64_t)1 << max_len)) {
    int bits = 0;
    for (l = max_len - 1; l >= 1 && !bits; l--)
      if (bl_count[l] > 0) bits = l;
    if (!bits) break; /* unreachable: ns <= 288 < 2^max_len */
    bl_count[bits]--;
    bl_count[bits + 1] += 2;
    bl_count[max_len]--;
    kraft--;
  }
  for (i = 0; i < ns; i++) {
    leaf[i].f = freq[syms[i]];
    leaf[i].s = syms[i];
  }
  qsort(leaf, (size_t)ns, sizeof(pl_leaf_t), pl_leaf_cmp);
  for (i = 0, l = max_len; l >= 1; l--) {
    int64_t c;
    for (c = 0; c < bl_count[l]; c++) len[leaf[i++].s] = l;
  }
}

/* The reference's canonical_codes_lsb: canonical codes, bit-reversed. */
static void pl_codes_lsb(const int32_t *len, int n, uint32_t *code) {
  uint32_t bl_count[16] = {0}, next[16], c = 0;
  int s, b;
  for (s = 0; s < n; s++) bl_count[len[s]]++;
  bl_count[0] = 0;
  for (b = 1; b <= 15; b++) {
    c = (c + bl_count[b - 1]) << 1;
    next[b] = c;
  }
  for (s = 0; s < n; s++) {
    uint32_t v, r = 0;
    if (!len[s]) {
      code[s] = 0;
      continue;
    }
    v = next[len[s]]++;
    for (b = 0; b < len[s]; b++) r = (r << 1) | ((v >> b) & 1u);
    code[s] = r;
  }
}

/* The reference's cl_rle: (symbol, extra value, extra bits) of each entry;
 * returns the count (at most n). */
static int pl_cl_rle(const int32_t *lens, int n, uint8_t *sym, uint8_t *ev,
                     uint8_t *eb) {
  int i = 0, k = 0, prev = -1;
  while (i < n) {
    int cur = lens[i], run = 1, left, r;
    while (i + run < n && lens[i + run] == cur) run++;
    left = run;
    if (cur == 0) {
      for (; left >= 11; left -= r, k++) {
        r = left < 138 ? left : 138;
        sym[k] = 18, ev[k] = (uint8_t)(r - 11), eb[k] = 7;
      }
      for (; left >= 3; left -= r, k++) {
        r = left < 10 ? left : 10;
        sym[k] = 17, ev[k] = (uint8_t)(r - 3), eb[k] = 3;
      }
    } else {
      if (cur != prev) sym[k] = (uint8_t)cur, ev[k] = eb[k] = 0, k++, left--;
      for (; left >= 3; left -= r, k++) {
        r = left < 6 ? left : 6;
        sym[k] = 16, ev[k] = (uint8_t)(r - 3), eb[k] = 2;
      }
    }
    for (; left; left--, k++) sym[k] = (uint8_t)cur, ev[k] = eb[k] = 0;
    prev = cur;
    i += run;
  }
  return k;
}

static int pl_fixed_ll(int s) {
  return s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
}

/* The dynamic code lengths of ng block groups. freq_ll (ng, 288) and
 * freq_d (ng, 30): each group's summed histograms, EOB not yet counted.
 * Applies build_tables' forcing rules (EOB counted once, at least two
 * lit/len symbols and two distance codes), then writes ll_len (ng, 288)
 * and d_len (ng, 30) at 15 bits and body (ng, 2): the body's bits under
 * the fixed and under the dynamic codes. */
int zzt_plan_lengths(size_t ng, const int64_t *freq_ll, const int64_t *freq_d,
                     int32_t *ll_len, int32_t *d_len, int64_t *body) {
  size_t g;
  for (g = 0; g < ng; g++) {
    int64_t fl[288], fd[30], fix = 0, dyn = 0;
    int32_t *ll = ll_len + 288 * g, *d = d_len + 30 * g;
    int s, nl = 0, nd = 0;
    memcpy(fl, freq_ll + 288 * g, sizeof fl);
    memcpy(fd, freq_d + 30 * g, sizeof fd);
    fl[256] += 1;
    for (s = 0; s < 288; s++) nl += fl[s] > 0;
    if (nl < 2 && fl[0] < 1) fl[0] = 1;
    for (s = 0; s < 30; s++) nd += fd[s] > 0;
    if (nd < 1) fd[0] = 1, nd = 1;
    if (nd < 2) {
      int k = fd[0] > 0 ? 1 : 0;
      if (fd[k] < 1) fd[k] = 1;
    }
    pl_code_lengths(fl, 288, 15, ll);
    pl_code_lengths(fd, 30, 15, d);
    for (s = 0; s < 288; s++) {
      fix += fl[s] * pl_fixed_ll(s);
      dyn += fl[s] * ll[s];
    }
    for (s = 0; s < 30; s++) {
      fix += fd[s] * 5;
      dyn += fd[s] * d[s];
    }
    body[2 * g] = fix;
    body[2 * g + 1] = dyn;
  }
  return ZZT_OK;
}

/* The tables of ng block groups, written into the rows of the batch's
 * sub-blocks: group g covers rows [bounds[g], bounds[g + 1]). ll_dyn,
 * d_dyn and body are zzt_plan_lengths' outputs, all NULL for the fixed
 * codes in every group. Each group's header field stream (hdr_vals,
 * hdr_nbits; `slots` a row) goes to its first row, its EOB's code and
 * length to its last, its chosen lengths and LSB-first codes to every
 * row. The caller zeroes the outputs. A dynamic header of more than
 * `slots` fields stops the call: ZZT_E_FIELDS, the count in *nfields. */
int zzt_plan_header(size_t ng, const int32_t *ll_dyn, const int32_t *d_dyn,
                    const int64_t *body, const int64_t *bfinal,
                    const int64_t *bounds, size_t slots, int32_t *ll_len,
                    uint32_t *ll_code, int32_t *d_len, uint32_t *d_code,
                    uint32_t *hdr_vals, int32_t *hdr_nbits, uint32_t *eob_v,
                    int32_t *eob_nb, size_t *nfields) {
  int32_t fix_ll[288], fix_d[30];
  size_t g;
  int s;
  for (s = 0; s < 288; s++) fix_ll[s] = pl_fixed_ll(s);
  for (s = 0; s < 30; s++) fix_d[s] = 5;
  for (g = 0; g < ng; g++) {
    const int32_t *ll = fix_ll, *d = fix_d;
    int64_t r, r0 = bounds[g], r1 = bounds[g + 1];
    uint32_t *hv = hdr_vals + (size_t)r0 * slots;
    int32_t *hb = hdr_nbits + (size_t)r0 * slots;
    uint32_t llc[288], dc[30];
    int use_dyn = 0;
    if (ll_dyn) {
      const int32_t *ld = ll_dyn + 288 * g, *dd = d_dyn + 30 * g;
      int32_t comb[286 + 30], cl_len[19];
      uint32_t cl_code[19];
      int64_t fcl[19] = {0}, hdr_bits;
      uint8_t rs[286 + 30], re[286 + 30], rb[286 + 30];
      int hlit, hdist, hclen, nr, i;
      for (hlit = 286; hlit > 257 && !ld[hlit - 1]; hlit--) {
      }
      for (hdist = 30; hdist > 1 && !dd[hdist - 1]; hdist--) {
      }
      memcpy(comb, ld, (size_t)hlit * sizeof(int32_t));
      memcpy(comb + hlit, dd, (size_t)hdist * sizeof(int32_t));
      nr = pl_cl_rle(comb, hlit + hdist, rs, re, rb);
      for (i = 0; i < nr; i++) fcl[rs[i]]++;
      pl_code_lengths(fcl, 19, 7, cl_len);
      pl_codes_lsb(cl_len, 19, cl_code);
      for (hclen = 19; hclen > 4 && !cl_len[CLORD[hclen - 1]]; hclen--) {
      }
      hdr_bits = 3 + 14 + 3 * hclen;
      for (i = 0; i < nr; i++) hdr_bits += cl_len[rs[i]] + rb[i];
      if (hdr_bits + body[2 * g + 1] < 3 + body[2 * g]) {
        size_t nf = 5 + (size_t)hclen, f = 0;
        for (i = 0; i < nr; i++) nf += 1 + (rb[i] != 0);
        if (nf > slots) {
          *nfields = nf;
          return ZZT_E_FIELDS;
        }
        use_dyn = 1;
        ll = ld;
        d = dd;
#define PL_FIELD(v, n) (hv[f] = (uint32_t)(v), hb[f++] = (int32_t)(n))
        PL_FIELD(bfinal[g], 1);
        PL_FIELD(2, 2);
        PL_FIELD(hlit - 257, 5);
        PL_FIELD(hdist - 1, 5);
        PL_FIELD(hclen - 4, 4);
        for (i = 0; i < hclen; i++) PL_FIELD(cl_len[CLORD[i]], 3);
        for (i = 0; i < nr; i++) {
          PL_FIELD(cl_code[rs[i]], cl_len[rs[i]]);
          if (rb[i]) PL_FIELD(re[i], rb[i]);
        }
#undef PL_FIELD
      }
    }
    if (!use_dyn) {
      hv[0] = (uint32_t)bfinal[g];
      hb[0] = 1;
      hv[1] = 1; /* BTYPE=01 fixed */
      hb[1] = 2;
    }
    pl_codes_lsb(ll, 288, llc);
    pl_codes_lsb(d, 30, dc);
    for (r = r0; r < r1; r++) {
      memcpy(ll_len + 288 * r, ll, 288 * sizeof(int32_t));
      memcpy(ll_code + 288 * r, llc, sizeof llc);
      memcpy(d_len + 30 * r, d, 30 * sizeof(int32_t));
      memcpy(d_code + 30 * r, dc, sizeof dc);
    }
    eob_v[r1 - 1] = llc[256];
    eob_nb[r1 - 1] = ll[256];
  }
  return ZZT_OK;
}

/* ---------------- checksums ---------------- */

uint32_t zzt_adler32(uint32_t adler, const uint8_t *buf, size_t len) {
  const uint32_t MOD = 65521;
  uint32_t s1 = adler & 0xFFFF, s2 = (adler >> 16) & 0xFFFF;
  while (len) {
    size_t n = len < 5552 ? len : 5552; /* max before 32-bit overflow */
    len -= n;
    while (n >= 8) {
      s1 += buf[0]; s2 += s1; s1 += buf[1]; s2 += s1;
      s1 += buf[2]; s2 += s1; s1 += buf[3]; s2 += s1;
      s1 += buf[4]; s2 += s1; s1 += buf[5]; s2 += s1;
      s1 += buf[6]; s2 += s1; s1 += buf[7]; s2 += s1;
      buf += 8; n -= 8;
    }
    while (n--) { s1 += *buf++; s2 += s1; }
    s1 %= MOD;
    s2 %= MOD;
  }
  return (s2 << 16) | s1;
}

static uint32_t g_crc_tab[8][256];
static int g_crc_ready = 0;

static void init_crc(void) {
  for (int i = 0; i < 256; i++) {
    uint32_t c = (uint32_t)i;
    for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0xEDB88320u & (0u - (c & 1)));
    g_crc_tab[0][i] = c;
  }
  for (int t = 1; t < 8; t++)
    for (int i = 0; i < 256; i++)
      g_crc_tab[t][i] =
          (g_crc_tab[t - 1][i] >> 8) ^ g_crc_tab[0][g_crc_tab[t - 1][i] & 0xFF];
  g_crc_ready = 1;
}

uint32_t zzt_crc32(uint32_t crc, const uint8_t *buf, size_t len) {
  if (!g_crc_ready) init_crc();
  crc = ~crc;
  while (len >= 8) { /* slice-by-8 */
    uint32_t lo = crc ^ ((uint32_t)buf[0] | ((uint32_t)buf[1] << 8) |
                         ((uint32_t)buf[2] << 16) | ((uint32_t)buf[3] << 24));
    uint32_t hi = (uint32_t)buf[4] | ((uint32_t)buf[5] << 8) |
                  ((uint32_t)buf[6] << 16) | ((uint32_t)buf[7] << 24);
    crc = g_crc_tab[7][lo & 0xFF] ^ g_crc_tab[6][(lo >> 8) & 0xFF] ^
          g_crc_tab[5][(lo >> 16) & 0xFF] ^ g_crc_tab[4][lo >> 24] ^
          g_crc_tab[3][hi & 0xFF] ^ g_crc_tab[2][(hi >> 8) & 0xFF] ^
          g_crc_tab[1][(hi >> 16) & 0xFF] ^ g_crc_tab[0][hi >> 24];
    buf += 8;
    len -= 8;
  }
  while (len--) crc = (crc >> 8) ^ g_crc_tab[0][(crc ^ *buf++) & 0xFF];
  return ~crc;
}

/* ---------------------------------------------------------------------------
 * Optimal (shortest-bit-path) parse for the level-9 encoder.
 *
 * Classic DEFLATE cost-aware parsing (the reference-class codec's lazy
 * heuristic approximates this; SURVEY.md C7/Appendix B): given each
 * position's best available match (mlen, mdist) from the device matcher
 * and per-sub-block provisional code lengths, run a backward min-plus DP
 * over token bit costs.  At a position the choices are: emit the literal,
 * or emit a match of ANY length 3..mlen[i] at mdist[i] (shorter lengths at
 * the same distance are always valid sources).  Only one candidate length
 * per length-code class matters (all lengths in a class cost the same
 * bits), so each position checks <= 29 match candidates.
 *
 * Cost tables: ll_bits (nsb x 288) and d_bits (nsb x 30) Huffman code
 * lengths; a zero length means "symbol absent from the provisional tree"
 * and is priced at 30 bits so the DP can still elect it (the final trees
 * are rebuilt from the DP's token histogram afterwards).
 * ------------------------------------------------------------------------- */

static const int32_t g_lbase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 13,
                                    15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
                                    67, 83, 99, 115, 131, 163, 195, 227, 258};
static const int32_t g_lext[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2,
                                   2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5,
                                   0};
static const int32_t g_dbase[30] = {1,    2,    3,    4,    5,    7,    9,
                                    13,   17,   25,   33,   49,   65,   97,
                                    129,  193,  257,  385,  513,  769,  1025,
                                    1537, 2049, 3073, 4097, 6145, 8193, 12289,
                                    16385, 24577};
static const int32_t g_dext[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4,  4,  5,
                                   5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11,
                                   12, 12, 13, 13};

#define ZZT_ABSENT_BITS 30

int zzt_optimal_parse(const uint8_t *data, const int32_t *mlen,
                      const int32_t *mdist, int64_t n, int64_t start,
                      int64_t end, const int32_t *ll_bits,
                      const int32_t *d_bits, const int64_t *sub_bounds,
                      int nsb, uint8_t *committed, uint8_t *take,
                      int32_t *sel_len) {
  if (end > n || start > end || nsb < 1) return -1;
  uint32_t *cost = (uint32_t *)malloc((size_t)(end - start + 1) * 4);
  int32_t *choice = (int32_t *)malloc((size_t)(end - start) * 4);
  if (!cost || !choice) {
    free(cost);
    free(choice);
    return -2;
  }
#define COST(i) cost[(i) - start]
  COST(end) = 0;
  int sb = nsb - 1;
  for (int64_t i = end - 1; i >= start; i--) {
    while (sb > 0 && i < sub_bounds[sb]) sb--;
    const int32_t *llb = ll_bits + (size_t)sb * 288;
    const int32_t *db = d_bits + (size_t)sb * 30;
    int32_t lb = llb[data[i]];
    uint32_t best = (lb ? (uint32_t)lb : ZZT_ABSENT_BITS) + COST(i + 1);
    int32_t bl = 0;
    int32_t ml = mlen[i];
    if (ml >= 3) {
      int32_t d = mdist[i];
      int dc = 29;
      while (dc > 0 && g_dbase[dc] > d) dc--;
      int32_t dbits =
          (db[dc] ? db[dc] : ZZT_ABSENT_BITS) + g_dext[dc];
      if (ml > (int32_t)(end - i)) ml = (int32_t)(end - i);
      for (int c = 0; c < 29 && g_lbase[c] <= ml; c++) {
        int32_t top =
            (c < 28) ? g_lbase[c] + (1 << g_lext[c]) - 1 : 258;
        if (c == 27 && top > 257) top = 257; /* 258 is code 285 (c=28) */
        int32_t L = ml < top ? ml : top;
        int32_t sym = 257 + c;
        int32_t cb = llb[sym];
        uint32_t tc = (cb ? (uint32_t)cb : ZZT_ABSENT_BITS) +
                      (uint32_t)g_lext[c] + (uint32_t)dbits + COST(i + L);
        if (tc < best) {
          best = tc;
          bl = L;
        }
      }
    }
    COST(i) = best;
    choice[i - start] = bl;
  }
  memset(committed + start, 0, (size_t)(end - start));
  memset(take + start, 0, (size_t)(end - start));
  memset(sel_len + start, 0, (size_t)(end - start) * 4);
  for (int64_t i = start; i < end;) {
    int32_t bl = choice[i - start];
    committed[i] = 1;
    if (bl >= 3) {
      take[i] = 1;
      sel_len[i] = bl;
      i += bl;
    } else {
      i += 1;
    }
  }
  free(cost);
  free(choice);
  return 0;
}

/* ---------------------------------------------------------------------------
 * Deflate ENCODER (one-shot, host-side engine).
 *
 * The TPU pipeline (models/deflate_encoder.py) is the production encoder;
 * this native encoder serves payloads where a device dispatch is all
 * latency (small buffers, host-only callers) and completes the native
 * runtime alongside the inflate above.  Written from scratch against the
 * RFC 1951 contract (SURVEY.md Appendix A): hash-chain candidate lookup
 * with the classic good/lazy/nice/chain effort table (SURVEY.md Appendix
 * B), greedy (levels 1-3) or one-byte-defer lazy (4-9) commit, per-64 KiB
 * blocks with exact stored/fixed/dynamic cost choice, two-queue
 * length-limited Huffman (the huffman_host.py algorithm in C), CL-RLE
 * header, LSB-first bit packing.  Emits RAW deflate; containers are
 * byte-level host work (utils/containers.py).
 * ------------------------------------------------------------------------- */

/* ---- bit writer (LSB-first within each byte, SURVEY.md A.1) ---- */
typedef struct {
  uint8_t *out;
  size_t cap, pos;
  uint64_t acc;
  int nbits;
  int overflow;
} zw_t;

static void zw_init(zw_t *w, uint8_t *out, size_t cap) {
  w->out = out;
  w->cap = cap;
  w->pos = 0;
  w->acc = 0;
  w->nbits = 0;
  w->overflow = 0;
}

static inline void zw_drain(zw_t *w) {
  /* Flush whole accumulator bytes. Fast path: one unaligned 8-byte
   * little-endian store covers every pending byte at once (the writer
   * emits LSB-first, so byte k of the stream is acc bits [8k, 8k+8)). */
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  if (w->pos + 8 <= w->cap) {
    memcpy(w->out + w->pos, &w->acc, 8);
    int bytes = w->nbits >> 3;
    w->pos += (size_t)bytes;
    w->acc >>= bytes * 8;
    w->nbits &= 7;
    return;
  }
#endif
  while (w->nbits >= 8) {
    if (w->pos < w->cap)
      w->out[w->pos] = (uint8_t)w->acc;
    else
      w->overflow = 1;
    w->pos++;
    w->acc >>= 8;
    w->nbits -= 8;
  }
}

static inline void zw_put(zw_t *w, uint32_t v, int n) {
  w->acc |= (uint64_t)(v & ((n < 32 ? (1u << n) : 0u) - 1u)) << w->nbits;
  w->nbits += n;
  /* Callers pass at most 28 bits; draining at >= 36 keeps acc < 64. */
  if (w->nbits >= 36) zw_drain(w);
}

static void zw_align(zw_t *w) {
  if (w->nbits & 7) zw_put(w, 0, 8 - (w->nbits & 7));
  zw_drain(w); /* byte-aligned: leaves the accumulator empty */
}

/* ---- length-limited canonical code lengths ----
 * Two-queue merge over frequency-sorted leaves, then integer-Kraft
 * repair to the cap (same algorithm as ops/huffman_host.code_lengths). */
typedef struct {
  uint32_t freq;
  int sym;
} zh_leaf_t;

static int zh_leaf_cmp(const void *a, const void *b) {
  const zh_leaf_t *x = (const zh_leaf_t *)a, *y = (const zh_leaf_t *)b;
  if (x->freq != y->freq) return x->freq < y->freq ? -1 : 1;
  return x->sym - y->sym;
}

static void zh_lengths(const uint32_t *freq, int n, int cap, uint8_t *lens) {
  zh_leaf_t leaves[320];
  int used = 0;
  memset(lens, 0, (size_t)n);
  for (int s = 0; s < n; s++)
    if (freq[s]) {
      leaves[used].freq = freq[s];
      leaves[used].sym = s;
      used++;
    }
  if (used == 0) return;
  if (used == 1) {
    lens[leaves[0].sym] = 1;
    return;
  }
  qsort(leaves, (size_t)used, sizeof(zh_leaf_t), zh_leaf_cmp);

  /* Two-queue merge: leaves (sorted) + internal nodes (created in
   * non-decreasing weight order -> a FIFO).  nodes[k] = weight; par[k]
   * = parent index (into the internal array, offset by `used`). */
  uint64_t iw[640];
  int ipar[640], lpar[320];
  int li = 0, ii_head = 0, ii_tail = 0;
  for (int t = 0; t < used - 1; t++) { /* exactly used-1 internal nodes */
    uint64_t w2 = 0;
    int kids[2];
    for (int k = 0; k < 2; k++) {
      int take_leaf =
          li < used &&
          (ii_head >= ii_tail || leaves[li].freq <= iw[ii_head]);
      if (take_leaf) {
        kids[k] = li; /* leaf id */
        li++;
      } else {
        kids[k] = used + ii_head; /* internal id */
        ii_head++;
      }
      w2 += kids[k] < used ? (uint64_t)leaves[kids[k]].freq
                           : iw[kids[k] - used];
    }
    iw[ii_tail] = w2;
    ipar[ii_tail] = -1;
    for (int k = 0; k < 2; k++) {
      if (kids[k] < used)
        lpar[kids[k]] = ii_tail;
      else
        ipar[kids[k] - used] = ii_tail;
    }
    ii_tail++;
  }
  /* Depth of each internal node (root = last created, depth 0). */
  int idep[640];
  idep[ii_tail - 1] = 0;
  for (int k = ii_tail - 2; k >= 0; k--) idep[k] = idep[ipar[k]] + 1;
  int over = 0;
  for (int l = 0; l < used; l++) {
    int d = idep[lpar[l]] + 1;
    if (d > cap) {
      d = cap;
      over = 1;
    }
    lens[leaves[l].sym] = (uint8_t)d;
  }
  if (!over) return;

  /* Integer-Kraft repair: units of 2^(cap - len); budget 2^cap.  Deepen
   * the shallowest-cost symbols (smallest freq at len < cap) until the
   * code fits, then try to shorten from the most frequent down. */
  int64_t budget = (int64_t)1 << cap;
  int64_t ksum = 0;
  for (int l = 0; l < used; l++)
    ksum += (int64_t)1 << (cap - lens[leaves[l].sym]);
  /* leaves[] is sorted by ascending freq: lengthen cheap symbols first. */
  while (ksum > budget) {
    for (int l = 0; l < used && ksum > budget; l++) {
      int s = leaves[l].sym;
      if (lens[s] < cap) {
        ksum -= (int64_t)1 << (cap - lens[s] - 1);
        lens[s]++;
      }
    }
  }
  /* Give back slack to the most frequent symbols (optimality polish). */
  for (int l = used - 1; l >= 0; l--) {
    int s = leaves[l].sym;
    while (lens[s] > 1 &&
           ksum + ((int64_t)1 << (cap - lens[s])) <= budget) {
      ksum += (int64_t)1 << (cap - lens[s]);
      lens[s]--;
    }
  }
}

/* Canonical codes from lengths (RFC 1951 3.2.2), bit-reversed for the
 * LSB-first writer. */
static void zh_codes(const uint8_t *lens, int n, uint16_t *codes) {
  int bl_count[16] = {0};
  for (int s = 0; s < n; s++) bl_count[lens[s]]++;
  bl_count[0] = 0;
  uint32_t next[16] = {0};
  uint32_t code = 0;
  for (int b = 1; b <= 15; b++) {
    code = (code + (uint32_t)bl_count[b - 1]) << 1;
    next[b] = code;
  }
  for (int s = 0; s < n; s++) {
    int l = lens[s];
    if (!l) {
      codes[s] = 0;
      continue;
    }
    uint32_t c = next[l]++;
    uint32_t r = 0;
    for (int b = 0; b < l; b++) r = (r << 1) | ((c >> b) & 1u);
    codes[s] = (uint16_t)r;
  }
}

/* ---- dynamic block header: CL-RLE the lens, code the 19-sym CL
 * alphabet, emit HLIT/HDIST/HCLEN + CL lens in the magic order
 * (SURVEY.md A.4).  Returns header cost in bits via *bits (codes==NULL
 * prices without writing). ---- */
static void zh_cl_rle(const uint8_t *lens, int n, uint8_t *rle_sym,
                      uint8_t *rle_extra, int *rle_n) {
  int m = 0, i = 0;
  while (i < n) {
    uint8_t v = lens[i];
    int run = 1;
    while (i + run < n && lens[i + run] == v) run++;
    i += run;
    if (v == 0) {
      while (run >= 3) {
        int take = run > 138 ? 138 : run;
        if (take >= 11) {
          rle_sym[m] = 18;
          rle_extra[m++] = (uint8_t)(take - 11);
        } else {
          rle_sym[m] = 17;
          rle_extra[m++] = (uint8_t)(take - 3);
        }
        run -= take;
      }
      while (run-- > 0) {
        rle_sym[m] = 0;
        rle_extra[m++] = 0;
      }
    } else {
      rle_sym[m] = v;
      rle_extra[m++] = 0;
      run--;
      while (run >= 3) {
        int take = run > 6 ? 6 : run;
        rle_sym[m] = 16;
        rle_extra[m++] = (uint8_t)(take - 3);
        run -= take;
      }
      while (run-- > 0) {
        rle_sym[m] = v;
        rle_extra[m++] = 0;
      }
    }
  }
  *rle_n = m;
}

/* ---- fixed-tree lengths (SURVEY.md A.5) ---- */
static void zd_fixed_lens(uint8_t *ll, uint8_t *d) {
  int i;
  for (i = 0; i < 144; i++) ll[i] = 8;
  for (; i < 256; i++) ll[i] = 9;
  for (; i < 280; i++) ll[i] = 7;
  for (; i < 288; i++) ll[i] = 8;
  for (i = 0; i < 30; i++) d[i] = 5;
}

/* length (3..258) -> length code 0..28; dist -> dist code 0..29 */
static uint8_t g_len2code[259];
static int g_len2code_ready = 0;
static void zd_init_len2code(void) {
  for (int c = 0; c < 29; c++) {
    int lo = LBASE[c];
    int hi = (c < 28) ? LBASE[c] + (1 << LEXT[c]) - 1 : 258;
    if (c == 27 && hi > 257) hi = 257; /* 258 belongs to code 285 */
    for (int L = lo; L <= hi && L <= 258; L++) g_len2code[L] = (uint8_t)c;
  }
  g_len2code[258] = 28;
  g_len2code_ready = 1;
}

/* dist -> code via two 256-entry tables: dist 1..256 direct, 257..32768
 * by (dist-1)>>7 (every 128-wide slot above 256 maps to one code). */
static uint8_t g_dcode_lo[256], g_dcode_hi[256];
static int g_dcode_ready = 0;
static void zd_init_dcode(void) {
  for (int d = 1; d <= 32768; d++) {
    int lo = 0, hi = 29;
    while (lo < hi) {
      int mid = (lo + hi + 1) >> 1;
      if (DBASE[mid] <= d) lo = mid;
      else hi = mid - 1;
    }
    if (d <= 256) g_dcode_lo[d - 1] = (uint8_t)lo;
    else if (((d - 1) & 127) == 0 || d == 32768)
      g_dcode_hi[(d - 1) >> 7] = (uint8_t)lo;
  }
  g_dcode_ready = 1;
}

static inline int zd_dist_code(int dist) {
  return dist <= 256 ? g_dcode_lo[dist - 1] : g_dcode_hi[(dist - 1) >> 7];
}

/* Eagerly build every lazily-initialized global table at library load.
 * deflate_raw_mt runs zzt_deflate on a thread pool; the plain int
 * ready-flags above are not a safe publication protocol for concurrent
 * first use (on weakly-ordered CPUs a worker could observe the flag
 * before the table stores), so all init happens here, single-threaded,
 * before any API call. The lazy checks remain as a fallback for static
 * linking setups that skip constructors. */
__attribute__((constructor)) static void zzt_init_tables(void) {
  if (!g_fixed_ready) init_fixed();
  if (!g_crc_ready) init_crc();
  if (!g_len2code_ready) zd_init_len2code();
  if (!g_dcode_ready) zd_init_dcode();
}

/* One block's tokens. */
typedef struct {
  uint16_t *len;  /* 0 => literal */
  uint16_t *dist;
  uint8_t *lit;
  int ntok;
} zblk_t;

/* Emit one block (choosing stored/fixed/dynamic by exact bit cost). */
static void zd_emit_block(zw_t *w, const uint8_t *buf, int64_t in_start,
                          int64_t in_end, const zblk_t *blk, int final,
                          int force_fixed) {
  uint32_t fll[288] = {0}, fd[30] = {0};
  uint64_t extra_bits = 0;
  if (!g_len2code_ready) zd_init_len2code();
  if (!g_dcode_ready) zd_init_dcode();
  for (int t = 0; t < blk->ntok; t++) {
    if (blk->len[t] == 0) {
      fll[blk->lit[t]]++;
    } else {
      int lc = g_len2code[blk->len[t]];
      int dc = zd_dist_code(blk->dist[t]);
      fll[257 + lc]++;
      fd[dc]++;
      extra_bits += (uint64_t)LEXT[lc] + DEXT[dc];
    }
  }
  fll[256]++;
  /* Decodable-tree guarantees (same rules as huffman_host.build_block). */
  {
    int used = 0;
    for (int s = 0; s < 288; s++) used += fll[s] != 0;
    if (used < 2 && fll[0] == 0) fll[0] = 1;
    int usedd = 0;
    for (int s = 0; s < 30; s++) usedd += fd[s] != 0;
    if (usedd == 0) fd[0] = 1;
    else if (usedd < 2) fd[fd[0] ? 1 : 0] = fd[fd[0] ? 1 : 0] ? fd[fd[0] ? 1 : 0] : 1;
  }
  uint8_t ll_len[288], d_len[30], fx_ll[288], fx_d[30];
  zh_lengths(fll, 286, 15, ll_len);
  ll_len[286] = ll_len[287] = 0;
  zh_lengths(fd, 30, 15, d_len);
  zd_fixed_lens(fx_ll, fx_d);

  uint64_t body_dyn = extra_bits, body_fix = extra_bits;
  for (int s = 0; s < 288; s++) {
    body_dyn += (uint64_t)fll[s] * ll_len[s];
    body_fix += (uint64_t)fll[s] * fx_ll[s];
  }
  for (int s = 0; s < 30; s++) {
    body_dyn += (uint64_t)fd[s] * d_len[s];
    body_fix += (uint64_t)fd[s] * 5u;
  }

  /* Dynamic header: HLIT/HDIST trims, CL-RLE, 7-bit-capped CL code. */
  int hlit = 286;
  while (hlit > 257 && ll_len[hlit - 1] == 0) hlit--;
  int hdist = 30;
  while (hdist > 1 && d_len[hdist - 1] == 0) hdist--;
  uint8_t seq[318], rle_sym[318], rle_extra[318];
  memcpy(seq, ll_len, (size_t)hlit);
  memcpy(seq + hlit, d_len, (size_t)hdist);
  int rle_n = 0;
  zh_cl_rle(seq, hlit + hdist, rle_sym, rle_extra, &rle_n);
  uint32_t clfreq[19] = {0};
  for (int t = 0; t < rle_n; t++) clfreq[rle_sym[t]]++;
  uint8_t cl_len[19];
  zh_lengths(clfreq, 19, 7, cl_len);
  {
    int usedc = 0;
    for (int s = 0; s < 19; s++) usedc += cl_len[s] != 0;
    if (usedc == 1) { /* single CL symbol: give it an explicit 1-bit code */
      for (int s = 0; s < 19; s++)
        if (cl_len[s]) cl_len[s] = 1;
    }
  }
  int hclen = 19;
  while (hclen > 4 && cl_len[CLORD[hclen - 1]] == 0) hclen--;
  uint64_t hdr_dyn = 5 + 5 + 4 + 3u * (uint64_t)hclen;
  for (int t = 0; t < rle_n; t++) {
    hdr_dyn += cl_len[rle_sym[t]];
    if (rle_sym[t] == 16) hdr_dyn += 2;
    else if (rle_sym[t] == 17) hdr_dyn += 3;
    else if (rle_sym[t] == 18) hdr_dyn += 7;
  }

  int64_t blen = in_end - in_start;
  int64_t npieces = blen ? (blen + 65534) / 65535 : 1;
  /* stored: 3-bit type, align to byte, then 4 header bytes + data per
   * piece (alignment depends on current writer position). */
  uint64_t wpos_bits = w->pos * 8ull + (uint64_t)w->nbits;
  uint64_t align_pad = (8 - ((wpos_bits + 3) & 7)) & 7;
  uint64_t cost_stored = 3 + align_pad + (uint64_t)npieces * 32 +
                         (uint64_t)blen * 8 +
                         (uint64_t)(npieces - 1) * 8; /* later type bytes */
  uint64_t cost_fix = 3 + body_fix;
  uint64_t cost_dyn = 3 + hdr_dyn + body_dyn;
  if (force_fixed) cost_dyn = ~0ull; /* Z_FIXED: no dynamic codes */

  if (cost_stored <= cost_fix && cost_stored <= cost_dyn) {
    int64_t off = in_start;
    for (int64_t p = 0; p < npieces; p++) {
      int64_t take = blen - (off - in_start);
      if (take > 65535) take = 65535;
      int last = (p == npieces - 1);
      zw_put(w, (final && last) ? 1u : 0u, 1);
      zw_put(w, 0, 2);
      zw_align(w);
      zw_put(w, (uint32_t)take, 16);
      zw_put(w, (uint32_t)take ^ 0xFFFFu, 16);
      zw_drain(w); /* byte-aligned here: accumulator is empty */
      if (w->pos + (uint64_t)take <= w->cap) {
        memcpy(w->out + w->pos, buf + off, (size_t)take);
        w->pos += (size_t)take;
      } else {
        w->overflow = 1;
        w->pos += (size_t)take;
      }
      off += take;
    }
    return;
  }

  const uint8_t *ull = ll_len, *ud = d_len;
  uint16_t llc[288], dc_[30];
  int dynamic = cost_dyn < cost_fix;
  if (!dynamic) {
    ull = fx_ll;
    ud = fx_d;
  }
  zh_codes(ull, 288, llc);
  zh_codes(ud, 30, dc_);

  zw_put(w, final ? 1u : 0u, 1);
  zw_put(w, dynamic ? 2u : 1u, 2);
  if (dynamic) {
    zw_put(w, (uint32_t)(hlit - 257), 5);
    zw_put(w, (uint32_t)(hdist - 1), 5);
    zw_put(w, (uint32_t)(hclen - 4), 4);
    for (int t = 0; t < hclen; t++) zw_put(w, cl_len[CLORD[t]], 3);
    uint16_t clc[19];
    zh_codes(cl_len, 19, clc);
    for (int t = 0; t < rle_n; t++) {
      int s = rle_sym[t];
      zw_put(w, clc[s], cl_len[s]);
      if (s == 16) zw_put(w, rle_extra[t], 2);
      else if (s == 17) zw_put(w, rle_extra[t], 3);
      else if (s == 18) zw_put(w, rle_extra[t], 7);
    }
  }
  for (int t = 0; t < blk->ntok; t++) {
    if (blk->len[t] == 0) {
      int s = blk->lit[t];
      zw_put(w, llc[s], ull[s]);
    } else {
      /* Merge each code with its extra bits into one put (the extra
       * field follows the code LSB-first): <= 15+5 and <= 15+13 bits. */
      int lc = g_len2code[blk->len[t]];
      int s = 257 + lc;
      zw_put(w,
             llc[s] | ((uint32_t)(blk->len[t] - LBASE[lc]) << ull[s]),
             ull[s] + LEXT[lc]);
      int dcd = zd_dist_code(blk->dist[t]);
      zw_put(w,
             dc_[dcd] | ((uint32_t)(blk->dist[t] - DBASE[dcd]) << ud[dcd]),
             ud[dcd] + DEXT[dcd]);
    }
  }
  zw_put(w, llc[256], ull[256]);
}

/* ---- hash-chain matcher + greedy/lazy drive (SURVEY.md C5-C7, App. B) */
#define ZD_HBITS 15
#define ZD_HSIZE (1 << ZD_HBITS)

typedef struct {
  int good, lazy, nice, chain, greedy;
} zd_cfg_t;

/* Levels 1-9: the classic effort table (SURVEY.md Appendix B). */
static const zd_cfg_t ZD_CFG[10] = {
    {0, 0, 0, 0, 1},        /* level 0 unused (stored handled by caller) */
    {4, 4, 8, 4, 1},        {4, 5, 16, 8, 1},    {4, 6, 32, 32, 1},
    {4, 4, 16, 16, 0},      {8, 16, 32, 32, 0},  {8, 16, 128, 128, 0},
    {8, 32, 128, 256, 0},   {32, 128, 258, 1024, 0},
    {32, 258, 258, 4096, 0},
};

static inline uint32_t zd_hash(const uint8_t *p) {
  uint32_t v = ((uint32_t)p[0] << 16) | ((uint32_t)p[1] << 8) | p[2];
  return (v * 2654435761u) >> (32 - ZD_HBITS);
}

typedef struct {
  const uint8_t *buf;
  int64_t total;
  int32_t *head; /* ZD_HSIZE, -1 empty */
  int32_t *prev; /* per position */
} zd_mt_t;

static inline void zd_insert(zd_mt_t *m, int64_t i) {
  if (i + 3 > m->total) return;
  uint32_t h = zd_hash(m->buf + i);
  m->prev[i] = m->head[h];
  m->head[h] = (int32_t)i;
}

static inline uint32_t zd_ld32(const void *p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

static inline uint64_t zd_ld64(const void *p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}

static void zd_longest(const zd_mt_t *m, int64_t i, int chain, int nice,
                       int32_t window, int *out_len, int *out_dist) {
  int best = 2, bdist = 0;
  int64_t limit = i - window;
  if (limit < 0) limit = 0;
  int64_t maxl = m->total - i;
  if (maxl > 258) maxl = 258;
  const uint8_t *p = m->buf + i;
  int32_t cand = m->head[zd_hash(p)];
  if (nice > (int)maxl) nice = (int)maxl;
  uint32_t want = 0; /* p's 4 bytes ending at `best` (valid once best>=3) */
  while (cand >= limit && cand >= 0 && chain-- > 0) {
    const uint8_t *q = m->buf + cand;
    /* Prefilter: an improving candidate (lcp > best) must agree on the
     * 4 bytes ending at `best`, so one u32 compare rejects most chain
     * entries without changing which candidates are accepted.  (best
     * starts at 2, so fall back to the two byte probes until a real
     * match raises it to >= 3.) */
    int probe_ok = best >= 3 ? zd_ld32(q + best - 3) == want
                             : (q[best] == p[best] && q[0] == p[0]);
    if (cand < i && probe_ok) {
      /* Exact LCP, 8 bytes per step (buf has an 8-byte zero tail). */
      int l = 0;
      while (l + 8 <= (int)maxl) {
        uint64_t x = zd_ld64(q + l) ^ zd_ld64(p + l);
        if (x) {
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
          l += __builtin_ctzll(x) >> 3;
#else
          while (q[l] == p[l]) l++;
#endif
          goto extended;
        }
        l += 8;
      }
      while (l < (int)maxl && q[l] == p[l]) l++;
    extended:
      if (l > best) {
        best = l;
        bdist = (int)(i - cand);
        if (l >= nice) break;
        if (best >= 3 && best < (int)maxl) want = zd_ld32(p + best - 3);
      }
    }
    cand = m->prev[cand];
  }
  if (best >= 3) {
    *out_len = best;
    *out_dist = bdist;
  } else {
    *out_len = 0;
    *out_dist = 0;
  }
}

/* One-shot raw-deflate encode.  dict seeds the window (positions before
 * `in`); max_dist clamps match distances (windowBits 8..15 contract,
 * zlib.h:551-556).  Returns 0 / ZZT_E_OUTFULL. */
int zzt_deflate(const uint8_t *in, size_t n, int level, int strategy,
                const uint8_t *dict, size_t dict_len, int32_t max_dist,
                int final, uint8_t *out, size_t out_cap, size_t *out_len) {
  if (level < 1) level = 1;
  if (level > 9) level = 9;
  const zd_cfg_t cfg = ZD_CFG[level];
  if (dict_len > 32768) {
    dict += dict_len - 32768;
    dict_len = 32768;
  }
  int32_t window = max_dist < 32768 ? max_dist : 32768;
  if (strategy == 3) window = 1;       /* Z_RLE: dist-1 runs only */
  int force_fixed = strategy == 4;     /* Z_FIXED */
  int min_len = strategy == 1 ? 5 : 3; /* Z_FILTERED: favor literals */

  int64_t total = (int64_t)dict_len + (int64_t)n;
  uint8_t *buf = (uint8_t *)malloc((size_t)total + 8);
  int32_t *head = (int32_t *)malloc(sizeof(int32_t) * ZD_HSIZE);
  int32_t *prev = (int32_t *)malloc(sizeof(int32_t) * (size_t)(total + 1));
  /* Block token buffers: a block closes at the first token START past
   * 64 KiB of input, so it spans at most 64 KiB + 258 input bytes. */
  int cap_tok = 65536 + 512;
  uint16_t *tlen = (uint16_t *)malloc(sizeof(uint16_t) * (size_t)cap_tok);
  uint16_t *tdist = (uint16_t *)malloc(sizeof(uint16_t) * (size_t)cap_tok);
  uint8_t *tlit = (uint8_t *)malloc((size_t)cap_tok);
  if (!buf || !head || !prev || !tlen || !tdist || !tlit) {
    free(buf); free(head); free(prev); free(tlen); free(tdist); free(tlit);
    return ZZT_E_OUTFULL;
  }
  if (dict_len) memcpy(buf, dict, dict_len);
  if (n) memcpy(buf + dict_len, in, n);
  memset(buf + total, 0, 8);
  for (int64_t k = 0; k < ZD_HSIZE; k++) head[k] = -1;

  zd_mt_t m = {buf, total, head, prev};
  for (int64_t i = 0; i + 3 <= (int64_t)dict_len; i++) zd_insert(&m, i);

  zw_t w;
  zw_init(&w, out, out_cap);
  zblk_t blk = {tlen, tdist, tlit, 0};
  int64_t start = (int64_t)dict_len;
  int64_t block_start = start;
  int64_t i = start;
  int have_prev = 0, prev_len = 0, prev_dist = 0;
  int emitted_any = 0;

  while (i < total) {
    if (!have_prev && (i - block_start) >= 65536) {
      zd_emit_block(&w, buf, block_start, i, &blk, 0, force_fixed);
      emitted_any = 1;
      blk.ntok = 0;
      block_start = i;
    }
    int len = 0, dist = 0;
    if (strategy != 2 && total - i >= 3) { /* Z_HUFFMAN_ONLY: no matches */
      int ch = cfg.chain;
      if (have_prev && prev_len >= cfg.good) ch >>= 2;
      zd_longest(&m, i, ch, cfg.nice, window, &len, &dist);
      if (len == 3 && dist > 4096) len = 0; /* zlib's TOO_FAR heuristic */
      if (len && len < min_len) len = 0;
    }
    if (have_prev) {
      if (len > prev_len) {
        /* Better match one byte later: the deferred byte is a literal. */
        blk.len[blk.ntok] = 0;
        blk.lit[blk.ntok++] = buf[i - 1];
        prev_len = len;
        prev_dist = dist;
        zd_insert(&m, i);
        i++;
      } else {
        blk.len[blk.ntok] = (uint16_t)prev_len;
        blk.dist[blk.ntok++] = (uint16_t)prev_dist;
        for (int64_t j = i; j < i - 1 + prev_len; j++) zd_insert(&m, j);
        i += prev_len - 1;
        have_prev = 0;
      }
    } else if (len >= 3) {
      if (cfg.greedy || len >= cfg.lazy) {
        blk.len[blk.ntok] = (uint16_t)len;
        blk.dist[blk.ntok++] = (uint16_t)dist;
        for (int64_t j = i; j < i + len; j++) zd_insert(&m, j);
        i += len;
      } else {
        have_prev = 1;
        prev_len = len;
        prev_dist = dist;
        zd_insert(&m, i);
        i++;
      }
    } else {
      blk.len[blk.ntok] = 0;
      blk.lit[blk.ntok++] = buf[i];
      zd_insert(&m, i);
      i++;
    }
  }
  if (have_prev) { /* stream ended while deferring: emit the match */
    blk.len[blk.ntok] = (uint16_t)prev_len;
    blk.dist[blk.ntok++] = (uint16_t)prev_dist;
  }
  if (blk.ntok || !emitted_any || final)
    zd_emit_block(&w, buf, block_start, total, &blk, final ? 1 : 0,
                  force_fixed);
  if (!final) {
    /* Sync-flush framing (zlib.h:170-173 Z_SYNC_FLUSH): an empty stored
     * block byte-aligns the stream so segments concatenate legally. */
    zw_put(&w, 0, 3);
    zw_align(&w);
    zw_put(&w, 0x0000u, 16);
    zw_put(&w, 0xFFFFu, 16);
  }
  zw_align(&w);

  free(buf); free(head); free(prev); free(tlen); free(tdist); free(tlit);
  if (w.overflow) return ZZT_E_OUTFULL;
  *out_len = w.pos;
  return ZZT_OK;
}
