/* Native XTC (GROMACS compressed trajectory) frame codec.
 *
 * Implements the XDR frame layout and the classic 3dfcoord integer
 * compression scheme (magic-int quantization, big-integer bit packing,
 * run-length deltas between nearby atoms) used by GROMACS/mdtraj, so
 * trajectories written here open in the standard tools -- the reference
 * writes XTC through mdtraj (reference chiron/reporters.py:351-432); this
 * codec removes that optional dependency.
 *
 * Everything operates on in-memory buffers; Python (ctypes) owns the file.
 * All multi-byte values are big-endian per XDR.
 *
 * PROVENANCE: the magicints quantization table and the structure of the
 * 3dfcoord algorithm (mixed-radix big-int packing, run-length deltas,
 * water-pair interchange) are format constants of the PUBLISHED xdrfile
 * specification (Lindahl et al., GROMACS libxdrfile, BSD-licensed) --
 * there is only one way to write a conforming XTC stream.  The
 * implementation here is written from that spec, not copied from any
 * library; tests/xtc_spec_oracle.py holds an independently written
 * decoder used to verify spec conformance (tests/test_native_xtc.py).
 */

#include <math.h>
#include <stdint.h>
#include <string.h>

#define XTC_MAGIC 1995
#define FIRSTIDX 9

static const int magicints[] = {
    0,       0,       0,       0,       0,       0,       0,      0,
    0,       8,       10,      12,      16,      20,      25,     32,
    40,      50,      64,      80,      101,     128,     161,    203,
    256,     322,     406,     512,     645,     812,     1024,   1290,
    1625,    2048,    2580,    3250,    4096,    5060,    6501,   8192,
    10321,   13003,   16384,   20642,   26007,   32768,   41285,  52015,
    65536,   82570,   104031,  131072,  165140,  208063,  262144, 330280,
    416127,  524287,  660561,  832255,  1048576, 1321122, 1664510,
    2097152, 2642245, 3329021, 4194304, 5284491, 6658042, 8388607,
    10568983, 13316085, 16777216};
#define LASTIDX ((int)(sizeof(magicints) / sizeof(*magicints)))

/* ---------------- byte-stream helpers (big-endian XDR) ---------------- */

typedef struct {
  unsigned char *data;
  long pos;
  long cap;
  int err;
} Stream;

static void put_u32(Stream *s, uint32_t v) {
  if (s->pos + 4 > s->cap) {
    s->err = 1;
    return;
  }
  s->data[s->pos++] = (unsigned char)(v >> 24);
  s->data[s->pos++] = (unsigned char)(v >> 16);
  s->data[s->pos++] = (unsigned char)(v >> 8);
  s->data[s->pos++] = (unsigned char)(v);
}

static void put_i32(Stream *s, int32_t v) { put_u32(s, (uint32_t)v); }

static void put_f32(Stream *s, float f) {
  uint32_t v;
  memcpy(&v, &f, 4);
  put_u32(s, v);
}

typedef struct {
  const unsigned char *data;
  long pos;
  long len;
  int err;
} RStream;

static uint32_t get_u32(RStream *s) {
  uint32_t v;
  if (s->pos + 4 > s->len) {
    s->err = 1;
    return 0;
  }
  v = ((uint32_t)s->data[s->pos] << 24) | ((uint32_t)s->data[s->pos + 1] << 16) |
      ((uint32_t)s->data[s->pos + 2] << 8) | (uint32_t)s->data[s->pos + 3];
  s->pos += 4;
  return v;
}

static int32_t get_i32(RStream *s) { return (int32_t)get_u32(s); }

static float get_f32(RStream *s) {
  uint32_t v = get_u32(s);
  float f;
  memcpy(&f, &v, 4);
  return f;
}

/* ---------------- bit packing (sendbits/receivebits) ------------------ */

typedef struct {
  unsigned char *cbuf; /* byte buffer */
  long cnt;            /* bytes committed */
  long cap;
  int lastbits;
  uint32_t lastbyte;
  int err;
} BitBuf;

static void sendbits(BitBuf *b, int num_of_bits, uint32_t num) {
  uint32_t lastbyte = b->lastbyte;
  int lastbits = b->lastbits;
  if (num_of_bits < 32)
    num &= (num_of_bits == 0) ? 0u : ((num_of_bits == 32) ? 0xffffffffu
                                                          : ((1u << num_of_bits) - 1u));
  while (num_of_bits >= 8) {
    if (b->cnt >= b->cap) {
      b->err = 1;
      return;
    }
    lastbyte = (lastbyte << 8) | ((num >> (num_of_bits - 8)) & 0xffu);
    b->cbuf[b->cnt++] = (unsigned char)(lastbyte >> lastbits);
    num_of_bits -= 8;
  }
  if (num_of_bits > 0) {
    lastbyte = (lastbyte << num_of_bits) | (num & ((1u << num_of_bits) - 1u));
    lastbits += num_of_bits;
    if (lastbits >= 8) {
      lastbits -= 8;
      if (b->cnt >= b->cap) {
        b->err = 1;
        return;
      }
      b->cbuf[b->cnt++] = (unsigned char)(lastbyte >> lastbits);
    }
  }
  b->lastbits = lastbits;
  b->lastbyte = lastbyte;
  if (lastbits > 0) {
    if (b->cnt >= b->cap) {
      b->err = 1;
      return;
    }
    b->cbuf[b->cnt] = (unsigned char)(lastbyte << (8 - lastbits));
  }
}

static int sizeofint(int size) {
  unsigned int num = 1;
  int num_of_bits = 0;
  while ((unsigned int)size >= num && num_of_bits < 32) {
    num_of_bits++;
    num <<= 1;
  }
  return num_of_bits;
}

static int sizeofints(int num_of_ints, const unsigned int sizes[]) {
  int i;
  unsigned int num;
  unsigned int num_of_bytes, num_of_bits, bytecnt, tmp;
  unsigned char bytes[32];
  num_of_bytes = 1;
  bytes[0] = 1;
  num_of_bits = 0;
  for (i = 0; i < num_of_ints; i++) {
    tmp = 0;
    for (bytecnt = 0; bytecnt < num_of_bytes; bytecnt++) {
      tmp = bytes[bytecnt] * sizes[i] + tmp;
      bytes[bytecnt] = (unsigned char)(tmp & 0xff);
      tmp >>= 8;
    }
    while (tmp != 0) {
      bytes[num_of_bytes++] = (unsigned char)(tmp & 0xff);
      tmp >>= 8;
    }
  }
  num = 1;
  num_of_bytes--;
  while (bytes[num_of_bytes] >= num) {
    num_of_bits++;
    num *= 2;
  }
  return (int)(num_of_bits + num_of_bytes * 8);
}

static void sendints(BitBuf *b, int num_of_ints, int num_of_bits,
                     const unsigned int sizes[], const unsigned int nums[]) {
  int i;
  unsigned int bytes[32], num_of_bytes, bytecnt, tmp;
  tmp = nums[0];
  num_of_bytes = 0;
  do {
    bytes[num_of_bytes++] = tmp & 0xff;
    tmp >>= 8;
  } while (tmp != 0);
  for (i = 1; i < num_of_ints; i++) {
    tmp = nums[i];
    for (bytecnt = 0; bytecnt < num_of_bytes; bytecnt++) {
      tmp = bytes[bytecnt] * sizes[i] + tmp;
      bytes[bytecnt] = tmp & 0xff;
      tmp >>= 8;
    }
    while (tmp != 0) {
      bytes[num_of_bytes++] = tmp & 0xff;
      tmp >>= 8;
    }
  }
  if (num_of_bits >= (int)(num_of_bytes * 8)) {
    for (i = 0; i < (int)num_of_bytes; i++) sendbits(b, 8, bytes[i]);
    sendbits(b, num_of_bits - (int)num_of_bytes * 8, 0);
  } else {
    for (i = 0; i < (int)num_of_bytes - 1; i++) sendbits(b, 8, bytes[i]);
    sendbits(b, num_of_bits - ((int)num_of_bytes - 1) * 8, bytes[i]);
  }
}

typedef struct {
  const unsigned char *cbuf;
  long cnt;
  long len;
  int lastbits;
  uint32_t lastbyte;
  int err;
} RBitBuf;

static int receivebits(RBitBuf *b, int num_of_bits) {
  int num = 0;
  uint32_t mask = (num_of_bits >= 32) ? 0xffffffffu : ((1u << num_of_bits) - 1u);
  uint32_t lastbyte = b->lastbyte;
  int lastbits = b->lastbits;
  while (num_of_bits >= 8) {
    if (b->cnt >= b->len) {
      b->err = 1;
      return 0;
    }
    lastbyte = (lastbyte << 8) | b->cbuf[b->cnt++];
    num |= (int)((lastbyte >> lastbits) << (num_of_bits - 8));
    num_of_bits -= 8;
  }
  if (num_of_bits > 0) {
    if (lastbits < num_of_bits) {
      lastbits += 8;
      if (b->cnt >= b->len) {
        b->err = 1;
        return 0;
      }
      lastbyte = (lastbyte << 8) | b->cbuf[b->cnt++];
    }
    lastbits -= num_of_bits;
    num |= (int)((lastbyte >> lastbits) & ((1u << num_of_bits) - 1u));
  }
  num = (int)((uint32_t)num & mask);
  b->lastbits = lastbits;
  b->lastbyte = lastbyte;
  return num;
}

static void receiveints(RBitBuf *b, int num_of_ints, int num_of_bits,
                        const unsigned int sizes[], int nums[]) {
  int bytes[32];
  int i, j, num_of_bytes, p, num;
  bytes[0] = bytes[1] = bytes[2] = bytes[3] = 0;
  num_of_bytes = 0;
  while (num_of_bits > 8) {
    bytes[num_of_bytes++] = receivebits(b, 8);
    num_of_bits -= 8;
  }
  if (num_of_bits > 0) bytes[num_of_bytes++] = receivebits(b, num_of_bits);
  for (i = num_of_ints - 1; i > 0; i--) {
    num = 0;
    for (j = num_of_bytes - 1; j >= 0; j--) {
      num = (num << 8) | bytes[j];
      p = num / (int)sizes[i];
      bytes[j] = p;
      num = num - p * (int)sizes[i];
    }
    nums[i] = num;
  }
  nums[0] = bytes[0] | (bytes[1] << 8) | (bytes[2] << 16) | (bytes[3] << 24);
}

/* ---------------- frame encode ---------------------------------------- */

static int i_abs(int a) { return a < 0 ? -a : a; }
static int i_min(int a, int b) { return a < b ? a : b; }
static int i_max(int a, int b) { return a > b ? a : b; }

/* Encode one frame.  coords: natoms*3 floats (nm).  box: 9 floats row-major.
 * Returns bytes written into out, or <0 on error (-1 capacity, -2 range). */
long xtc_encode_frame(int natoms, int step, float time, const float *box,
                      const float *coords, float precision, unsigned char *out,
                      long out_cap) {
  Stream s = {out, 0, out_cap, 0};
  int i, k;
  put_i32(&s, XTC_MAGIC);
  put_i32(&s, natoms);
  put_i32(&s, step);
  put_f32(&s, time);
  for (i = 0; i < 9; i++) put_f32(&s, box[i]);
  put_i32(&s, natoms);
  if (s.err) return -1;

  if (natoms <= 9) { /* tiny systems are stored uncompressed */
    for (i = 0; i < natoms * 3; i++) {
      float v = coords[i];
      /* same invariant as the compressed path: a NaN/Inf coordinate from a
       * diverged trajectory must fail cleanly, not be written to disk */
      if (!(v >= -3.4e38f && v <= 3.4e38f)) return -2;
      put_f32(&s, v);
    }
    return s.err ? -1 : s.pos;
  }

  put_f32(&s, precision);
  {
    int size3 = natoms * 3;
    int minint[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
    int maxint[3] = {INT32_MIN, INT32_MIN, INT32_MIN};
    int mindiff = INT32_MAX;
    int oldlint[3] = {0, 0, 0};
    int *lip;
    static int ibuf_static[3 * 400000];
    int sizeint[3], bitsizeint[3], bitsize;
    unsigned int usizes[3];
    int smallidx, maxidx, minidx, smaller, smallnum, larger;
    unsigned int sizesmall[3];
    int prevcoord[3], tmpcoord[24 + 3];
    int run, prevrun, is_small, is_smaller;
    BitBuf bb;

    if (size3 > 3 * 400000) return -3; /* static scratch bound */
    lip = ibuf_static;

    for (i = 0; i < natoms; i++) {
      int lint[3];
      for (k = 0; k < 3; k++) {
        float lf = coords[i * 3 + k] * precision;
        /* reject non-finite and beyond-int values BEFORE the cast (a
         * float->int conversion out of range is UB; a NaN coordinate from
         * a diverged trajectory must fail cleanly, not corrupt the frame) */
        if (!(lf >= -2.1e9f && lf <= 2.1e9f)) return -2;
        if (lf >= 0)
          lint[k] = (int)(lf + 0.5f);
        else
          lint[k] = (int)(lf - 0.5f);
        if (i_abs(lint[k]) > 8388607) return -2; /* beyond 2^23: no fit */
        if (lint[k] < minint[k]) minint[k] = lint[k];
        if (lint[k] > maxint[k]) maxint[k] = lint[k];
        lip[i * 3 + k] = lint[k];
      }
      if (i > 0) {
        int diff = i_abs(lint[0] - oldlint[0]) + i_abs(lint[1] - oldlint[1]) +
                   i_abs(lint[2] - oldlint[2]);
        if (diff < mindiff) mindiff = diff;
      }
      oldlint[0] = lint[0];
      oldlint[1] = lint[1];
      oldlint[2] = lint[2];
    }
    for (k = 0; k < 3; k++) put_i32(&s, minint[k]);
    for (k = 0; k < 3; k++) put_i32(&s, maxint[k]);
    if (s.err) return -1;

    for (k = 0; k < 3; k++) sizeint[k] = maxint[k] - minint[k] + 1;
    if ((unsigned int)sizeint[0] > 0xffffff || (unsigned int)sizeint[1] > 0xffffff ||
        (unsigned int)sizeint[2] > 0xffffff) {
      bitsizeint[0] = sizeofint(sizeint[0]);
      bitsizeint[1] = sizeofint(sizeint[1]);
      bitsizeint[2] = sizeofint(sizeint[2]);
      bitsize = 0;
    } else {
      usizes[0] = (unsigned int)sizeint[0];
      usizes[1] = (unsigned int)sizeint[1];
      usizes[2] = (unsigned int)sizeint[2];
      bitsize = sizeofints(3, usizes);
      bitsizeint[0] = bitsizeint[1] = bitsizeint[2] = 0;
    }

    smallidx = FIRSTIDX;
    while (smallidx < LASTIDX - 1 && magicints[smallidx] < mindiff) smallidx++;
    put_i32(&s, smallidx);
    if (s.err) return -1;

    maxidx = i_min(LASTIDX - 1, smallidx + 8);
    minidx = maxidx - 8;
    smaller = magicints[i_max(FIRSTIDX, smallidx - 1)] / 2;
    smallnum = magicints[smallidx] / 2;
    sizesmall[0] = sizesmall[1] = sizesmall[2] = (unsigned int)magicints[smallidx];
    larger = magicints[maxidx] / 2;

    /* bit buffer writes into the stream after a 4-byte length slot */
    {
      long len_pos = s.pos;
      s.pos += 4;
      if (s.pos > s.cap) return -1;
      bb.cbuf = s.data + s.pos;
      bb.cnt = 0;
      bb.cap = s.cap - s.pos;
      bb.lastbits = 0;
      bb.lastbyte = 0;
      bb.err = 0;

      prevrun = -1;
      prevcoord[0] = prevcoord[1] = prevcoord[2] = 0;
      i = 0;
      while (i < natoms) {
        int *thiscoord = lip + i * 3;
        is_small = 0;
        if (smallidx < maxidx && i >= 1 &&
            i_abs(thiscoord[0] - prevcoord[0]) < larger &&
            i_abs(thiscoord[1] - prevcoord[1]) < larger &&
            i_abs(thiscoord[2] - prevcoord[2]) < larger)
          is_smaller = 1;
        else if (smallidx > minidx)
          is_smaller = -1;
        else
          is_smaller = 0;
        if (i + 1 < natoms) {
          if (i_abs(thiscoord[0] - thiscoord[3]) < smallnum &&
              i_abs(thiscoord[1] - thiscoord[4]) < smallnum &&
              i_abs(thiscoord[2] - thiscoord[5]) < smallnum) {
            /* interchange atoms so the run can delta off this one */
            int t;
            t = thiscoord[0]; thiscoord[0] = thiscoord[3]; thiscoord[3] = t;
            t = thiscoord[1]; thiscoord[1] = thiscoord[4]; thiscoord[4] = t;
            t = thiscoord[2]; thiscoord[2] = thiscoord[5]; thiscoord[5] = t;
            is_small = 1;
          }
        }
        tmpcoord[0] = thiscoord[0] - minint[0];
        tmpcoord[1] = thiscoord[1] - minint[1];
        tmpcoord[2] = thiscoord[2] - minint[2];
        if (bitsize == 0) {
          sendbits(&bb, bitsizeint[0], (uint32_t)tmpcoord[0]);
          sendbits(&bb, bitsizeint[1], (uint32_t)tmpcoord[1]);
          sendbits(&bb, bitsizeint[2], (uint32_t)tmpcoord[2]);
        } else {
          unsigned int unums[3] = {(unsigned int)tmpcoord[0],
                                   (unsigned int)tmpcoord[1],
                                   (unsigned int)tmpcoord[2]};
          sendints(&bb, 3, bitsize, usizes, unums);
        }
        prevcoord[0] = thiscoord[0];
        prevcoord[1] = thiscoord[1];
        prevcoord[2] = thiscoord[2];
        thiscoord = thiscoord + 3;
        i++;

        run = 0;
        if (is_small == 0 && is_smaller == -1) is_smaller = 0;
        while (is_small && run < 8 * 3) {
          if (is_smaller == -1 &&
              ((long)(thiscoord[0] - prevcoord[0]) * (thiscoord[0] - prevcoord[0]) +
                   (long)(thiscoord[1] - prevcoord[1]) * (thiscoord[1] - prevcoord[1]) +
                   (long)(thiscoord[2] - prevcoord[2]) * (thiscoord[2] - prevcoord[2]) >=
               (long)smaller * smaller))
            is_smaller = 0;
          tmpcoord[run++] = thiscoord[0] - prevcoord[0] + smallnum;
          tmpcoord[run++] = thiscoord[1] - prevcoord[1] + smallnum;
          tmpcoord[run++] = thiscoord[2] - prevcoord[2] + smallnum;
          prevcoord[0] = thiscoord[0];
          prevcoord[1] = thiscoord[1];
          prevcoord[2] = thiscoord[2];
          i++;
          thiscoord = thiscoord + 3;
          is_small = 0;
          if (i < natoms && i_abs(thiscoord[0] - prevcoord[0]) < smallnum &&
              i_abs(thiscoord[1] - prevcoord[1]) < smallnum &&
              i_abs(thiscoord[2] - prevcoord[2]) < smallnum)
            is_small = 1;
        }
        if (run != prevrun || is_smaller != 0) {
          prevrun = run;
          sendbits(&bb, 1, 1);
          sendbits(&bb, 5, (uint32_t)(run + is_smaller + 1));
        } else {
          sendbits(&bb, 1, 0);
        }
        for (k = 0; k < run; k += 3) {
          unsigned int unums[3] = {(unsigned int)tmpcoord[k],
                                   (unsigned int)tmpcoord[k + 1],
                                   (unsigned int)tmpcoord[k + 2]};
          sendints(&bb, 3, smallidx /* bits == smallidx per xdrfile */,
                   sizesmall, unums);
        }
        if (is_smaller != 0) {
          smallidx += is_smaller;
          if (is_smaller < 0) {
            smallnum = smaller;
            smaller = magicints[smallidx - 1] / 2;
          } else {
            smaller = smallnum;
            smallnum = magicints[smallidx] / 2;
          }
          sizesmall[0] = sizesmall[1] = sizesmall[2] =
              (unsigned int)magicints[smallidx];
        }
      }
      if (bb.err) return -1;
      {
        long nbytes = bb.cnt;
        if (bb.lastbits != 0) nbytes++;
        /* patch the length slot */
        s.data[len_pos] = (unsigned char)(((uint32_t)nbytes) >> 24);
        s.data[len_pos + 1] = (unsigned char)(((uint32_t)nbytes) >> 16);
        s.data[len_pos + 2] = (unsigned char)(((uint32_t)nbytes) >> 8);
        s.data[len_pos + 3] = (unsigned char)((uint32_t)nbytes);
        s.pos += nbytes;
        while (s.pos % 4 != 0) { /* XDR opaque padding */
          if (s.pos >= s.cap) return -1;
          s.data[s.pos++] = 0;
        }
      }
    }
  }
  return s.err ? -1 : s.pos;
}

/* ---------------- frame decode ---------------------------------------- */

/* Decode one frame starting at in; returns bytes consumed or <0 on error.
 * coords must hold max_atoms*3 floats. */
long xtc_decode_frame(const unsigned char *in, long in_len, int *natoms,
                      int *step, float *time, float *box, float *coords,
                      int max_atoms, float *precision) {
  RStream s = {in, 0, in_len, 0};
  int i, k;
  int magic = get_i32(&s);
  int lsize;
  if (magic != XTC_MAGIC) return -10;
  *natoms = get_i32(&s);
  *step = get_i32(&s);
  *time = get_f32(&s);
  for (i = 0; i < 9; i++) box[i] = get_f32(&s);
  lsize = get_i32(&s);
  /* lsize <= 0 on a corrupt stream would otherwise "succeed" with zero
   * decoded atoms (negative loop bounds), handing the caller uninitialized
   * scratch memory */
  if (s.err || lsize != *natoms || lsize <= 0) return -11;
  if (lsize > max_atoms) return -12;

  if (lsize <= 9) {
    for (i = 0; i < lsize * 3; i++) coords[i] = get_f32(&s);
    *precision = 0.0f;
    return s.err ? -11 : s.pos;
  }

  *precision = get_f32(&s);
  {
    int minint[3], maxint[3];
    int sizeint[3], bitsizeint[3], bitsize;
    unsigned int usizes[3], sizesmall[3];
    int smallidx, smaller, smallnum;
    int prevcoord[3], thiscoord[3];
    long nbytes;
    RBitBuf bb;
    float inv_precision;
    int run = 0, is_smaller, flag;
    long atom_out = 0;

    for (k = 0; k < 3; k++) minint[k] = get_i32(&s);
    for (k = 0; k < 3; k++) maxint[k] = get_i32(&s);
    for (k = 0; k < 3; k++) sizeint[k] = maxint[k] - minint[k] + 1;
    /* untrusted input: a zero or negative axis extent (maxint < minint on a
     * corrupt stream) reaches an integer division by sizes[k] in receiveints
     * -- SIGFPE, killing the process.  Every legitimate encode has
     * maxint >= minint, so sizeint >= 1. */
    if (sizeint[0] < 1 || sizeint[1] < 1 || sizeint[2] < 1) return -15;
    if ((unsigned int)sizeint[0] > 0xffffff || (unsigned int)sizeint[1] > 0xffffff ||
        (unsigned int)sizeint[2] > 0xffffff) {
      bitsizeint[0] = sizeofint(sizeint[0]);
      bitsizeint[1] = sizeofint(sizeint[1]);
      bitsizeint[2] = sizeofint(sizeint[2]);
      bitsize = 0;
    } else {
      usizes[0] = (unsigned int)sizeint[0];
      usizes[1] = (unsigned int)sizeint[1];
      usizes[2] = (unsigned int)sizeint[2];
      bitsize = sizeofints(3, usizes);
      bitsizeint[0] = bitsizeint[1] = bitsizeint[2] = 0;
    }
    smallidx = get_i32(&s);
    /* untrusted input: an out-of-range smallidx would read past magicints,
     * divide by zero in receiveints (magicints[<FIRSTIDX] == 0), or smash
     * the bytes[32] scratch there (num_of_bits == smallidx) */
    if (smallidx < FIRSTIDX || smallidx >= LASTIDX) return -14;
    smaller = magicints[i_max(FIRSTIDX, smallidx - 1)] / 2;
    smallnum = magicints[smallidx] / 2;
    sizesmall[0] = sizesmall[1] = sizesmall[2] = (unsigned int)magicints[smallidx];
    nbytes = get_i32(&s);
    if (s.err || nbytes < 0 || s.pos + nbytes > s.len) return -11;
    bb.cbuf = s.data + s.pos;
    bb.cnt = 0;
    bb.len = nbytes;
    bb.lastbits = 0;
    bb.lastbyte = 0;
    bb.err = 0;
    inv_precision = 1.0f / *precision;

    i = 0;
    while (i < lsize) {
      if (bitsize == 0) {
        thiscoord[0] = receivebits(&bb, bitsizeint[0]);
        thiscoord[1] = receivebits(&bb, bitsizeint[1]);
        thiscoord[2] = receivebits(&bb, bitsizeint[2]);
      } else {
        receiveints(&bb, 3, bitsize, usizes, thiscoord);
      }
      i++;
      thiscoord[0] += minint[0];
      thiscoord[1] += minint[1];
      thiscoord[2] += minint[2];
      prevcoord[0] = thiscoord[0];
      prevcoord[1] = thiscoord[1];
      prevcoord[2] = thiscoord[2];

      flag = receivebits(&bb, 1);
      is_smaller = 0;
      if (flag == 1) {
        run = receivebits(&bb, 5);
        is_smaller = run % 3;
        run -= is_smaller;
        is_smaller--;
      }
      /* untrusted input: the run must fit in the remaining atoms, else the
       * loop below writes past the caller's coords buffer */
      if (i + run / 3 > lsize) return -13;
      if (run > 0) {
        for (k = 0; k < run; k += 3) {
          receiveints(&bb, 3, smallidx, sizesmall, thiscoord);
          i++;
          thiscoord[0] += prevcoord[0] - smallnum;
          thiscoord[1] += prevcoord[1] - smallnum;
          thiscoord[2] += prevcoord[2] - smallnum;
          if (k == 0) {
            /* interchange first with second atom (encoder swapped them) */
            int t;
            t = thiscoord[0]; thiscoord[0] = prevcoord[0]; prevcoord[0] = t;
            t = thiscoord[1]; thiscoord[1] = prevcoord[1]; prevcoord[1] = t;
            t = thiscoord[2]; thiscoord[2] = prevcoord[2]; prevcoord[2] = t;
            coords[atom_out++] = prevcoord[0] * inv_precision;
            coords[atom_out++] = prevcoord[1] * inv_precision;
            coords[atom_out++] = prevcoord[2] * inv_precision;
          } else {
            prevcoord[0] = thiscoord[0];
            prevcoord[1] = thiscoord[1];
            prevcoord[2] = thiscoord[2];
          }
          coords[atom_out++] = thiscoord[0] * inv_precision;
          coords[atom_out++] = thiscoord[1] * inv_precision;
          coords[atom_out++] = thiscoord[2] * inv_precision;
        }
      } else {
        coords[atom_out++] = thiscoord[0] * inv_precision;
        coords[atom_out++] = thiscoord[1] * inv_precision;
        coords[atom_out++] = thiscoord[2] * inv_precision;
      }
      smallidx += is_smaller;
      /* corrupt streams can walk smallidx out of the table one step per
       * atom; re-validate before it indexes magicints again */
      if (smallidx < FIRSTIDX || smallidx >= LASTIDX) return -14;
      if (is_smaller < 0) {
        smallnum = smaller;
        if (smallidx > FIRSTIDX)
          smaller = magicints[smallidx - 1] / 2;
        else
          smaller = 0;
      } else if (is_smaller > 0) {
        smaller = smallnum;
        smallnum = magicints[smallidx] / 2;
      }
      sizesmall[0] = sizesmall[1] = sizesmall[2] = (unsigned int)magicints[smallidx];
    }
    if (bb.err) return -13;
    s.pos += nbytes;
    while (s.pos % 4 != 0) s.pos++;
  }
  return s.err ? -11 : s.pos;
}
