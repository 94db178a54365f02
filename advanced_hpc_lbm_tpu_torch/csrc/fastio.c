/* Host-side output codec and obstacle-deck reader of the PyTorch port.
 *
 * final_state.dat holds one line per cell in raster order (jj outer, ii
 * inner): "%d %d %.12E %.12E %.12E %.12E %d\n" of (ii, jj, u_x, u_y, |u|,
 * pressure, obstacle column), the reference writer's format.  The lines are
 * cut into blocks of BLOCK_LINES.  Each of up to T threads claims the next
 * block, formats it into a buffer of its own, waits for its turn and writes
 * the block, so the file holds the blocks in order whatever the thread
 * count, and memory stays at T buffers whatever the grid.  av_vels.dat
 * holds "%ld:\t%.12E\n" per step.  Obstacle decks are "x y 1" lines, read
 * into a (ny, nx) byte mask.
 *
 * The lines are built here, not by printf: integers by a digit loop, and
 * each number by put_e12, which makes printf's "%.12E" digits exactly with
 * integer arithmetic where the value has a float32's 24-bit significand and
 * lies in about [1e-32, 1e13), as every value of both files does (float32
 * planes and float32 averages, widened), and hands any other number to
 * libc's snprintf.  The bytes are printf's either way.
 *
 * Both writers fill a stats struct where the caller passes one (NULL: none):
 * blocks, threads, nanoseconds formatting, writing and waiting for a turn
 * (CLOCK_MONOTONIC, a few reads a block), bytes written, and the numbers
 * handed to snprintf.
 *
 * Bound through ctypes by advanced_hpc_lbm_tpu_torch/utils/native.py, which
 * builds it with: cc -O2 -shared -fPIC -pthread -o libfastio_<hash>.so fastio.c
 */

#define _POSIX_C_SOURCE 200809L

#include <ctype.h>
#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
#include <unistd.h>

#define BLOCK_LINES 65536L
/* the longest line either writer can print: two ints of at most 10
 * digits, four "-d.ddddddddddddE+ddd" and a one-digit column, with
 * separators; the step index of av_vels.dat has at most 19 digits */
#define LINE_BYTES 128

/* Write all n bytes at p to fd; 0 on success. */
static int write_all(int fd, const char *p, size_t n) {
  while (n > 0) {
    ssize_t w = write(fd, p, n);
    if (w < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    p += w;
    n -= (size_t)w;
  }
  return 0;
}

/* What lbm_write_final_state did: blocks formatted, threads that formatted
 * at least one, nanoseconds formatting and writing (summed over threads)
 * and waiting for a turn to write, bytes written, and numbers handed to
 * snprintf. */
typedef struct {
  int64_t blocks, threads, format_ns, write_ns, wait_ns, bytes, fallback;
} lbm_final_state_stats;

/* What lbm_write_av_vels did: nanoseconds formatting and writing, bytes,
 * and numbers handed to snprintf. */
typedef struct {
  int64_t format_ns, write_ns, bytes, fallback;
} lbm_av_vels_stats;

static const char DIGIT_PAIRS[] =
    "00010203040506070809101112131415161718192021222324252627282930313233343536373839"
    "40414243444546474849505152535455565758596061626364656667686970717273747576777879"
    "8081828384858687888990919293949596979899";

/* Write the two digits of v < 100. */
static char *put2(char *out, unsigned v) {
  memcpy(out, DIGIT_PAIRS + 2 * v, 2);
  return out + 2;
}

/* Write the six digits of v < 10^6, leading zeros included. */
static char *put6(char *out, uint32_t v) {
  out = put2(out, v / 10000);
  v %= 10000;
  out = put2(out, v / 100);
  return put2(out, v % 100);
}

/* Write v as printf's "%ld" does. */
static char *put_long(char *out, long v) {
  char tmp[24];
  int n = 0;
  unsigned long u = v < 0 ? 0UL - (unsigned long)v : (unsigned long)v;
  do {
    tmp[n++] = (char)('0' + u % 10);
    u /= 10;
  } while (u);
  if (v < 0) *out++ = '-';
  while (n) *out++ = tmp[--n];
  return out;
}

#ifdef __SIZEOF_INT128__
typedef unsigned __int128 u128;

/* 5^0 .. 5^27, the powers of five that fit 64 bits */
static const uint64_t POW5[28] = {
    1ULL, 5ULL, 25ULL, 125ULL, 625ULL, 3125ULL, 15625ULL, 78125ULL, 390625ULL, 1953125ULL,
    9765625ULL, 48828125ULL, 244140625ULL, 1220703125ULL, 6103515625ULL, 30517578125ULL,
    152587890625ULL, 762939453125ULL, 3814697265625ULL, 19073486328125ULL,
    95367431640625ULL, 476837158203125ULL, 2384185791015625ULL, 11920928955078125ULL,
    59604644775390625ULL, 298023223876953125ULL, 1490116119384765625ULL,
    7450580596923828125ULL};

#define TEN12 1000000000000ULL
#define TEN13 10000000000000ULL
#define MAX_K 44 /* m * 5^k < 2^127 for every 24-bit m */

/* floor(m * 2^e * 10^k) into *q, and whether the rest is below, at or
 * above a half (-1, 0, 1) into *half; 0, or -1 where the shift does not
 * fit 128 bits.  0 <= k <= MAX_K. */
static int scale(uint64_t m, int e, int k, u128 *q, int *half) {
  u128 y = (u128)m * (k <= 27 ? POW5[k] : POW5[k - 27]);
  if (k > 27) y *= POW5[27];
  int s = -(k + e); /* m * 2^e * 10^k = y * 2^-s */
  if (s <= 0) {     /* an integer, below 10^14 wherever the caller asks */
    *q = y << -s;
    *half = -1;
    return 0;
  }
  if (s > 127) return -1;
  u128 r = y & (((u128)1 << s) - 1), h = (u128)1 << (s - 1);
  *q = y >> s;
  *half = r < h ? -1 : r > h;
  return 0;
}

/* The "%.12E" of m * 2^e (2^23 <= m < 2^24, the sign apart) into out, or
 * NULL where the value lies outside what scale() can make exactly. */
static char *put_e12_exact(char *out, uint64_t m, int e) {
  int p = e + 23; /* 2^p <= value < 2^(p+1) */
  /* floor(p * log10(2)), exact for |p| < 1650: the decimal exponent E of
   * the value, or E - 1 */
  int d = p >= 0 ? (p * 78913) >> 18 : -((-p * 78913 + (1 << 18) - 1) >> 18);
  int k = 12 - d; /* digits = value * 10^k, rounded */
  u128 q;
  int half;
  if (k < 0 || k > MAX_K || scale(m, e, k, &q, &half) != 0) return NULL;
  if (q >= TEN13) { /* d was E - 1 */
    if (k == 0 || scale(m, e, --k, &q, &half) != 0) return NULL;
  }
  /* ties to even; never up to 10^13, as no float32 lies within 5e-14 of a
   * power of ten it is not (the nearest is 1.8e-10 off, relatively) */
  uint64_t n = (uint64_t)q + (half > 0 || (half == 0 && (q & 1)));
  uint64_t rest = n % TEN12;
  *out++ = (char)('0' + n / TEN12);
  *out++ = '.';
  out = put6(out, (uint32_t)(rest / 1000000));
  out = put6(out, (uint32_t)(rest % 1000000));
  int x = 12 - k;
  *out++ = 'E';
  *out++ = x < 0 ? '-' : '+';
  return put2(out, (unsigned)(x < 0 ? -x : x)); /* -32 <= x <= 12 */
}
#endif

/* Write x as printf's "%.12E" does, at most 20 bytes: exactly in integer
 * arithmetic where x is 0 or has at most 24 significant bits and a value
 * put_e12_exact can make, else by snprintf, counted in *fallback. */
static char *put_e12(char *out, double x, int64_t *fallback) {
#ifdef __SIZEOF_INT128__
  uint64_t bits;
  memcpy(&bits, &x, sizeof bits);
  int be = (int)(bits >> 52) & 0x7ff;
  uint64_t frac = bits & ((1ULL << 52) - 1);
  if (be == 0 && frac == 0) { /* signed zero */
    if (bits >> 63) *out++ = '-';
    memcpy(out, "0.000000000000E+00", 18);
    return out + 18;
  }
  if (be != 0 && be != 0x7ff && (frac & ((1ULL << 29) - 1)) == 0) {
    char *start = out;
    if (bits >> 63) *out++ = '-';
    char *end = put_e12_exact(out, (frac >> 29) | (1ULL << 23), be - 1023 - 23);
    if (end) return end;
    out = start;
  }
#endif
  (*fallback)++;
  return out + snprintf(out, 21, "%.12E", x);
}

static int64_t now_ns(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return (int64_t)t.tv_sec * 1000000000 + t.tv_nsec;
}

typedef struct {
  const float *ux, *uy, *u, *p;
  const uint8_t *obst;
  long nx, n;     /* n = nx * ny lines */
  int quirk;      /* print obst[ii * nx + jj] (clipped) in place of obst[i] */
  int fd;
  long nblocks;
  pthread_mutex_t lock; /* guards the fields below */
  pthread_cond_t turn;
  long next_claim, next_write;
  int err;
  lbm_final_state_stats stats;
} final_state_job;

/* Format block b of the job into buf, counting the numbers handed to
 * snprintf in *fallback; its length, or -1 where a line does not fit
 * LINE_BYTES. */
static long format_block(const final_state_job *job, long b, char *buf, int64_t *fallback) {
  long first = b * BLOCK_LINES, last = first + BLOCK_LINES;
  if (last > job->n) last = job->n;
  char *out = buf;
  for (long i = first; i < last; i++) {
    long jj = i / job->nx, ii = i - jj * job->nx;
    long k = job->quirk ? ii * job->nx + jj : i;
    if (k > job->n - 1) k = job->n - 1;
    char *line = out;
    out = put_long(out, (int)ii);
    *out++ = ' ';
    out = put_long(out, (int)jj);
    *out++ = ' ';
    out = put_e12(out, (double)job->ux[i], fallback);
    *out++ = ' ';
    out = put_e12(out, (double)job->uy[i], fallback);
    *out++ = ' ';
    out = put_e12(out, (double)job->u[i], fallback);
    *out++ = ' ';
    out = put_e12(out, (double)job->p[i], fallback);
    *out++ = ' ';
    out = put_long(out, (int)job->obst[k]);
    *out++ = '\n';
    if (out - line >= LINE_BYTES) return -1;
  }
  return out - buf;
}

static void *final_state_worker(void *arg) {
  final_state_job *job = arg;
  lbm_final_state_stats mine = {0};
  char *buf = malloc((size_t)BLOCK_LINES * LINE_BYTES);
  pthread_mutex_lock(&job->lock);
  if (!buf) job->err = 2;
  while (!job->err && job->next_claim < job->nblocks) {
    long b = job->next_claim++;
    pthread_mutex_unlock(&job->lock);
    int64_t t0 = now_ns();
    long len = format_block(job, b, buf, &mine.fallback);
    int64_t t1 = now_ns();
    mine.format_ns += t1 - t0;
    mine.blocks++;
    pthread_mutex_lock(&job->lock);
    while (!job->err && job->next_write != b) pthread_cond_wait(&job->turn, &job->lock);
    int64_t t2 = now_ns();
    mine.wait_ns += t2 - t1;
    if (job->err) break;
    /* only the block whose turn it is writes; the others wait above */
    pthread_mutex_unlock(&job->lock);
    int bad = len < 0 || write_all(job->fd, buf, (size_t)len) != 0;
    mine.write_ns += now_ns() - t2;
    if (!bad) mine.bytes += len;
    pthread_mutex_lock(&job->lock);
    if (bad)
      job->err = 2;
    else
      job->next_write++;
    pthread_cond_broadcast(&job->turn);
  }
  pthread_cond_broadcast(&job->turn); /* wake the waiters after an error */
  job->stats.blocks += mine.blocks;
  job->stats.threads += mine.blocks > 0;
  job->stats.format_ns += mine.format_ns;
  job->stats.write_ns += mine.write_ns;
  job->stats.wait_ns += mine.wait_ns;
  job->stats.bytes += mine.bytes;
  job->stats.fallback += mine.fallback;
  pthread_mutex_unlock(&job->lock);
  free(buf);
  return NULL;
}

/* Write final_state.dat from the float32 (ny, nx) planes u_x, u_y, |u| and
 * pressure and the (ny, nx) 0/1 obstacle mask on up to `threads` threads
 * (the caller's among them; fewer where the blocks or pthread_create run
 * out), filling *stats unless it is NULL.  Returns 0, or 1 when the file
 * cannot be opened, 2 when a line cannot be formatted, a buffer allocated
 * or a block written, 3 when the file cannot be closed. */
int lbm_write_final_state(const char *path, const float *ux, const float *uy, const float *u,
                          const float *p, const uint8_t *obst, long nx, long ny, int quirk,
                          int threads, lbm_final_state_stats *stats) {
  int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0666);
  if (fd < 0) return 1;
  final_state_job job = {.ux = ux, .uy = uy, .u = u, .p = p, .obst = obst, .nx = nx,
                         .n = nx * ny, .quirk = quirk, .fd = fd};
  job.nblocks = (job.n + BLOCK_LINES - 1) / BLOCK_LINES;
  pthread_mutex_init(&job.lock, NULL);
  pthread_cond_init(&job.turn, NULL);
  long extra = threads - 1L;
  if (extra > job.nblocks - 1) extra = job.nblocks - 1;
  if (extra < 0) extra = 0;
  pthread_t *tids = extra ? malloc((size_t)extra * sizeof *tids) : NULL;
  long started = 0;
  while (tids && started < extra &&
         pthread_create(&tids[started], NULL, final_state_worker, &job) == 0)
    started++;
  final_state_worker(&job);
  for (long t = 0; t < started; t++) pthread_join(tids[t], NULL);
  free(tids);
  pthread_cond_destroy(&job.turn);
  pthread_mutex_destroy(&job.lock);
  if (stats) *stats = job.stats;
  int rc = job.err;
  if (close(fd) != 0 && rc == 0) rc = 3;
  return rc;
}

/* Write av_vels.dat from n float64 values, filling *stats unless it is
 * NULL.  Returns 0, or 1 when the file cannot be opened, 2 when a buffer
 * cannot be allocated or a block written, 3 when the file cannot be
 * closed. */
int lbm_write_av_vels(const char *path, const double *av, long n, lbm_av_vels_stats *stats) {
  int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0666);
  if (fd < 0) return 1;
  lbm_av_vels_stats mine = {0};
  char *buf = malloc((size_t)BLOCK_LINES * LINE_BYTES);
  int rc = buf ? 0 : 2;
  for (long first = 0; rc == 0 && first < n; first += BLOCK_LINES) {
    long last = first + BLOCK_LINES < n ? first + BLOCK_LINES : n;
    char *out = buf;
    int64_t t0 = now_ns();
    for (long i = first; i < last; i++) {
      out = put_long(out, i);
      *out++ = ':';
      *out++ = '\t';
      out = put_e12(out, av[i], &mine.fallback);
      *out++ = '\n';
    }
    int64_t t1 = now_ns();
    if (write_all(fd, buf, (size_t)(out - buf)) != 0)
      rc = 2;
    else
      mine.bytes += out - buf;
    mine.format_ns += t1 - t0;
    mine.write_ns += now_ns() - t1;
  }
  free(buf);
  if (stats) *stats = mine;
  if (close(fd) != 0 && rc == 0) rc = 3;
  return rc;
}

/* Parse one deck line of len bytes into v: 1 for three integers, each
 * followed by white space or the line's end; 0 for a blank line; -2 for
 * anything else. */
static int parse_line(const char *s, size_t len, long v[3]) {
  const char *p = s, *end = s + len;
  while (p < end && isspace((unsigned char)*p)) p++;
  if (p == end) return 0;
  for (int k = 0; k < 3; k++) {
    char *e;
    v[k] = strtol(p, &e, 10);
    if (e == p || (e < end && !isspace((unsigned char)*e))) return -2;
    p = e;
  }
  while (p < end && isspace((unsigned char)*p)) p++;
  return p == end ? 1 : -2;
}

/* Read an obstacle deck of "x y 1" lines into the row-major (ny, nx) byte
 * mask, with the reference's checks.  Returns the number of obstacle lines,
 * or -1 when the file cannot be opened, -2 for a line that is not three
 * integers, -3 for x out of range, -4 for y out of range, -5 for a blocked
 * value other than 1; on an error *err_line is the line's number (from 1). */
long lbm_parse_obstacles(const char *path, long nx, long ny, uint8_t *mask, long *err_line) {
  FILE *fp = fopen(path, "r");
  if (!fp) return -1;
  char *line = NULL;
  size_t cap = 0;
  ssize_t len;
  long count = 0, lineno = 0, rc = 0;
  while ((len = getline(&line, &cap, fp)) >= 0) {
    lineno++;
    long v[3];
    rc = parse_line(line, (size_t)len, v);
    if (rc == 0) continue;
    if (rc == 1) {
      if (v[0] < 0 || v[0] > nx - 1)
        rc = -3;
      else if (v[1] < 0 || v[1] > ny - 1)
        rc = -4;
      else if (v[2] != 1)
        rc = -5;
      else {
        mask[v[1] * nx + v[0]] = 1;
        count++;
        continue;
      }
    }
    *err_line = lineno;
    break;
  }
  free(line);
  fclose(fp);
  return rc < 0 ? rc : count;
}
