/* Host-side output codec and obstacle-deck reader of the PyTorch port.
 *
 * final_state.dat holds one line per cell in raster order (jj outer, ii
 * inner): "%d %d %.12E %.12E %.12E %.12E %d\n" of (ii, jj, u_x, u_y, |u|,
 * pressure, obstacle column), the reference writer's format.  The lines are
 * cut into blocks of BLOCK_LINES.  Each of up to T threads claims the next
 * block, formats it with libc's snprintf into a buffer of its own, waits
 * for its turn and writes the block, so the file holds the blocks in order
 * whatever the thread count, and memory stays at T buffers whatever the
 * grid.  av_vels.dat holds "%ld:\t%.12E\n" per step.  Obstacle decks are
 * "x y 1" lines, read into a (ny, nx) byte mask.
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
} final_state_job;

/* Format block b of the job into buf; its length, or -1 where a line does
 * not fit LINE_BYTES. */
static long format_block(const final_state_job *job, long b, char *buf) {
  long first = b * BLOCK_LINES, last = first + BLOCK_LINES;
  if (last > job->n) last = job->n;
  char *out = buf;
  for (long i = first; i < last; i++) {
    long jj = i / job->nx, ii = i - jj * job->nx;
    long k = job->quirk ? ii * job->nx + jj : i;
    if (k > job->n - 1) k = job->n - 1;
    int len = snprintf(out, LINE_BYTES, "%d %d %.12E %.12E %.12E %.12E %d\n", (int)ii,
                       (int)jj, (double)job->ux[i], (double)job->uy[i], (double)job->u[i],
                       (double)job->p[i], (int)job->obst[k]);
    if (len < 0 || len >= LINE_BYTES) return -1;
    out += len;
  }
  return out - buf;
}

static void *final_state_worker(void *arg) {
  final_state_job *job = arg;
  char *buf = malloc((size_t)BLOCK_LINES * LINE_BYTES);
  pthread_mutex_lock(&job->lock);
  if (!buf) job->err = 2;
  while (!job->err && job->next_claim < job->nblocks) {
    long b = job->next_claim++;
    pthread_mutex_unlock(&job->lock);
    long len = format_block(job, b, buf);
    pthread_mutex_lock(&job->lock);
    while (!job->err && job->next_write != b) pthread_cond_wait(&job->turn, &job->lock);
    if (job->err) break;
    /* only the block whose turn it is writes; the others wait above */
    pthread_mutex_unlock(&job->lock);
    int bad = len < 0 || write_all(job->fd, buf, (size_t)len) != 0;
    pthread_mutex_lock(&job->lock);
    if (bad)
      job->err = 2;
    else
      job->next_write++;
    pthread_cond_broadcast(&job->turn);
  }
  pthread_cond_broadcast(&job->turn); /* wake the waiters after an error */
  pthread_mutex_unlock(&job->lock);
  free(buf);
  return NULL;
}

/* Write final_state.dat from the float32 (ny, nx) planes u_x, u_y, |u| and
 * pressure and the (ny, nx) 0/1 obstacle mask on up to `threads` threads
 * (the caller's among them; fewer where the blocks or pthread_create run
 * out).  Returns 0, or 1 when the file cannot be opened, 2 when a line
 * cannot be formatted, a buffer allocated or a block written, 3 when the
 * file cannot be closed. */
int lbm_write_final_state(const char *path, const float *ux, const float *uy, const float *u,
                          const float *p, const uint8_t *obst, long nx, long ny, int quirk,
                          int threads) {
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
  int rc = job.err;
  if (close(fd) != 0 && rc == 0) rc = 3;
  return rc;
}

/* Write av_vels.dat from n float64 values.  Returns 0, or 1 when the file
 * cannot be opened, 2 when a buffer cannot be allocated or a block
 * written, 3 when the file cannot be closed. */
int lbm_write_av_vels(const char *path, const double *av, long n) {
  int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0666);
  if (fd < 0) return 1;
  char *buf = malloc((size_t)BLOCK_LINES * LINE_BYTES);
  int rc = buf ? 0 : 2;
  for (long first = 0; rc == 0 && first < n; first += BLOCK_LINES) {
    long last = first + BLOCK_LINES < n ? first + BLOCK_LINES : n;
    char *out = buf;
    for (long i = first; i < last; i++) out += snprintf(out, LINE_BYTES, "%ld:\t%.12E\n", i, av[i]);
    if (write_all(fd, buf, (size_t)(out - buf)) != 0) rc = 2;
  }
  free(buf);
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
