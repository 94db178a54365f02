/* Every float32 bit pattern, widened to double, through the codec's own
 * "%.12E" (put_e12 of csrc/fastio.c) and through libc's snprintf, on
 * threads; prints the count of patterns, of mismatches, of numbers the
 * codec made itself, and the first mismatching pattern.
 *
 *   cc -O2 -pthread -I advanced_hpc_lbm_tpu_torch/csrc -o e12 tests/codec_e12_exhaustive.c
 *   ./e12 THREADS [STRIDE]       # every STRIDE-th pattern (default 1: all 2^32)
 */

#include "fastio.c"

typedef struct {
  uint64_t first, stride, count;
  uint64_t seen, mismatches, exact;
  uint32_t first_bad;
} slice;

static void *run(void *arg) {
  slice *s = arg;
  char mine[32], libc[32];
  for (uint64_t i = 0; i < s->count; i++) {
    uint32_t bits = (uint32_t)(s->first + i * s->stride);
    float f;
    memcpy(&f, &bits, sizeof f);
    int64_t fallback = 0;
    long n = put_e12(mine, (double)f, &fallback) - mine;
    int m = snprintf(libc, sizeof libc, "%.12E", (double)f);
    if (n != m || memcmp(mine, libc, (size_t)m) != 0) {
      if (!s->mismatches) s->first_bad = bits;
      s->mismatches++;
    }
    s->exact += fallback == 0;
    s->seen++;
  }
  return NULL;
}

int main(int argc, char **argv) {
  long threads = argc > 1 ? atol(argv[1]) : 1;
  uint64_t stride = argc > 2 ? strtoull(argv[2], NULL, 10) : 1;
  if (threads < 1 || stride < 1) return 2;
  /* thread t takes patterns t, t + T, t + 2T, ... of the strided ones:
   * the slow patterns (snprintf's, clustered by exponent) spread evenly */
  uint64_t total = ((1ULL << 32) + stride - 1) / stride;
  slice *s = calloc((size_t)threads, sizeof *s);
  pthread_t *tids = calloc((size_t)threads, sizeof *tids);
  if (!s || !tids) return 3;
  for (long t = 0; t < threads; t++) {
    s[t].first = (uint64_t)t * stride;
    s[t].stride = stride * (uint64_t)threads;
    s[t].count = (uint64_t)t < total ? (total - (uint64_t)t + threads - 1) / threads : 0;
    if (pthread_create(&tids[t], NULL, run, &s[t]) != 0) return 3;
  }
  uint64_t seen = 0, mismatches = 0, exact = 0;
  uint32_t first_bad = 0;
  for (long t = 0; t < threads; t++) {
    pthread_join(tids[t], NULL);
    seen += s[t].seen;
    exact += s[t].exact;
    if (s[t].mismatches && !mismatches) first_bad = s[t].first_bad;
    mismatches += s[t].mismatches;
  }
  printf("patterns %llu mismatches %llu exact %llu first_bad 0x%08x\n",
         (unsigned long long)seen, (unsigned long long)mismatches, (unsigned long long)exact,
         first_bad);
  return 0;
}
