/* prefetch.c: the port's native host runtime, loaded with ctypes.
 *
 * A copy of icet_tpu/native/icet_native.c:1-310 (binary and delimited-text
 * cloud loaders, and a bounded, ORDERED, multithreaded prefetch queue that
 * reads and pads scans in producer pthreads while the consumer runs the
 * solver on the card), with the CPython binding replaced by a plain C
 * interface, so that it builds with the host compiler alone:
 *
 *   cc -O3 -pthread -shared -fPIC -o prefetch.so prefetch.c
 *
 * needing neither Python.h nor numpy's headers.  The interface:
 *
 *   icet_prefetch_open(paths, n_paths, max_points, n_threads, depth, loop,
 *                      repeat) -> handle, or NULL
 *   icet_prefetch_next(handle, out, &n) -> 1 (a scan in out), 0 (the end),
 *                      -1 (an error: icet_prefetch_error(handle))
 *   icet_prefetch_close(handle)
 *   icet_load_cloud(path, out, max_points, errmsg, errlen) -> n or -1
 *
 * ``out`` holds max_points * 3 floats, zero-padded past the n points read.
 */

#include <errno.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <math.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* Binary loaders                                                      */
/* ------------------------------------------------------------------ */

/* Load a .npy file containing an (N, 3) float32/float64 C-order array into
 * out[max_points*3], zero-padding the tail.  Returns n points loaded or -1
 * (errmsg filled). */
static long load_npy_into(const char *path, float *out, long max_points,
                          char *errmsg, size_t errlen) {
  FILE *f = fopen(path, "rb");
  if (!f) {
    snprintf(errmsg, errlen, "cannot open %s: %s", path, strerror(errno));
    return -1;
  }
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, "\x93NUMPY", 6) != 0) {
    snprintf(errmsg, errlen, "%s: not a .npy file", path);
    fclose(f);
    return -1;
  }
  int major = magic[6];
  uint32_t hlen = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) goto badhdr;
    hlen = b[0] | (b[1] << 8);
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) goto badhdr;
    hlen = b[0] | (b[1] << 8) | ((uint32_t)b[2] << 16) | ((uint32_t)b[3] << 24);
  }
  {
    char *hdr = (char *)malloc(hlen + 1);
    if (!hdr || fread(hdr, 1, hlen, f) != hlen) {
      free(hdr);
      goto badhdr;
    }
    hdr[hlen] = 0;

    int is_f8 = strstr(hdr, "<f8") != NULL;
    int is_f4 = strstr(hdr, "<f4") != NULL;
    if ((!is_f4 && !is_f8) || strstr(hdr, "'fortran_order': True")) {
      snprintf(errmsg, errlen, "%s: unsupported npy layout: %s", path, hdr);
      free(hdr);
      fclose(f);
      return -1;
    }
    const char *sh = strstr(hdr, "'shape':");
    long n = 0, cols = 0;
    if (!sh || sscanf(sh, "'shape': (%ld, %ld)", &n, &cols) != 2 || cols != 3) {
      snprintf(errmsg, errlen, "%s: expected (N, 3) shape", path);
      free(hdr);
      fclose(f);
      return -1;
    }
    free(hdr);

    long take = n < max_points ? n : max_points;
    if (is_f4) {
      if (fread(out, sizeof(float), (size_t)take * 3, f) != (size_t)take * 3)
        goto badhdr;
    } else {
      double *tmp = (double *)malloc(sizeof(double) * (size_t)take * 3);
      if (!tmp || fread(tmp, sizeof(double), (size_t)take * 3, f) !=
                      (size_t)take * 3) {
        free(tmp);
        goto badhdr;
      }
      for (long i = 0; i < take * 3; i++) out[i] = (float)tmp[i];
      free(tmp);
    }
    memset(out + take * 3, 0, sizeof(float) * (size_t)(max_points - take) * 3);
    fclose(f);
    return take;
  }
badhdr:
  snprintf(errmsg, errlen, "%s: truncated/corrupt npy", path);
  fclose(f);
  return -1;
}

/* KITTI velodyne .bin: float32 (x, y, z, reflectance) records. */
static long load_bin_into(const char *path, float *out, long max_points,
                          char *errmsg, size_t errlen) {
  FILE *f = fopen(path, "rb");
  if (!f) {
    snprintf(errmsg, errlen, "cannot open %s: %s", path, strerror(errno));
    return -1;
  }
  fseek(f, 0, SEEK_END);
  long bytes = ftell(f);
  fseek(f, 0, SEEK_SET);
  long n = bytes / (4 * (long)sizeof(float));
  long take = n < max_points ? n : max_points;
  float rec[4];
  for (long i = 0; i < take; i++) {
    if (fread(rec, sizeof(float), 4, f) != 4) {
      snprintf(errmsg, errlen, "%s: truncated .bin", path);
      fclose(f);
      return -1;
    }
    out[i * 3 + 0] = rec[0];
    out[i * 3 + 1] = rec[1];
    out[i * 3 + 2] = rec[2];
  }
  memset(out + take * 3, 0, sizeof(float) * (size_t)(max_points - take) * 3);
  fclose(f);
  return take;
}

/* Delimited-text clouds — the role the reference fills with the vendored
 * 8486-line csv.hpp (utils.cpp:12-91): comma/space/tab separated numeric
 * rows; non-numeric lines (headers) are skipped.  Rows with >= 11 fields
 * are Ouster studio exports (XYZ in millimetres in columns 8-10, matching
 * loadPointCloudCSV's "ouster" branch); shorter rows are generic xyz.
 * Mode is sniffed from the first numeric row, like the python loader. */
static long load_csv_into(const char *path, float *out, long max_points,
                          char *errmsg, size_t errlen) {
  FILE *f = fopen(path, "r");
  if (!f) {
    snprintf(errmsg, errlen, "cannot open %s: %s", path, strerror(errno));
    return -1;
  }
  char line[8192];
  long take = 0;
  int mode = 0; /* 0 = undecided, 1 = xyz, 2 = ouster cols 8-10 mm */
  while (take < max_points && fgets(line, sizeof line, f)) {
    double vals[16];
    int n = 0;
    const char *p = line;
    while (n < 16) {
      while (*p == ',' || *p == ' ' || *p == '\t') p++;
      if (*p == '\0' || *p == '\n' || *p == '\r') break;
      char *end;
      double v = strtod(p, &end);
      if (end == p) { n = -1; break; } /* non-numeric field: header line */
      vals[n++] = v;
      p = end;
    }
    if (n < 3) continue;
    if (mode == 0) mode = (n >= 11) ? 2 : 1;
    double x, y, z;
    if (mode == 2) {
      if (n < 11) continue;
      x = vals[8] / 1000.0;
      y = vals[9] / 1000.0;
      z = vals[10] / 1000.0;
    } else {
      x = vals[0];
      y = vals[1];
      z = vals[2];
    }
    /* strtod accepts "nan"/"inf" (no-return points in some exports); drop
     * such rows like the python loader does — a NaN coordinate would
     * silently poison the whole moment accumulation downstream. */
    if (!isfinite(x) || !isfinite(y) || !isfinite(z)) continue;
    out[take * 3 + 0] = (float)x;
    out[take * 3 + 1] = (float)y;
    out[take * 3 + 2] = (float)z;
    take++;
  }
  memset(out + take * 3, 0, sizeof(float) * (size_t)(max_points - take) * 3);
  fclose(f);
  if (take == 0) {
    snprintf(errmsg, errlen, "%s: no numeric rows", path);
    return -1;
  }
  return take;
}

static long load_any_into(const char *path, float *out, long max_points,
                          char *errmsg, size_t errlen) {
  size_t len = strlen(path);
  if (len > 4 && strcmp(path + len - 4, ".npy") == 0)
    return load_npy_into(path, out, max_points, errmsg, errlen);
  if (len > 4 && strcmp(path + len - 4, ".bin") == 0)
    return load_bin_into(path, out, max_points, errmsg, errlen);
  if (len > 4 && (strcmp(path + len - 4, ".csv") == 0 ||
                  strcmp(path + len - 4, ".txt") == 0))
    return load_csv_into(path, out, max_points, errmsg, errlen);
  snprintf(errmsg, errlen, "%s: native loader handles .npy/.bin/.csv/.txt",
           path);
  return -1;
}

/* ------------------------------------------------------------------ */
/* Ordered multithreaded prefetch queue                                */
/* ------------------------------------------------------------------ */

typedef struct {
  char **paths;
  long n_paths;
  long max_points;
  int depth;       /* slots */
  int n_threads;
  int loop;        /* reference fake_lidar.py:191-196 loops the sequence */
  long total;      /* frames to serve; n_paths if !loop else LONG_MAX-ish */

  float **slot_buf;   /* depth x (max_points*3) */
  long *slot_frame;   /* frame id READY in the slot, or -1 */
  long *slot_npts;    /* valid points in the slot */
  long next_to_load;  /* producer cursor */
  long consumed;      /* consumer cursor */
  int shutdown;
  int error;
  char errmsg[512];

  pthread_mutex_t mu;
  pthread_cond_t cv_ready;  /* consumer waits for its slot */
  pthread_cond_t cv_free;   /* producers wait for slot reuse */
  pthread_t *threads;
} Prefetcher;

static void *producer_main(void *arg) {
  Prefetcher *q = (Prefetcher *)arg;
  char errmsg[512];
  for (;;) {
    pthread_mutex_lock(&q->mu);
    long frame;
    for (;;) {
      if (q->shutdown || q->error || q->next_to_load >= q->total) {
        pthread_mutex_unlock(&q->mu);
        return NULL;
      }
      frame = q->next_to_load;
      /* The frame's slot is free once the consumer has finished frame-depth. */
      if (frame - q->consumed < q->depth) {
        q->next_to_load = frame + 1;
        break;
      }
      pthread_cond_wait(&q->cv_free, &q->mu);
    }
    pthread_mutex_unlock(&q->mu);

    const char *path = q->paths[frame % q->n_paths];
    float *buf = q->slot_buf[frame % q->depth];
    long n = load_any_into(path, buf, q->max_points, errmsg, sizeof errmsg);

    pthread_mutex_lock(&q->mu);
    if (n < 0 && !q->error) {
      q->error = 1;
      strncpy(q->errmsg, errmsg, sizeof q->errmsg - 1);
    } else {
      q->slot_frame[frame % q->depth] = frame;
      q->slot_npts[frame % q->depth] = n;
    }
    pthread_cond_broadcast(&q->cv_ready);
    pthread_mutex_unlock(&q->mu);
  }
}

static void prefetcher_free(Prefetcher *q) {
  if (!q) return;
  pthread_mutex_lock(&q->mu);
  q->shutdown = 1;
  pthread_cond_broadcast(&q->cv_free);
  pthread_cond_broadcast(&q->cv_ready);
  pthread_mutex_unlock(&q->mu);
  for (int i = 0; i < q->n_threads; i++) pthread_join(q->threads[i], NULL);
  for (int i = 0; i < q->depth; i++) free(q->slot_buf[i]);
  for (long i = 0; i < q->n_paths; i++) free(q->paths[i]);
  free(q->paths);
  free(q->slot_buf);
  free(q->slot_frame);
  free(q->slot_npts);
  free(q->threads);
  pthread_mutex_destroy(&q->mu);
  pthread_cond_destroy(&q->cv_ready);
  pthread_cond_destroy(&q->cv_free);
  free(q);
}

/* ------------------------------------------------------------------ */
/* Plain C interface (ctypes)                                          */
/* ------------------------------------------------------------------ */

void *icet_prefetch_open(const char **paths, long n_paths, long max_points,
                         int n_threads, int depth, int loop, long repeat) {
  if (n_paths <= 0 || max_points <= 0) return NULL;
  Prefetcher *q = (Prefetcher *)calloc(1, sizeof(Prefetcher));
  if (!q) return NULL;
  q->paths = (char **)calloc(n_paths, sizeof(char *));
  q->n_paths = n_paths;
  for (long i = 0; i < n_paths; i++) q->paths[i] = strdup(paths[i]);

  q->max_points = max_points;
  q->depth = depth > 0 ? depth : 4;
  q->n_threads = n_threads > 0 ? n_threads : 1;
  q->loop = loop;
  q->total = loop ? (repeat > 0 ? repeat * n_paths : 0x3FFFFFFFFFFFFFFFL)
                  : n_paths;

  q->slot_buf = (float **)calloc(q->depth, sizeof(float *));
  q->slot_frame = (long *)malloc(sizeof(long) * q->depth);
  q->slot_npts = (long *)calloc(q->depth, sizeof(long));
  for (int i = 0; i < q->depth; i++) {
    q->slot_buf[i] = (float *)malloc(sizeof(float) * (size_t)max_points * 3);
    q->slot_frame[i] = -1;
  }
  pthread_mutex_init(&q->mu, NULL);
  pthread_cond_init(&q->cv_ready, NULL);
  pthread_cond_init(&q->cv_free, NULL);
  q->threads = (pthread_t *)calloc(q->n_threads, sizeof(pthread_t));
  for (int i = 0; i < q->n_threads; i++)
    pthread_create(&q->threads[i], NULL, producer_main, q);
  return q;
}

/* Blocking ordered pop into out[max_points*3]; *n gets the valid points. */
int icet_prefetch_next(void *handle, float *out, long *n) {
  Prefetcher *q = (Prefetcher *)handle;
  long frame;
  float *src = NULL;
  pthread_mutex_lock(&q->mu);
  frame = q->consumed;
  while (!q->error && frame < q->total &&
         q->slot_frame[frame % q->depth] != frame)
    pthread_cond_wait(&q->cv_ready, &q->mu);
  if (q->error) {
    pthread_mutex_unlock(&q->mu);
    return -1;
  }
  if (frame >= q->total) {
    pthread_mutex_unlock(&q->mu);
    return 0;
  }
  src = q->slot_buf[frame % q->depth];
  *n = q->slot_npts[frame % q->depth];
  pthread_mutex_unlock(&q->mu);

  memcpy(out, src, sizeof(float) * (size_t)q->max_points * 3);

  pthread_mutex_lock(&q->mu);
  q->slot_frame[frame % q->depth] = -1;
  q->consumed = frame + 1;
  pthread_cond_broadcast(&q->cv_free);
  pthread_mutex_unlock(&q->mu);
  return 1;
}

const char *icet_prefetch_error(void *handle) {
  return ((Prefetcher *)handle)->errmsg;
}

void icet_prefetch_close(void *handle) {
  prefetcher_free((Prefetcher *)handle);
}

long icet_load_cloud(const char *path, float *out, long max_points,
                     char *errmsg, long errlen) {
  return load_any_into(path, out, max_points, errmsg, (size_t)errlen);
}
