/* A standalone C host of the inference ABI (capi.cc): the way an
 * application without Python embeds a saved inference model.
 *
 *   capi_host MODEL_DIR FEED_NAME IN.f32 OUT.f32 D0 [D1 ...]
 *
 * reads one float32 feed of shape [D0, D1, ...] from IN.f32 (raw,
 * row-major), runs the model, writes its first output as raw float32 to
 * OUT.f32 and prints "ok <ndim> <dims...>".  On a failure it prints the
 * ABI's error (paddle_tpu_last_error) and exits 1.  The embedded
 * interpreter finds the port through PYTHONPATH; the session runs on
 * CUDAPlace(0) unless PADDLE_TPU_CAPI_PLACE=cpu.
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

extern const char* paddle_tpu_last_error(void);
extern int64_t paddle_tpu_inference_create(const char* model_dir);
extern int paddle_tpu_inference_feed(int64_t sid, const char* name,
                                     const void* data, const int64_t* dims,
                                     int ndim, int dtype);
extern int paddle_tpu_inference_run(int64_t sid);
extern int64_t paddle_tpu_inference_fetch(int64_t sid, int idx, float* buf,
                                          int64_t buf_capacity,
                                          int64_t* dims, int* ndim);
extern int paddle_tpu_inference_destroy(int64_t sid);

static int fail(const char* what) {
  printf("error %s: %s\n", what, paddle_tpu_last_error());
  return 1;
}

int main(int argc, char** argv) {
  if (argc < 6 || argc - 5 > 8) {
    fprintf(stderr, "usage: %s MODEL_DIR FEED_NAME IN.f32 OUT.f32 D0 "
                    "[D1 ...]\n", argv[0]);
    return 2;
  }
  int ndim = argc - 5;
  int64_t dims[8];
  int64_t count = 1;
  for (int i = 0; i < ndim; ++i) {
    dims[i] = atoll(argv[5 + i]);
    count *= dims[i];
  }
  float* in = (float*)malloc(sizeof(float) * (size_t)count);
  FILE* f = fopen(argv[3], "rb");
  if (in == NULL || f == NULL ||
      fread(in, sizeof(float), (size_t)count, f) != (size_t)count) {
    fprintf(stderr, "cannot read %lld floats from %s\n", (long long)count,
            argv[3]);
    return 2;
  }
  fclose(f);

  int64_t sid = paddle_tpu_inference_create(argv[1]);
  if (sid == 0) return fail("create");
  if (paddle_tpu_inference_feed(sid, argv[2], in, dims, ndim, 0) != 0)
    return fail("feed");
  if (paddle_tpu_inference_run(sid) < 1) return fail("run");

  int64_t cap = 1 << 24;
  float* out = (float*)malloc(sizeof(float) * (size_t)cap);
  int64_t odims[8];
  int ondim = 0;
  int64_t n = paddle_tpu_inference_fetch(sid, 0, out, cap, odims, &ondim);
  if (n < 0) return fail("fetch");
  FILE* g = fopen(argv[4], "wb");
  if (g == NULL || fwrite(out, sizeof(float), (size_t)n, g) != (size_t)n) {
    fprintf(stderr, "cannot write %s\n", argv[4]);
    return 2;
  }
  fclose(g);
  if (paddle_tpu_inference_destroy(sid) != 0) return fail("destroy");
  printf("ok %d", ondim);
  for (int i = 0; i < ondim; ++i) printf(" %lld", (long long)odims[i]);
  printf("\n");
  free(in);
  free(out);
  return 0;
}
