// A standalone C++ host of the port's C inference ABI (paddle_tpu_c.h),
// outside Python: it embeds the runtime through PD_Init, as the
// reference's runtime_cpp/capi_demo.cc does.
//
// Usage: capi_demo [--device cpu|cuda|cuda:N] <model_prefix> <repo_root>
//                  <d0> [d1 ...]
// Feeds a deterministic ramp input of shape (d0, d1, ...), runs, and prints
// one JSON line with the output count, its sum and its first four values.
#include "paddle_tpu_c.h"

#include <cinttypes>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

int main(int argc, char** argv) {
  const char* device = nullptr;
  int a = 1;
  if (argc > 2 && std::strcmp(argv[1], "--device") == 0) {
    device = argv[2];
    a = 3;
  }
  if (argc - a < 3) {
    std::fprintf(stderr,
                 "usage: %s [--device D] <model_prefix> <repo_root> <d0> "
                 "[d1 ...]\n",
                 argv[0]);
    return 2;
  }
  const char* prefix = argv[a];
  const char* repo_root = argv[a + 1];
  std::vector<int64_t> shape;
  int64_t numel = 1;
  for (int i = a + 2; i < argc; ++i) {
    shape.push_back(std::atoll(argv[i]));
    numel *= shape.back();
  }

  if (PD_Init(repo_root) != 0) {
    std::fprintf(stderr, "PD_Init failed: %s\n", PD_LastError());
    return 1;
  }
  PD_Predictor* p = PD_PredictorCreateOnDevice(prefix, device);
  if (!p) {
    std::fprintf(stderr, "create failed: %s\n", PD_LastError());
    return 1;
  }
  const char* in_name = PD_PredictorInputName(p, 0);
  if (!in_name) {
    std::fprintf(stderr, "input name failed: %s\n", PD_LastError());
    return 1;
  }

  // deterministic ramp, mirrored by the callers that check the output
  std::vector<float> x(static_cast<size_t>(numel));
  for (int64_t i = 0; i < numel; ++i)
    x[static_cast<size_t>(i)] = static_cast<float>(i % 17) * 0.25f - 2.0f;

  if (PD_PredictorSetInputFloat(p, in_name, x.data(), shape.data(),
                                static_cast<int>(shape.size())) != 0) {
    std::fprintf(stderr, "set input failed: %s\n", PD_LastError());
    return 1;
  }
  if (PD_PredictorRun(p) != 0) {
    std::fprintf(stderr, "run failed: %s\n", PD_LastError());
    return 1;
  }
  const char* out_name = PD_PredictorOutputName(p, 0);
  int64_t n_out = out_name ? PD_PredictorOutputNumel(p, out_name) : -1;
  if (n_out < 0) {
    std::fprintf(stderr, "output numel failed: %s\n", PD_LastError());
    return 1;
  }
  std::vector<float> y(static_cast<size_t>(n_out));
  if (PD_PredictorGetOutputFloat(p, out_name, y.data(), n_out) != 0) {
    std::fprintf(stderr, "get output failed: %s\n", PD_LastError());
    return 1;
  }
  double sum = 0.0;
  for (float v : y) sum += v;
  std::printf("{\"numel\": %" PRId64 ", \"sum\": %.6f, \"head\": [", n_out,
              sum);
  for (int i = 0; i < 4 && i < n_out; ++i)
    std::printf("%s%.6f", i ? ", " : "", y[static_cast<size_t>(i)]);
  std::printf("]}\n");
  PD_PredictorDestroy(p);
  return 0;
}
