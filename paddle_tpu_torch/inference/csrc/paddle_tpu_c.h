/* paddle_tpu_torch C inference API.
 *
 * The reference's C ABI (paddle_tpu's runtime_cpp/paddle_tpu_c.h; role
 * parity with Paddle's inference/capi_exp/pd_inference_api.h) over the
 * port's predictor: this layer embeds the Python runtime (or attaches to an
 * already running interpreter) and drives paddle_tpu_torch.inference, whose
 * Predictor runs a torch.export program on the card (or the CPU). The
 * create / set-input / run / get-output lifecycle takes plain C types.
 *
 * Thread-safety: calls grab the GIL; one predictor per thread recommended
 * (a PD_PredictorCreate per thread, like the reference's
 * AnalysisPredictor::Clone guidance).
 */
#ifndef PADDLE_TPU_TORCH_C_H_
#define PADDLE_TPU_TORCH_C_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct PD_Predictor PD_Predictor;

/* Optional: initialize the embedded Python runtime explicitly (as the
 * interpreter the library was built by, so its packages are found).
 * repo_root is prepended to sys.path (may be NULL if paddle_tpu_torch is
 * already importable). No-op when called from inside a running
 * interpreter (e.g. a ctypes host). Returns 0 on success. */
int PD_Init(const char* repo_root);

/* Load an artifact saved by paddle_tpu_torch.static.save_inference_model
 * (model_prefix as in Config(prefix)) onto the card (cuda:0). NULL on
 * failure (see PD_LastError). */
PD_Predictor* PD_PredictorCreate(const char* model_prefix);

/* The same onto `device`: "cpu", "cuda" or "cuda:<id>" (NULL: the card).
 * Not in the reference's ABI, which has no device argument. */
PD_Predictor* PD_PredictorCreateOnDevice(const char* model_prefix,
                                         const char* device);

/* Copy a float32 input into the named input handle. shape has ndim dims. */
int PD_PredictorSetInputFloat(PD_Predictor* p, const char* name,
                              const float* data, const int64_t* shape,
                              int ndim);

/* Execute. Returns 0 on success. */
int PD_PredictorRun(PD_Predictor* p);

/* Number of elements of the named output (after Run). Negative on error. */
int64_t PD_PredictorOutputNumel(PD_Predictor* p, const char* name);

/* Output rank and shape. shape must hold at least 8 entries. */
int PD_PredictorOutputShape(PD_Predictor* p, const char* name,
                            int64_t* shape, int* ndim);

/* Copy the named output, as float32, into buf (buf_elems capacity). */
int PD_PredictorGetOutputFloat(PD_Predictor* p, const char* name, float* buf,
                               int64_t buf_elems);

/* Input/output names by index. The returned pointer is owned by the
 * predictor and valid until the next call. */
const char* PD_PredictorInputName(PD_Predictor* p, int index);
const char* PD_PredictorOutputName(PD_Predictor* p, int index);

void PD_PredictorDestroy(PD_Predictor* p);

/* Last error message (thread-local, empty string if none). */
const char* PD_LastError(void);

#ifdef __cplusplus
}
#endif

#endif /* PADDLE_TPU_TORCH_C_H_ */
