// The C inference API (paddle_tpu_c.h): embeds (or attaches to) the Python
// runtime and drives paddle_tpu_torch.inference.Predictor through the
// CPython API, as the reference's runtime_cpp/paddle_tpu_c.cc drives its
// own Predictor.
#include "paddle_tpu_c.h"

#include <Python.h>

#include <cstring>
#include <string>

namespace {

thread_local std::string g_last_error;

void set_error(const std::string& msg) { g_last_error = msg; }

void set_py_error(const char* where) {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  std::string msg = where;
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* text = PyUnicode_AsUTF8(s);
      msg += ": ";
      msg += text ? text : "?";
      Py_DECREF(s);
    }
  }
  PyErr_Clear();
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_error(msg);
}

struct GIL {
  PyGILState_STATE st;
  GIL() : st(PyGILState_Ensure()) {}
  ~GIL() { PyGILState_Release(st); }
};

// Start the interpreter as the one that built this library (its executable
// locates its prefix and site-packages, a virtual environment's included).
bool start_python() {
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  config.install_signal_handlers = 0;
  PyStatus st = PyConfig_SetBytesString(&config, &config.program_name,
                                        PTT_PYTHON_EXECUTABLE);
  if (!PyStatus_Exception(st)) {
    st = PyConfig_SetBytesString(&config, &config.executable,
                                 PTT_PYTHON_EXECUTABLE);
  }
  if (!PyStatus_Exception(st)) st = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(st)) {
    set_error(std::string("Python initialization failed: ") +
              (st.err_msg ? st.err_msg : "?"));
    return false;
  }
  PyEval_SaveThread();  // any thread may now take the GIL
  return true;
}

}  // namespace

struct PD_Predictor {
  PyObject* predictor = nullptr;  // paddle_tpu_torch.inference.Predictor
  std::string scratch_name;       // storage for returned name pointers
};

extern "C" {

int PD_Init(const char* repo_root) {
  if (!Py_IsInitialized() && !start_python()) return -1;
  GIL gil;
  if (repo_root != nullptr) {
    PyObject* sys_path = PySys_GetObject("path");  // borrowed
    PyObject* root = PyUnicode_FromString(repo_root);
    if (sys_path == nullptr || root == nullptr ||
        PyList_Insert(sys_path, 0, root) != 0) {
      Py_XDECREF(root);
      set_py_error("sys.path");
      return -1;
    }
    Py_DECREF(root);
  }
  return 0;
}

PD_Predictor* PD_PredictorCreateOnDevice(const char* model_prefix,
                                         const char* device) {
  if (!Py_IsInitialized() && PD_Init(nullptr) != 0) return nullptr;
  GIL gil;
  PyObject* mod = PyImport_ImportModule("paddle_tpu_torch.inference.capi");
  if (mod == nullptr) {
    set_py_error("import paddle_tpu_torch.inference.capi");
    return nullptr;
  }
  PyObject* pred = PyObject_CallMethod(mod, "create_predictor", "sz",
                                       model_prefix, device);
  Py_DECREF(mod);
  if (pred == nullptr) {
    set_py_error("create_predictor");
    return nullptr;
  }
  auto* p = new PD_Predictor();
  p->predictor = pred;
  return p;
}

PD_Predictor* PD_PredictorCreate(const char* model_prefix) {
  return PD_PredictorCreateOnDevice(model_prefix, nullptr);
}

static PyObject* get_handle(PD_Predictor* p, const char* name, bool input) {
  PyObject* h = PyObject_CallMethod(
      p->predictor, input ? "get_input_handle" : "get_output_handle", "s",
      name);
  if (h == nullptr) set_py_error("get_handle");
  return h;
}

int PD_PredictorSetInputFloat(PD_Predictor* p, const char* name,
                              const float* data, const int64_t* shape,
                              int ndim) {
  GIL gil;
  int64_t numel = 1;
  for (int i = 0; i < ndim; ++i) numel *= shape[i];
  PyObject* np = PyImport_ImportModule("numpy");
  if (np == nullptr) {
    set_py_error("import numpy");
    return -1;
  }
  // numpy.frombuffer(bytes, float32).reshape(shape): the bytes object owns
  // a copy of the caller's data
  PyObject* bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(data), numel * sizeof(float));
  PyObject* arr = bytes ? PyObject_CallMethod(np, "frombuffer", "Os", bytes,
                                              "float32")
                        : nullptr;
  PyObject* shp = PyTuple_New(ndim);
  for (int i = 0; shp != nullptr && i < ndim; ++i) {
    PyTuple_SetItem(shp, i, PyLong_FromLongLong(shape[i]));
  }
  PyObject* reshaped =
      (arr && shp) ? PyObject_CallMethod(arr, "reshape", "O", shp) : nullptr;
  Py_XDECREF(bytes);
  Py_XDECREF(arr);
  Py_XDECREF(shp);
  Py_DECREF(np);
  if (reshaped == nullptr) {
    set_py_error("build input array");
    return -1;
  }
  PyObject* h = get_handle(p, name, true);
  PyObject* r =
      h ? PyObject_CallMethod(h, "copy_from_cpu", "O", reshaped) : nullptr;
  Py_DECREF(reshaped);
  Py_XDECREF(h);
  if (r == nullptr) {
    set_py_error("copy_from_cpu");
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

int PD_PredictorRun(PD_Predictor* p) {
  GIL gil;
  PyObject* r = PyObject_CallMethod(p->predictor, "run", nullptr);
  if (r == nullptr) {
    set_py_error("run");
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

// The named output as a contiguous float32 numpy array (new reference).
static PyObject* output_f32(PD_Predictor* p, const char* name) {
  PyObject* h = get_handle(p, name, false);
  if (h == nullptr) return nullptr;
  PyObject* arr = PyObject_CallMethod(h, "copy_to_cpu", nullptr);
  Py_DECREF(h);
  if (arr == nullptr) {
    set_py_error("copy_to_cpu");
    return nullptr;
  }
  PyObject* np = PyImport_ImportModule("numpy");
  PyObject* f32 = np ? PyObject_CallMethod(np, "ascontiguousarray", "Os",
                                           arr, "float32")
                     : nullptr;
  Py_XDECREF(np);
  Py_DECREF(arr);
  if (f32 == nullptr) set_py_error("float32 output");
  return f32;
}

int64_t PD_PredictorOutputNumel(PD_Predictor* p, const char* name) {
  GIL gil;
  PyObject* arr = output_f32(p, name);
  if (arr == nullptr) return -1;
  PyObject* size = PyObject_GetAttrString(arr, "size");
  int64_t n = size ? PyLong_AsLongLong(size) : -1;
  Py_XDECREF(size);
  Py_DECREF(arr);
  if (n < 0) set_py_error("size");
  return n;
}

int PD_PredictorOutputShape(PD_Predictor* p, const char* name,
                            int64_t* shape, int* ndim) {
  GIL gil;
  PyObject* arr = output_f32(p, name);
  if (arr == nullptr) return -1;
  PyObject* shp = PyObject_GetAttrString(arr, "shape");
  Py_DECREF(arr);
  if (shp == nullptr) {
    set_py_error("shape");
    return -1;
  }
  Py_ssize_t n = PyTuple_Size(shp);
  if (n > 8) n = 8;
  for (Py_ssize_t i = 0; i < n; ++i) {
    shape[i] = PyLong_AsLongLong(PyTuple_GetItem(shp, i));
  }
  *ndim = static_cast<int>(n);
  Py_DECREF(shp);
  return 0;
}

int PD_PredictorGetOutputFloat(PD_Predictor* p, const char* name, float* buf,
                               int64_t buf_elems) {
  GIL gil;
  PyObject* arr = output_f32(p, name);
  if (arr == nullptr) return -1;
  PyObject* bytes = PyObject_CallMethod(arr, "tobytes", nullptr);
  Py_DECREF(arr);
  if (bytes == nullptr) {
    set_py_error("tobytes");
    return -1;
  }
  char* src = nullptr;
  Py_ssize_t len = 0;
  PyBytes_AsStringAndSize(bytes, &src, &len);
  int64_t elems = len / static_cast<int64_t>(sizeof(float));
  if (elems > buf_elems) {
    Py_DECREF(bytes);
    set_error("output larger than buffer");
    return -1;
  }
  std::memcpy(buf, src, elems * sizeof(float));
  Py_DECREF(bytes);
  return 0;
}

static const char* io_name(PD_Predictor* p, int index, bool input) {
  GIL gil;
  PyObject* names = PyObject_CallMethod(
      p->predictor, input ? "get_input_names" : "get_output_names", nullptr);
  if (names == nullptr) {
    set_py_error("get_names");
    return nullptr;
  }
  PyObject* item = PySequence_GetItem(names, index);
  Py_DECREF(names);
  if (item == nullptr) {
    set_py_error("name index");
    return nullptr;
  }
  const char* text = PyUnicode_AsUTF8(item);
  if (text == nullptr) {
    Py_DECREF(item);
    set_py_error("name");
    return nullptr;
  }
  p->scratch_name = text;
  Py_DECREF(item);
  return p->scratch_name.c_str();
}

const char* PD_PredictorInputName(PD_Predictor* p, int index) {
  return io_name(p, index, true);
}

const char* PD_PredictorOutputName(PD_Predictor* p, int index) {
  return io_name(p, index, false);
}

void PD_PredictorDestroy(PD_Predictor* p) {
  if (p == nullptr) return;
  {
    GIL gil;
    Py_XDECREF(p->predictor);
  }
  delete p;
}

const char* PD_LastError(void) { return g_last_error.c_str(); }

}  // extern "C"
