// C inference ABI over the embedded-Python engine (capi_runtime.py).
//
// Reference: Paddle's paddle/capi/ (gradient_machine.h
// paddle_gradient_machine_create_for_inference_with_parameters, forward;
// examples/model_inference) — a pure-C embedding surface for trained
// models.  The engine behind the C ABI is the PyTorch port's Executor
// (on CUDAPlace(0) unless PADDLE_TPU_CAPI_PLACE=cpu) reached through
// CPython: the host app links _capi.so, everything Python stays behind
// these six functions, whose names and signatures are the C ABI's own.
//
// Works both ways: from a standalone C program (initializes an embedded
// interpreter; set PYTHONPATH to the repo/site-packages) and from inside
// an existing Python process via ctypes (uses the live interpreter).
//
// All functions return 0 on success (or a handle); on failure they return
// nonzero/NULL and paddle_tpu_last_error() describes the Python exception.
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>

namespace {

// Per-thread so the pointer returned by paddle_tpu_last_error() stays
// valid while other threads fail concurrently.
thread_local std::string g_last_error;
std::once_flag g_init_once;

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  std::string msg = "unknown error";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  g_last_error = msg;
}

void set_error(const char* msg) { g_last_error = msg; }

// RAII GIL acquisition that also boots the interpreter on first use when
// running embedded in a plain C program.
class Gil {
 public:
  Gil() {
    std::call_once(g_init_once, [] {
      if (!Py_IsInitialized()) {
        Py_InitializeEx(0);
        // release the GIL taken by Py_Initialize so PyGILState works
        PyEval_SaveThread();
      }
    });
    state_ = PyGILState_Ensure();
  }
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

PyObject* runtime_module() {
  return PyImport_ImportModule("paddle_tpu_torch.capi_runtime");
}

// call paddle_tpu_torch.capi_runtime.<fn>(*args); returns new ref or nullptr
PyObject* call_runtime(const char* fn, PyObject* args) {
  PyObject* mod = runtime_module();
  if (mod == nullptr) return nullptr;
  PyObject* f = PyObject_GetAttrString(mod, fn);
  Py_DECREF(mod);
  if (f == nullptr) return nullptr;
  PyObject* r = PyObject_CallObject(f, args);
  Py_DECREF(f);
  return r;
}

}  // namespace

extern "C" {

const char* paddle_tpu_last_error() { return g_last_error.c_str(); }

// -> session handle (>0), or 0 on failure
int64_t paddle_tpu_inference_create(const char* model_dir) {
  Gil gil;
  PyObject* args = Py_BuildValue("(s)", model_dir);
  PyObject* r = call_runtime("create", args);
  Py_XDECREF(args);
  if (r == nullptr) {
    set_error_from_python();
    return 0;
  }
  int64_t sid = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return sid;
}

// dtype: 0=float32, 1=int64, 2=int32.  dims: ndim entries.
int paddle_tpu_inference_feed(int64_t sid, const char* name,
                              const void* data, const int64_t* dims,
                              int ndim, int dtype) {
  Gil gil;
  int64_t count = 1;
  for (int i = 0; i < ndim; ++i) count *= dims[i];
  const int64_t elem = (dtype == 0) ? 4 : (dtype == 1 ? 8 : 4);
  PyObject* dim_list = PyList_New(ndim);
  if (dim_list == nullptr) {
    set_error("alloc failure");
    return 1;
  }
  for (int i = 0; i < ndim; ++i) {
    PyList_SET_ITEM(dim_list, i, PyLong_FromLongLong(dims[i]));
  }
  PyObject* args = Py_BuildValue(
      "(Lsy#iN)", static_cast<long long>(sid), name,
      static_cast<const char*>(data),
      static_cast<Py_ssize_t>(count * elem), dtype, dim_list);
  if (args == nullptr) {
    set_error_from_python();
    return 1;
  }
  PyObject* r = call_runtime("feed", args);
  Py_DECREF(args);
  if (r == nullptr) {
    set_error_from_python();
    return 1;
  }
  Py_DECREF(r);
  return 0;
}

// runs the model; -> number of fetch outputs, or -1 on failure
int paddle_tpu_inference_run(int64_t sid) {
  Gil gil;
  PyObject* args = Py_BuildValue("(L)", static_cast<long long>(sid));
  PyObject* r = call_runtime("run", args);
  Py_XDECREF(args);
  if (r == nullptr) {
    set_error_from_python();
    return -1;
  }
  int n = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return n;
}

// copy output `idx` (as float32) into buf; writes its shape into
// dims/ndim (dims capacity: 8). -> element count, or -1 on failure
// (including buf_capacity too small).
int64_t paddle_tpu_inference_fetch(int64_t sid, int idx, float* buf,
                                   int64_t buf_capacity, int64_t* dims,
                                   int* ndim) {
  Gil gil;
  PyObject* args = Py_BuildValue("(Li)", static_cast<long long>(sid), idx);
  PyObject* r = call_runtime("fetch", args);
  Py_XDECREF(args);
  if (r == nullptr) {
    set_error_from_python();
    return -1;
  }
  // r = (bytes, [dims...])
  PyObject* payload = PyTuple_GetItem(r, 0);
  PyObject* shape = PyTuple_GetItem(r, 1);
  char* raw = nullptr;
  Py_ssize_t nbytes = 0;
  if (payload == nullptr || shape == nullptr ||
      PyBytes_AsStringAndSize(payload, &raw, &nbytes) != 0) {
    Py_DECREF(r);
    set_error_from_python();
    return -1;
  }
  const int64_t count = nbytes / 4;
  if (count > buf_capacity) {
    Py_DECREF(r);
    set_error("fetch buffer too small");
    return -1;
  }
  Py_ssize_t rank = PyList_Size(shape);
  if (rank > 8) {
    Py_DECREF(r);
    set_error("output rank exceeds dims capacity (8)");
    return -1;
  }
  std::memcpy(buf, raw, nbytes);
  if (ndim != nullptr) *ndim = static_cast<int>(rank);
  if (dims != nullptr) {
    for (Py_ssize_t i = 0; i < rank; ++i) {
      dims[i] = PyLong_AsLongLong(PyList_GetItem(shape, i));
    }
  }
  Py_DECREF(r);
  return count;
}

int paddle_tpu_inference_destroy(int64_t sid) {
  Gil gil;
  PyObject* args = Py_BuildValue("(L)", static_cast<long long>(sid));
  PyObject* r = call_runtime("destroy", args);
  Py_XDECREF(args);
  if (r == nullptr) {
    set_error_from_python();
    return 1;
  }
  Py_DECREF(r);
  return 0;
}

}  // extern "C"
