// C predict API — standalone inference ABI.
//
// The port's copy of src/c_predict_api.cc (parity: the reference's
// include/mxnet/c_predict_api.h and src/c_api/c_predict_api.cc, used by
// amalgamation mobile builds and example/image-classification/
// predict-cpp). The library EMBEDS CPython and drives the port's own
// executor through mxnet_tpu_torch/c_predict.py: one inference stack,
// one ABI, and the forward runs the same PyTorch operators and
// hand-written CUDA kernels as a Python caller's. dev_type 2 is the CUDA
// card (gpu(dev_id)), 1 the host. Works both from a standalone C program
// (initializes the interpreter; set PYTHONPATH to the repo and the
// interpreter's site-packages) and from inside an existing Python
// process (uses PyGILState).
//
// Exported surface mirrors the reference's names and call shapes:
//   MXPredCreate, MXPredCreatePartialOut, MXPredReshape, MXPredSetInput,
//   MXPredForward, MXPredPartialForward, MXPredGetOutputShape,
//   MXPredGetOutput, MXPredFree, MXNDListCreate/Get/Free,
//   MXGetLastError.

#include <Python.h>

#include "embed_common.h"

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

typedef unsigned int mx_uint;
typedef void* PredictorHandle;

namespace {

struct Pred {
  PyObject* obj;                 // mxnet_tpu_torch.predictor.Predictor
  std::vector<mx_uint> shape_buf;  // backing for MXPredGetOutputShape
};

// The embedded interpreter is never finalized: predictor handles may
// outlive any one call, and CUDA teardown at interpreter shutdown is not
// safe from an arbitrary unload point.
PyGILState_STATE EnsurePython() { return MXTPUEnsurePython(); }

PyObject* HelperModule() {
  static PyObject* mod = nullptr;
  if (mod == nullptr) {
    mod = PyImport_ImportModule("mxnet_tpu_torch.c_predict");
  }
  return mod;
}

void CaptureError() { MXTPUCaptureError(); }

}  // namespace

extern "C" {

// MXGetLastError is exported by embed_common.cc

int MXPredCreatePartialOut(const char* symbol_json_str,
                           const void* param_bytes, int param_size,
                           int dev_type, int dev_id,
                           mx_uint num_input_nodes, const char** input_keys,
                           const mx_uint* input_shape_indptr,
                           const mx_uint* input_shape_data,
                           mx_uint num_output_nodes,
                           const char** output_keys, PredictorHandle* out) {
  PyGILState_STATE gil = EnsurePython();
  int rc = -1;
  PyObject* mod = HelperModule();
  if (mod == nullptr) {
    CaptureError();
    PyGILState_Release(gil);
    return -1;
  }
  PyObject* names = PyList_New(num_input_nodes);
  PyObject* shapes = PyList_New(num_input_nodes);
  for (mx_uint i = 0; i < num_input_nodes; ++i) {
    PyList_SetItem(names, i, PyUnicode_FromString(input_keys[i]));
    mx_uint lo = input_shape_indptr[i], hi = input_shape_indptr[i + 1];
    PyObject* shp = PyList_New(hi - lo);
    for (mx_uint j = lo; j < hi; ++j)
      PyList_SetItem(shp, j - lo, PyLong_FromLong(input_shape_data[j]));
    PyList_SetItem(shapes, i, shp);
  }
  PyObject* outputs = Py_None;
  Py_INCREF(Py_None);
  if (num_output_nodes > 0) {
    Py_DECREF(Py_None);
    outputs = PyList_New(num_output_nodes);
    for (mx_uint i = 0; i < num_output_nodes; ++i)
      PyList_SetItem(outputs, i, PyUnicode_FromString(output_keys[i]));
  }
  PyObject* params = PyBytes_FromStringAndSize(
      static_cast<const char*>(param_bytes), param_size);
  PyObject* pred = PyObject_CallMethod(
      mod, "create", "sOiiOOO", symbol_json_str, params, dev_type, dev_id,
      names, shapes, outputs);
  Py_DECREF(params);
  Py_DECREF(names);
  Py_DECREF(shapes);
  Py_DECREF(outputs);
  if (pred == nullptr) {
    CaptureError();
  } else {
    Pred* p = new Pred();
    p->obj = pred;
    *out = p;
    rc = 0;
  }
  PyGILState_Release(gil);
  return rc;
}

int MXPredCreate(const char* symbol_json_str, const void* param_bytes,
                 int param_size, int dev_type, int dev_id,
                 mx_uint num_input_nodes, const char** input_keys,
                 const mx_uint* input_shape_indptr,
                 const mx_uint* input_shape_data, PredictorHandle* out) {
  return MXPredCreatePartialOut(symbol_json_str, param_bytes, param_size,
                                dev_type, dev_id, num_input_nodes,
                                input_keys, input_shape_indptr,
                                input_shape_data, 0, nullptr, out);
}

// (parity: MXPredReshape) a new handle bound to new input shapes that
// shares the donor's device-resident parameters; the donor stays valid.
int MXPredReshape(mx_uint num_input_nodes, const char** input_keys,
                  const mx_uint* input_shape_indptr,
                  const mx_uint* input_shape_data, PredictorHandle handle,
                  PredictorHandle* out) {
  Pred* p = static_cast<Pred*>(handle);
  PyGILState_STATE gil = EnsurePython();
  PyObject* names = PyList_New(num_input_nodes);
  PyObject* shapes = PyList_New(num_input_nodes);
  for (mx_uint i = 0; i < num_input_nodes; ++i) {
    PyList_SetItem(names, i, PyUnicode_FromString(input_keys[i]));
    mx_uint lo = input_shape_indptr[i], hi = input_shape_indptr[i + 1];
    PyObject* shp = PyList_New(hi - lo);
    for (mx_uint j = lo; j < hi; ++j)
      PyList_SetItem(shp, j - lo, PyLong_FromLong(input_shape_data[j]));
    PyList_SetItem(shapes, i, shp);
  }
  PyObject* pred = PyObject_CallMethod(HelperModule(), "reshape", "OOO",
                                       p->obj, names, shapes);
  Py_DECREF(names);
  Py_DECREF(shapes);
  int rc = -1;
  if (pred == nullptr) {
    CaptureError();
  } else {
    Pred* q = new Pred();
    q->obj = pred;
    *out = q;
    rc = 0;
  }
  PyGILState_Release(gil);
  return rc;
}

int MXPredSetInput(PredictorHandle handle, const char* key,
                   const float* data, mx_uint size) {
  Pred* p = static_cast<Pred*>(handle);
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = PyObject_CallMethod(
      HelperModule(), "set_input", "OsLI", p->obj, key,
      static_cast<long long>(reinterpret_cast<intptr_t>(data)), size);
  int rc = r != nullptr ? 0 : (CaptureError(), -1);
  Py_XDECREF(r);
  PyGILState_Release(gil);
  return rc;
}

int MXPredForward(PredictorHandle handle) {
  Pred* p = static_cast<Pred*>(handle);
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = PyObject_CallMethod(HelperModule(), "forward", "O", p->obj);
  int rc = r != nullptr ? 0 : (CaptureError(), -1);
  Py_XDECREF(r);
  PyGILState_Release(gil);
  return rc;
}

int MXPredGetOutputShape(PredictorHandle handle, mx_uint index,
                         mx_uint** shape_data, mx_uint* shape_ndim) {
  Pred* p = static_cast<Pred*>(handle);
  PyGILState_STATE gil = EnsurePython();
  PyObject* shp = PyObject_CallMethod(HelperModule(), "output_shape", "OI",
                                      p->obj, index);
  if (shp == nullptr) {
    CaptureError();
    PyGILState_Release(gil);
    return -1;
  }
  Py_ssize_t n = PyList_Size(shp);
  p->shape_buf.resize(n);
  for (Py_ssize_t i = 0; i < n; ++i)
    p->shape_buf[i] =
        static_cast<mx_uint>(PyLong_AsLong(PyList_GetItem(shp, i)));
  Py_DECREF(shp);
  *shape_data = p->shape_buf.data();
  *shape_ndim = static_cast<mx_uint>(n);
  PyGILState_Release(gil);
  return 0;
}

int MXPredGetOutput(PredictorHandle handle, mx_uint index, float* data,
                    mx_uint size) {
  Pred* p = static_cast<Pred*>(handle);
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = PyObject_CallMethod(
      HelperModule(), "copy_output", "OILI", p->obj, index,
      static_cast<long long>(reinterpret_cast<intptr_t>(data)), size);
  int rc = r != nullptr ? 0 : (CaptureError(), -1);
  Py_XDECREF(r);
  PyGILState_Release(gil);
  return rc;
}

// The reference steps the graph one engine op at a time
// (c_predict_api.cc PartialForward). Here the whole forward is one
// executor call — the minimal faithful mapping is a single step: step 0
// runs it, *step_left reports 0 afterwards.
int MXPredPartialForward(PredictorHandle handle, int step, int* step_left) {
  if (step_left != nullptr) *step_left = 0;
  if (step > 0) return 0;  // whole program already ran at step 0
  return MXPredForward(handle);
}

int MXPredFree(PredictorHandle handle) {
  Pred* p = static_cast<Pred*>(handle);
  PyGILState_STATE gil = EnsurePython();
  Py_XDECREF(p->obj);
  PyGILState_Release(gil);
  delete p;
  return 0;
}

// -- NDArray-list access over a saved blob (MXNDList*) ----------------------
// Handle owns the helper-module list; every pointer handed out (name,
// data, shape) is backed by objects stored in that list, valid until
// MXNDListFree.

typedef void* NDListHandle;

int MXNDListCreate(const char* nd_file_bytes, int nd_file_size,
                   NDListHandle* out, mx_uint* out_length) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* mod = HelperModule();
  if (mod == nullptr) {
    CaptureError();
    PyGILState_Release(gil);
    return -1;
  }
  PyObject* blob = PyBytes_FromStringAndSize(nd_file_bytes, nd_file_size);
  PyObject* lst = PyObject_CallMethod(mod, "ndlist_create", "O", blob);
  Py_DECREF(blob);
  if (lst == nullptr) {
    CaptureError();
    PyGILState_Release(gil);
    return -1;
  }
  *out = lst;
  *out_length = static_cast<mx_uint>(PyList_Size(lst));
  PyGILState_Release(gil);
  return 0;
}

int MXNDListGet(NDListHandle handle, mx_uint index, const char** out_key,
                const float** out_data, const mx_uint** out_shape,
                mx_uint* out_ndim) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* entry = PyObject_CallMethod(
      HelperModule(), "ndlist_entry", "OI",
      static_cast<PyObject*>(handle), index);
  if (entry == nullptr) {
    CaptureError();
    PyGILState_Release(gil);
    return -1;
  }
  // (name_bytes, data_addr, shape_addr, ndim); the bytes/array objects
  // live in the handle's list, so the raw pointers outlive `entry`
  *out_key = PyBytes_AsString(PyTuple_GetItem(entry, 0));
  *out_data = reinterpret_cast<const float*>(
      PyLong_AsLongLong(PyTuple_GetItem(entry, 1)));
  *out_shape = reinterpret_cast<const mx_uint*>(
      PyLong_AsLongLong(PyTuple_GetItem(entry, 2)));
  *out_ndim = static_cast<mx_uint>(
      PyLong_AsLong(PyTuple_GetItem(entry, 3)));
  Py_DECREF(entry);
  PyGILState_Release(gil);
  return 0;
}

int MXNDListFree(NDListHandle handle) {
  PyGILState_STATE gil = EnsurePython();
  Py_XDECREF(static_cast<PyObject*>(handle));
  PyGILState_Release(gil);
  return 0;
}

}  // extern "C"
