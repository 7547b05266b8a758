// General C API — the language-binding ABI.
//
// The port's copy of src/c_api.cc (parity: the reference's
// src/c_api/{c_api.cc,c_api_ndarray.cc,c_api_symbolic.cc,
// c_api_executor.cc} slice of the 159-function MXNET_DLL surface,
// include/mxnet/c_api.h, that powers the cpp-package/scala/R/perl
// frontends). Same design as c_predict_api.cc: the library embeds
// CPython and drives the port's own executor through
// mxnet_tpu_torch/c_api_impl.py, so a C driver trains and infers on the
// exact PyTorch/CUDA path Python users run (dev_type 2 is the CUDA card,
// 1 the host). Handles are owned PyObject* of the framework objects.
//
// Exported surface (reference names and call shapes):
//   MXGetLastError, MXNDArrayCreate/CreateEx/Free,
//   MXNDArraySyncCopyFromCPU/SyncCopyToCPU, MXNDArrayGetShape/GetDType,
//   MXNDArrayWaitToRead/WaitToWrite/WaitAll, MXNDArraySave/Load,
//   MXListAllOpNames, NNGetOpHandle, MXImperativeInvoke,
//   MXSymbolCreateFromJSON/CreateFromFile/Free,
//   MXSymbolListArguments/ListOutputs/ListAuxiliaryStates,
//   MXSymbolInferShape, MXExecutorBind/Forward/Backward/Outputs/Free.
// Round-4 tranche (reference c_api.h:359-1269): runtime knobs +
// profiler, NDArray slice/at/reshape/context/grad/raw-bytes, the full
// MXSymbol attr/compose/atomic surface, MXExecutorSimpleBind/BackwardEx,
// MXDataIter*, MXKVStore* (incl. C-callback updater), MXRecordIO*,
// MXAutograd*, CachedOp — each backed by mxnet_tpu_torch/c_api_impl.py
// and exercised from tests/test_torch_c_api.py via ctypes. The RTC block
// compiles CUDA C with NVRTC (mxnet_tpu_torch/rtc.py), as the reference
// does.

#include <Python.h>

#include <cstdarg>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "embed_common.h"

typedef unsigned int mx_uint;
typedef void* NDArrayHandle;
typedef void* SymbolHandle;
typedef void* ExecutorHandle;
typedef void* AtomicSymbolCreator;

namespace {

// String/shape buffers whose pointers we hand out must stay alive until
// the next API call on the same thread (the reference uses thread-local
// return buffers, c_api.h "callee keeps ownership").
thread_local std::vector<std::string> g_str_store;
thread_local std::vector<const char*> g_str_ptrs;
thread_local std::vector<mx_uint> g_shape_buf;
thread_local std::vector<std::vector<mx_uint>> g_shape_store;
thread_local std::vector<const mx_uint*> g_shape_ptrs;
thread_local std::vector<mx_uint> g_ndim_buf;
thread_local std::vector<void*> g_handle_buf;

PyGILState_STATE EnsurePython() { return MXTPUEnsurePython(); }

PyObject* Impl() {
  static PyObject* mod = nullptr;
  if (mod == nullptr) {
    mod = PyImport_ImportModule("mxnet_tpu_torch.c_api_impl");
  }
  return mod;
}

void CaptureError() { MXTPUCaptureError(); }

// Call impl helper `name` with pre-built args tuple; returns new ref or
// nullptr with g_last_error set.
PyObject* CallImpl(const char* name, PyObject* args) {
  PyObject* mod = Impl();
  if (mod == nullptr) {
    CaptureError();
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* fn = PyObject_GetAttrString(mod, name);
  if (fn == nullptr) {
    CaptureError();
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* res = PyObject_CallObject(fn, args);
  Py_DECREF(fn);
  Py_XDECREF(args);
  if (res == nullptr) CaptureError();
  return res;
}

PyObject* StrList(const char** arr, mx_uint n) {
  PyObject* lst = PyList_New(n);
  for (mx_uint i = 0; i < n; ++i)
    PyList_SetItem(lst, i, PyUnicode_FromString(arr[i] ? arr[i] : ""));
  return lst;
}

PyObject* HandleList(NDArrayHandle* arr, mx_uint n) {
  PyObject* lst = PyList_New(n);
  for (mx_uint i = 0; i < n; ++i) {
    PyObject* o = arr && arr[i] ? static_cast<PyObject*>(arr[i]) : Py_None;
    Py_INCREF(o);
    PyList_SetItem(lst, i, o);
  }
  return lst;
}

// Store a python list of str into thread-local storage; out gets char**.
int ReturnStrList(PyObject* lst, mx_uint* out_size, const char*** out_array) {
  Py_ssize_t n = PyList_Size(lst);
  g_str_store.clear();
  g_str_ptrs.clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    const char* c = PyUnicode_AsUTF8(PyList_GetItem(lst, i));
    g_str_store.emplace_back(c ? c : "");
  }
  for (auto& s : g_str_store) g_str_ptrs.push_back(s.c_str());
  *out_size = static_cast<mx_uint>(n);
  *out_array = g_str_ptrs.data();
  return 0;
}

int ReturnHandleList(PyObject* lst, mx_uint* out_size,
                     NDArrayHandle** out_array) {
  Py_ssize_t n = PyList_Size(lst);
  g_handle_buf.clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* o = PyList_GetItem(lst, i);
    Py_INCREF(o);  // handle owns a reference; freed by MXNDArrayFree
    g_handle_buf.push_back(o);
  }
  *out_size = static_cast<mx_uint>(n);
  *out_array = g_handle_buf.data();
  return 0;
}

}  // namespace

extern "C" {

// MXGetLastError is exported by embed_common.cc

// ---- NDArray --------------------------------------------------------------

int MXNDArrayCreateEx(const mx_uint* shape, mx_uint ndim, int dev_type,
                      int dev_id, int delay_alloc, int dtype,
                      NDArrayHandle* out) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* shp = PyList_New(ndim);
  for (mx_uint i = 0; i < ndim; ++i)
    PyList_SetItem(shp, i, PyLong_FromUnsignedLong(shape[i]));
  PyObject* args = Py_BuildValue("(Oiiii)", shp, dev_type, dev_id,
                                 delay_alloc, dtype);
  Py_DECREF(shp);
  PyObject* nd = CallImpl("ndarray_create", args);
  int rc = -1;
  if (nd != nullptr) {
    *out = nd;  // transfer ownership to the handle
    rc = 0;
  }
  PyGILState_Release(gil);
  return rc;
}

int MXNDArrayCreate(const mx_uint* shape, mx_uint ndim, int dev_type,
                    int dev_id, int delay_alloc, NDArrayHandle* out) {
  return MXNDArrayCreateEx(shape, ndim, dev_type, dev_id, delay_alloc, 0,
                           out);
}

int MXNDArrayFree(NDArrayHandle handle) {
  PyGILState_STATE gil = EnsurePython();
  Py_XDECREF(static_cast<PyObject*>(handle));
  PyGILState_Release(gil);
  return 0;
}

int MXNDArraySyncCopyFromCPU(NDArrayHandle handle, const void* data,
                             size_t size) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* args = Py_BuildValue(
      "(OLn)", static_cast<PyObject*>(handle),
      static_cast<long long>(reinterpret_cast<intptr_t>(data)),
      static_cast<Py_ssize_t>(size));
  PyObject* r = CallImpl("ndarray_sync_copy_from", args);
  int rc = r != nullptr ? 0 : -1;
  Py_XDECREF(r);
  PyGILState_Release(gil);
  return rc;
}

int MXNDArraySyncCopyToCPU(NDArrayHandle handle, void* data, size_t size) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* args = Py_BuildValue(
      "(OLn)", static_cast<PyObject*>(handle),
      static_cast<long long>(reinterpret_cast<intptr_t>(data)),
      static_cast<Py_ssize_t>(size));
  PyObject* r = CallImpl("ndarray_sync_copy_to", args);
  int rc = r != nullptr ? 0 : -1;
  Py_XDECREF(r);
  PyGILState_Release(gil);
  return rc;
}

int MXNDArrayGetShape(NDArrayHandle handle, mx_uint* out_dim,
                      const mx_uint** out_pdata) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* args = Py_BuildValue("(O)", static_cast<PyObject*>(handle));
  PyObject* shp = CallImpl("ndarray_shape", args);
  if (shp == nullptr) {
    PyGILState_Release(gil);
    return -1;
  }
  Py_ssize_t n = PyList_Size(shp);
  g_shape_buf.resize(n);
  for (Py_ssize_t i = 0; i < n; ++i)
    g_shape_buf[i] =
        static_cast<mx_uint>(PyLong_AsLong(PyList_GetItem(shp, i)));
  Py_DECREF(shp);
  *out_dim = static_cast<mx_uint>(n);
  *out_pdata = g_shape_buf.data();
  PyGILState_Release(gil);
  return 0;
}

int MXNDArrayGetDType(NDArrayHandle handle, int* out_dtype) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* args = Py_BuildValue("(O)", static_cast<PyObject*>(handle));
  PyObject* r = CallImpl("ndarray_dtype", args);
  int rc = -1;
  if (r != nullptr) {
    *out_dtype = static_cast<int>(PyLong_AsLong(r));
    Py_DECREF(r);
    rc = 0;
  }
  PyGILState_Release(gil);
  return rc;
}

int MXNDArrayWaitToRead(NDArrayHandle handle) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* args = Py_BuildValue("(O)", static_cast<PyObject*>(handle));
  PyObject* r = CallImpl("ndarray_wait", args);
  int rc = r != nullptr ? 0 : -1;
  Py_XDECREF(r);
  PyGILState_Release(gil);
  return rc;
}

int MXNDArrayWaitToWrite(NDArrayHandle handle) {
  return MXNDArrayWaitToRead(handle);
}

int MXNDArrayWaitAll() {
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = CallImpl("wait_all", PyTuple_New(0));
  int rc = r != nullptr ? 0 : -1;
  Py_XDECREF(r);
  PyGILState_Release(gil);
  return rc;
}

int MXNDArraySave(const char* fname, mx_uint num_args, NDArrayHandle* args,
                  const char** keys) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* nds = HandleList(args, num_args);
  PyObject* ks = keys != nullptr ? StrList(keys, num_args) : PyList_New(0);
  PyObject* a = Py_BuildValue("(sOO)", fname, nds, ks);
  Py_DECREF(nds);
  Py_DECREF(ks);
  PyObject* r = CallImpl("ndarray_save", a);
  int rc = r != nullptr ? 0 : -1;
  Py_XDECREF(r);
  PyGILState_Release(gil);
  return rc;
}

int MXNDArrayLoad(const char* fname, mx_uint* out_size,
                  NDArrayHandle** out_arr, mx_uint* out_name_size,
                  const char*** out_names) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* a = Py_BuildValue("(s)", fname);
  PyObject* r = CallImpl("ndarray_load", a);
  if (r == nullptr) {
    PyGILState_Release(gil);
    return -1;
  }
  PyObject* nds = PyTuple_GetItem(r, 0);
  PyObject* names = PyTuple_GetItem(r, 1);
  ReturnHandleList(nds, out_size, out_arr);
  ReturnStrList(names, out_name_size, out_names);
  Py_DECREF(r);
  PyGILState_Release(gil);
  return 0;
}

// ---- operators ------------------------------------------------------------

int MXListAllOpNames(mx_uint* out_size, const char*** out_array) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = CallImpl("op_names", PyTuple_New(0));
  if (r == nullptr) {
    PyGILState_Release(gil);
    return -1;
  }
  ReturnStrList(r, out_size, out_array);
  Py_DECREF(r);
  PyGILState_Release(gil);
  return 0;
}

// Op handles are name strings validated against the registry (the
// reference hands out nnvm::Op* and errors on unknown names).
int NNGetOpHandle(const char* name, AtomicSymbolCreator* out) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = CallImpl("op_exists", Py_BuildValue("(s)", name));
  int rc = -1;
  if (r != nullptr) {
    if (PyObject_IsTrue(r)) {
      *out = new std::string(name);  // leaked by design: handles live forever
      rc = 0;
    } else {
      mxtpu_last_error = std::string("operator not registered: ") + name;
    }
    Py_DECREF(r);
  }
  PyGILState_Release(gil);
  return rc;
}

int MXImperativeInvoke(AtomicSymbolCreator creator, int num_inputs,
                       NDArrayHandle* inputs, int* num_outputs,
                       NDArrayHandle** outputs, int num_params,
                       const char** param_keys, const char** param_vals) {
  PyGILState_STATE gil = EnsurePython();
  std::string* name = static_cast<std::string*>(creator);
  PyObject* ins = HandleList(inputs, num_inputs);
  PyObject* keys = StrList(param_keys, num_params);
  PyObject* vals = StrList(param_vals, num_params);
  PyObject* outs;
  if (*num_outputs > 0 && *outputs != nullptr) {
    outs = HandleList(*outputs, *num_outputs);
  } else {
    outs = Py_None;
    Py_INCREF(Py_None);
  }
  PyObject* a = Py_BuildValue("(sOOOO)", name->c_str(), ins, keys, vals,
                              outs);
  Py_DECREF(ins);
  Py_DECREF(keys);
  Py_DECREF(vals);
  Py_DECREF(outs);
  PyObject* r = CallImpl("imperative_invoke", a);
  if (r == nullptr) {
    PyGILState_Release(gil);
    return -1;
  }
  if (*num_outputs <= 0 || *outputs == nullptr) {
    mx_uint n = 0;
    ReturnHandleList(r, &n, outputs);
    *num_outputs = static_cast<int>(n);
  }
  Py_DECREF(r);
  PyGILState_Release(gil);
  return 0;
}

// ---- symbols --------------------------------------------------------------

int MXSymbolCreateFromJSON(const char* json, SymbolHandle* out) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = CallImpl("symbol_from_json", Py_BuildValue("(s)", json));
  int rc = -1;
  if (r != nullptr) {
    *out = r;
    rc = 0;
  }
  PyGILState_Release(gil);
  return rc;
}

int MXSymbolCreateFromFile(const char* fname, SymbolHandle* out) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = CallImpl("symbol_from_file", Py_BuildValue("(s)", fname));
  int rc = -1;
  if (r != nullptr) {
    *out = r;
    rc = 0;
  }
  PyGILState_Release(gil);
  return rc;
}

int MXSymbolFree(SymbolHandle handle) {
  PyGILState_STATE gil = EnsurePython();
  Py_XDECREF(static_cast<PyObject*>(handle));
  PyGILState_Release(gil);
  return 0;
}

static int SymStrList(SymbolHandle sym, const char* fn, mx_uint* out_size,
                      const char*** out_array) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = CallImpl(fn, Py_BuildValue("(O)",
                                           static_cast<PyObject*>(sym)));
  if (r == nullptr) {
    PyGILState_Release(gil);
    return -1;
  }
  ReturnStrList(r, out_size, out_array);
  Py_DECREF(r);
  PyGILState_Release(gil);
  return 0;
}

int MXSymbolListArguments(SymbolHandle sym, mx_uint* out_size,
                          const char*** out_array) {
  return SymStrList(sym, "symbol_arguments", out_size, out_array);
}

int MXSymbolListOutputs(SymbolHandle sym, mx_uint* out_size,
                        const char*** out_array) {
  return SymStrList(sym, "symbol_outputs", out_size, out_array);
}

int MXSymbolListAuxiliaryStates(SymbolHandle sym, mx_uint* out_size,
                                const char*** out_array) {
  return SymStrList(sym, "symbol_aux", out_size, out_array);
}

int MXSymbolInferShape(SymbolHandle sym, mx_uint num_args, const char** keys,
                       const mx_uint* arg_ind_ptr, const mx_uint* arg_shape_data,
                       mx_uint* in_shape_size, const mx_uint** in_shape_ndim,
                       const mx_uint*** in_shape_data, mx_uint* out_shape_size,
                       const mx_uint** out_shape_ndim,
                       const mx_uint*** out_shape_data, mx_uint* aux_shape_size,
                       const mx_uint** aux_shape_ndim,
                       const mx_uint*** aux_shape_data, int* complete) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* names = StrList(keys, num_args);
  PyObject* shapes = PyList_New(num_args);
  for (mx_uint i = 0; i < num_args; ++i) {
    mx_uint lo = arg_ind_ptr[i], hi = arg_ind_ptr[i + 1];
    PyObject* s = PyList_New(hi - lo);
    for (mx_uint j = lo; j < hi; ++j)
      PyList_SetItem(s, j - lo, PyLong_FromUnsignedLong(arg_shape_data[j]));
    PyList_SetItem(shapes, i, s);
  }
  PyObject* a = Py_BuildValue("(OOO)", static_cast<PyObject*>(sym), names,
                              shapes);
  Py_DECREF(names);
  Py_DECREF(shapes);
  PyObject* r = CallImpl("symbol_infer_shape", a);
  if (r == nullptr) {
    PyGILState_Release(gil);
    return -1;
  }
  // unpack three shape-list groups into thread-local storage
  g_shape_store.clear();
  g_shape_ptrs.clear();
  g_ndim_buf.clear();
  mx_uint sizes[3];
  size_t offsets[4] = {0, 0, 0, 0};
  for (int grp = 0; grp < 3; ++grp) {
    PyObject* lst = PyTuple_GetItem(r, grp);
    Py_ssize_t n = PyList_Size(lst);
    sizes[grp] = static_cast<mx_uint>(n);
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* s = PyList_GetItem(lst, i);
      Py_ssize_t nd = PyList_Size(s);
      std::vector<mx_uint> v(nd);
      for (Py_ssize_t j = 0; j < nd; ++j)
        v[j] = static_cast<mx_uint>(PyLong_AsLong(PyList_GetItem(s, j)));
      g_shape_store.push_back(std::move(v));
      g_ndim_buf.push_back(static_cast<mx_uint>(nd));
    }
    offsets[grp + 1] = g_shape_store.size();
  }
  for (auto& v : g_shape_store) g_shape_ptrs.push_back(v.data());
  *in_shape_size = sizes[0];
  *in_shape_ndim = g_ndim_buf.data() + offsets[0];
  *in_shape_data = g_shape_ptrs.data() + offsets[0];
  *out_shape_size = sizes[1];
  *out_shape_ndim = g_ndim_buf.data() + offsets[1];
  *out_shape_data = g_shape_ptrs.data() + offsets[1];
  *aux_shape_size = sizes[2];
  *aux_shape_ndim = g_ndim_buf.data() + offsets[2];
  *aux_shape_data = g_shape_ptrs.data() + offsets[2];
  *complete = PyObject_IsTrue(PyTuple_GetItem(r, 3));
  Py_DECREF(r);
  PyGILState_Release(gil);
  return 0;
}

// ---- executor ---------------------------------------------------------------

int MXExecutorBind(SymbolHandle sym, int dev_type, int dev_id, mx_uint len,
                   NDArrayHandle* in_args, NDArrayHandle* arg_grad_store,
                   mx_uint* grad_req_type, mx_uint aux_states_len,
                   NDArrayHandle* aux_states, ExecutorHandle* out) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* args = HandleList(in_args, len);
  PyObject* grads = HandleList(arg_grad_store, len);
  PyObject* reqs = PyList_New(len);
  for (mx_uint i = 0; i < len; ++i)
    PyList_SetItem(reqs, i, PyLong_FromUnsignedLong(grad_req_type[i]));
  PyObject* aux = HandleList(aux_states, aux_states_len);
  PyObject* a = Py_BuildValue("(OiiOOOO)", static_cast<PyObject*>(sym),
                              dev_type, dev_id, args, grads, reqs, aux);
  Py_DECREF(args);
  Py_DECREF(grads);
  Py_DECREF(reqs);
  Py_DECREF(aux);
  PyObject* r = CallImpl("executor_bind", a);
  int rc = -1;
  if (r != nullptr) {
    *out = r;
    rc = 0;
  }
  PyGILState_Release(gil);
  return rc;
}

int MXExecutorForward(ExecutorHandle handle, int is_train) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* a = Py_BuildValue("(Oi)", static_cast<PyObject*>(handle),
                              is_train);
  PyObject* r = CallImpl("executor_forward", a);
  int rc = r != nullptr ? 0 : -1;
  Py_XDECREF(r);
  PyGILState_Release(gil);
  return rc;
}

int MXExecutorBackward(ExecutorHandle handle, mx_uint len,
                       NDArrayHandle* head_grads) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* hg = HandleList(head_grads, len);
  PyObject* a = Py_BuildValue("(OO)", static_cast<PyObject*>(handle), hg);
  Py_DECREF(hg);
  PyObject* r = CallImpl("executor_backward", a);
  int rc = r != nullptr ? 0 : -1;
  Py_XDECREF(r);
  PyGILState_Release(gil);
  return rc;
}

int MXExecutorOutputs(ExecutorHandle handle, mx_uint* out_size,
                      NDArrayHandle** out) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* a = Py_BuildValue("(O)", static_cast<PyObject*>(handle));
  PyObject* r = CallImpl("executor_outputs", a);
  if (r == nullptr) {
    PyGILState_Release(gil);
    return -1;
  }
  ReturnHandleList(r, out_size, out);
  Py_DECREF(r);
  PyGILState_Release(gil);
  return 0;
}

int MXExecutorFree(ExecutorHandle handle) {
  PyGILState_STATE gil = EnsurePython();
  Py_XDECREF(static_cast<PyObject*>(handle));
  PyGILState_Release(gil);
  return 0;
}

}  // extern "C"

// ===========================================================================
// Round-4 tranche
// ===========================================================================

typedef void* KVStoreHandle;
typedef void* DataIterHandle;
typedef void* DataIterCreator;
typedef void* RecordIOHandle;
typedef void* CachedOpHandle;
typedef void (*MXKVStoreUpdater)(int, NDArrayHandle, NDArrayHandle, void*);
typedef void (*MXKVStoreStrUpdater)(const char*, NDArrayHandle, NDArrayHandle,
                                    void*);
typedef void (*MXKVStoreServerController)(int, const char*, void*);

namespace {

// extra thread-local return stores (one call may hand out several lists)
thread_local std::string g_ret_str;
thread_local std::string g_ret_str2;
thread_local std::vector<std::string> g_info_store;
thread_local std::vector<const char*> g_info_ptrs[3];
thread_local std::vector<int> g_int_buf;
thread_local std::vector<uint64_t> g_u64_buf;
thread_local std::string g_rec_buf;
thread_local std::vector<void*> g_handle_buf2;


// call an impl fn; ignore result
int CallVoid(const char* name, PyObject* args) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = CallImpl(name, args);
  int rc = r != nullptr ? 0 : -1;
  Py_XDECREF(r);
  PyGILState_Release(gil);
  return rc;
}

// call an impl fn; transfer the new python object to a handle
int CallHandle(const char* name, PyObject* args, void** out) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = CallImpl(name, args);
  int rc = -1;
  if (r != nullptr) {
    if (r == Py_None) {  // e.g. get_children of a leaf -> NULL handle
      Py_DECREF(r);
      *out = nullptr;
    } else {
      *out = r;
    }
    rc = 0;
  }
  PyGILState_Release(gil);
  return rc;
}


// Variadic forms: acquire the GIL BEFORE building the args tuple.
// ctypes/other FFI callers invoke these functions WITHOUT the GIL, so a
// Py_BuildValue evaluated in the caller's argument list would touch the
// interpreter unlocked (the round-4 segfault).
int CallIntV(const char* name, int* out, const char* fmt, ...) {
  PyGILState_STATE gil = EnsurePython();
  va_list ap;
  va_start(ap, fmt);
  PyObject* args = Py_VaBuildValue(fmt, ap);
  va_end(ap);
  PyObject* r = CallImpl(name, args);
  int rc = -1;
  if (r != nullptr) {
    *out = static_cast<int>(PyLong_AsLong(r));
    Py_DECREF(r);
    rc = 0;
  }
  PyGILState_Release(gil);
  return rc;
}

int CallVoidV(const char* name, const char* fmt, ...) {
  PyGILState_STATE gil = EnsurePython();
  va_list ap;
  va_start(ap, fmt);
  PyObject* args = Py_VaBuildValue(fmt, ap);
  va_end(ap);
  PyObject* r = CallImpl(name, args);
  int rc = r != nullptr ? 0 : -1;
  Py_XDECREF(r);
  PyGILState_Release(gil);
  return rc;
}

int CallHandleV(const char* name, void** out, const char* fmt, ...) {
  PyGILState_STATE gil = EnsurePython();
  va_list ap;
  va_start(ap, fmt);
  PyObject* args = Py_VaBuildValue(fmt, ap);
  va_end(ap);
  PyObject* r = CallImpl(name, args);
  int rc = -1;
  if (r != nullptr) {
    if (r == Py_None) {
      Py_DECREF(r);
      *out = nullptr;
    } else {
      *out = r;
    }
    rc = 0;
  }
  PyGILState_Release(gil);
  return rc;
}

int CallStrV(const char* name, const char** out, const char* fmt, ...) {
  PyGILState_STATE gil = EnsurePython();
  va_list ap;
  va_start(ap, fmt);
  PyObject* args = Py_VaBuildValue(fmt, ap);
  va_end(ap);
  PyObject* r = CallImpl(name, args);
  int rc = -1;
  if (r != nullptr) {
    const char* c = PyUnicode_AsUTF8(r);
    g_ret_str = c ? c : "";
    *out = g_ret_str.c_str();
    Py_DECREF(r);
    rc = 0;
  }
  PyGILState_Release(gil);
  return rc;
}

int StrSuccessPairV(const char* fn, const char** out, int* success,
                    const char* fmt, ...) {
  PyGILState_STATE gil = EnsurePython();
  va_list ap;
  va_start(ap, fmt);
  PyObject* args = Py_VaBuildValue(fmt, ap);
  va_end(ap);
  PyObject* r = CallImpl(fn, args);
  int rc = -1;
  if (r != nullptr) {
    const char* c = PyUnicode_AsUTF8(PyTuple_GetItem(r, 0));
    g_ret_str2 = c ? c : "";
    *out = g_ret_str2.c_str();
    *success = PyObject_IsTrue(PyTuple_GetItem(r, 1));
    Py_DECREF(r);
    rc = 0;
  }
  PyGILState_Release(gil);
  return rc;
}

PyObject* IntList(const int* arr, mx_uint n) {
  PyObject* lst = PyList_New(n);
  for (mx_uint i = 0; i < n; ++i)
    PyList_SetItem(lst, i, PyLong_FromLong(arr ? arr[i] : 0));
  return lst;
}

PyObject* UIntList(const mx_uint* arr, mx_uint n) {
  PyObject* lst = PyList_New(n);
  for (mx_uint i = 0; i < n; ++i)
    PyList_SetItem(lst, i, PyLong_FromUnsignedLong(arr ? arr[i] : 0));
  return lst;
}

// shape groups packed as (names, list-of-shape-lists) from ind_ptr layout
PyObject* ShapeLists(mx_uint num_args, const mx_uint* ind_ptr,
                     const mx_uint* shape_data) {
  PyObject* shapes = PyList_New(num_args);
  for (mx_uint i = 0; i < num_args; ++i) {
    mx_uint lo = ind_ptr[i], hi = ind_ptr[i + 1];
    PyObject* s = PyList_New(hi - lo);
    for (mx_uint j = lo; j < hi; ++j)
      PyList_SetItem(s, j - lo, PyLong_FromUnsignedLong(shape_data[j]));
    PyList_SetItem(shapes, i, s);
  }
  return shapes;
}

// unpack (name, description, names[], types[], descs[]) info tuples —
// shared by MXSymbolGetAtomicSymbolInfo and MXDataIterGetIterInfo; the
// two string scalars land in g_ret_str/g_ret_str2, the three lists in
// g_info_store with per-group pointer arrays in g_info_ptrs
void UnpackInfoGroups(PyObject* r, const char** name,
                      const char** description, mx_uint* num_args,
                      const char*** arg_names, const char*** arg_type_infos,
                      const char*** arg_descriptions) {
  g_info_store.clear();
  const char* c0 = PyUnicode_AsUTF8(PyTuple_GetItem(r, 0));
  const char* c1 = PyUnicode_AsUTF8(PyTuple_GetItem(r, 1));
  g_ret_str = c0 ? c0 : "";
  g_ret_str2 = c1 ? c1 : "";
  size_t counts[3];
  for (int grp = 0; grp < 3; ++grp) {
    PyObject* lst = PyTuple_GetItem(r, 2 + grp);
    Py_ssize_t cnt = PyList_Size(lst);
    counts[grp] = static_cast<size_t>(cnt);
    for (Py_ssize_t i = 0; i < cnt; ++i) {
      const char* c = PyUnicode_AsUTF8(PyList_GetItem(lst, i));
      g_info_store.emplace_back(c ? c : "");
    }
  }
  size_t off = 0;
  for (int grp = 0; grp < 3; ++grp) {
    g_info_ptrs[grp].clear();
    for (size_t i = 0; i < counts[grp]; ++i)
      g_info_ptrs[grp].push_back(g_info_store[off + i].c_str());
    off += counts[grp];
  }
  *name = g_ret_str.c_str();
  *description = g_ret_str2.c_str();
  *num_args = static_cast<mx_uint>(counts[0]);
  *arg_names = g_info_ptrs[0].data();
  *arg_type_infos = g_info_ptrs[1].data();
  *arg_descriptions = g_info_ptrs[2].data();
}

// unpack the 3-group shape tuple exactly like MXSymbolInferShape does
int UnpackShapeGroups(PyObject* r, mx_uint* in_shape_size,
                      const mx_uint** in_shape_ndim,
                      const mx_uint*** in_shape_data, mx_uint* out_shape_size,
                      const mx_uint** out_shape_ndim,
                      const mx_uint*** out_shape_data, mx_uint* aux_shape_size,
                      const mx_uint** aux_shape_ndim,
                      const mx_uint*** aux_shape_data, int* complete) {
  g_shape_store.clear();
  g_shape_ptrs.clear();
  g_ndim_buf.clear();
  mx_uint sizes[3];
  size_t offsets[4] = {0, 0, 0, 0};
  for (int grp = 0; grp < 3; ++grp) {
    PyObject* lst = PyTuple_GetItem(r, grp);
    Py_ssize_t n = PyList_Size(lst);
    sizes[grp] = static_cast<mx_uint>(n);
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* s = PyList_GetItem(lst, i);
      Py_ssize_t nd = PyList_Size(s);
      std::vector<mx_uint> v(nd);
      for (Py_ssize_t j = 0; j < nd; ++j)
        v[j] = static_cast<mx_uint>(PyLong_AsLong(PyList_GetItem(s, j)));
      g_shape_store.push_back(std::move(v));
      g_ndim_buf.push_back(static_cast<mx_uint>(nd));
    }
    offsets[grp + 1] = g_shape_store.size();
  }
  for (auto& v : g_shape_store) g_shape_ptrs.push_back(v.data());
  *in_shape_size = sizes[0];
  *in_shape_ndim = g_ndim_buf.data() + offsets[0];
  *in_shape_data = g_shape_ptrs.data() + offsets[0];
  *out_shape_size = sizes[1];
  *out_shape_ndim = g_ndim_buf.data() + offsets[1];
  *out_shape_data = g_shape_ptrs.data() + offsets[1];
  *aux_shape_size = sizes[2];
  *aux_shape_ndim = g_ndim_buf.data() + offsets[2];
  *aux_shape_data = g_shape_ptrs.data() + offsets[2];
  *complete = PyObject_IsTrue(PyTuple_GetItem(r, 3));
  return 0;
}

}  // namespace

extern "C" {

// ---- runtime knobs --------------------------------------------------------

int MXGetVersion(int* out) { return CallIntV("version", out, "()"); }

int MXRandomSeed(int seed) {
  return CallVoidV("random_seed", "(i)", seed);
}

int MXNotifyShutdown() {
  return CallVoidV("notify_shutdown", "()");
}

int MXSetNumOMPThreads(int thread_num) {
  return CallVoidV("set_num_omp_threads", "(i)", thread_num);
}

int MXEngineSetBulkSize(int bulk_size, int* prev_bulk_size) {
  return CallIntV("engine_set_bulk_size", prev_bulk_size, "(i)", bulk_size);
}

int MXSetProfilerConfig(int mode, const char* filename) {
  return CallVoidV("profiler_set_config", "(is)", mode, filename);
}

int MXSetProfilerState(int state) {
  return CallVoidV("profiler_set_state", "(i)", state);
}

int MXDumpProfile() { return CallVoidV("profiler_dump", "()"); }

// ---- NDArray extras -------------------------------------------------------

int MXNDArrayCreateNone(NDArrayHandle* out) {
  return CallHandleV("ndarray_create_none", out, "()");
}

int MXNDArraySlice(NDArrayHandle handle, mx_uint begin, mx_uint end,
                   NDArrayHandle* out) {
  return CallHandleV("ndarray_slice", out, "(OII)",
                     static_cast<PyObject*>(handle), begin, end);
}

int MXNDArrayAt(NDArrayHandle handle, mx_uint idx, NDArrayHandle* out) {
  return CallHandleV("ndarray_at", out, "(OI)",
                     static_cast<PyObject*>(handle), idx);
}

int MXNDArrayReshape(NDArrayHandle handle, int ndim, int* dims,
                     NDArrayHandle* out) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* d = IntList(dims, ndim);
  PyObject* a = Py_BuildValue("(OO)", static_cast<PyObject*>(handle), d);
  Py_DECREF(d);
  PyGILState_Release(gil);
  return CallHandle("ndarray_reshape", a, out);
}

int MXNDArrayGetContext(NDArrayHandle handle, int* out_dev_type,
                        int* out_dev_id) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = CallImpl("ndarray_get_context",
                         Py_BuildValue("(O)",
                                       static_cast<PyObject*>(handle)));
  int rc = -1;
  if (r != nullptr) {
    *out_dev_type = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 0)));
    *out_dev_id = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 1)));
    Py_DECREF(r);
    rc = 0;
  }
  PyGILState_Release(gil);
  return rc;
}

int MXNDArrayGetStorageType(NDArrayHandle handle, int* out_storage_type) {
  return CallIntV("ndarray_storage_type", out_storage_type, "(O)",
                  static_cast<PyObject*>(handle));
}

int MXNDArrayGetGrad(NDArrayHandle handle, NDArrayHandle* out) {
  return CallHandleV("ndarray_get_grad", out, "(O)",
                     static_cast<PyObject*>(handle));
}

int MXNDArrayDetach(NDArrayHandle handle, NDArrayHandle* out) {
  return CallHandleV("ndarray_detach", out, "(O)",
                     static_cast<PyObject*>(handle));
}

int MXNDArraySetGradState(NDArrayHandle handle, int state) {
  return CallVoidV("ndarray_set_grad_state", "(Oi)",
                   static_cast<PyObject*>(handle), state);
}

int MXNDArrayGetGradState(NDArrayHandle handle, int* out) {
  return CallIntV("ndarray_get_grad_state", out, "(O)",
                  static_cast<PyObject*>(handle));
}

int MXNDArraySyncCopyFromNDArray(NDArrayHandle dst, const NDArrayHandle src,
                                 const int i) {
  return CallVoidV("ndarray_sync_copy_from_ndarray", "(OOi)",
                   static_cast<PyObject*>(dst),
                   static_cast<PyObject*>(src), i);
}

int MXNDArraySaveRawBytes(NDArrayHandle handle, size_t* out_size,
                          const char** out_buf) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = CallImpl("ndarray_save_raw_bytes",
                         Py_BuildValue("(O)",
                                       static_cast<PyObject*>(handle)));
  int rc = -1;
  if (r != nullptr) {
    char* buf = nullptr;
    Py_ssize_t n = 0;
    if (PyBytes_AsStringAndSize(r, &buf, &n) == 0) {
      g_rec_buf.assign(buf, n);
      *out_size = static_cast<size_t>(n);
      *out_buf = g_rec_buf.data();
      rc = 0;
    } else {
      CaptureError();
    }
    Py_DECREF(r);
  }
  PyGILState_Release(gil);
  return rc;
}

int MXNDArrayLoadFromRawBytes(const void* buf, size_t size,
                              NDArrayHandle* out) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* b = PyBytes_FromStringAndSize(static_cast<const char*>(buf),
                                          static_cast<Py_ssize_t>(size));
  PyObject* a = Py_BuildValue("(O)", b);
  Py_DECREF(b);
  PyGILState_Release(gil);
  return CallHandle("ndarray_load_from_raw_bytes", a, out);
}

// ---- symbol surface -------------------------------------------------------

int MXSymbolCreateVariable(const char* name, SymbolHandle* out) {
  return CallHandleV("symbol_create_variable", out, "(s)", name);
}

int MXSymbolCreateGroup(mx_uint num_symbols, SymbolHandle* symbols,
                        SymbolHandle* out) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* lst = HandleList(symbols, num_symbols);
  PyObject* a = Py_BuildValue("(O)", lst);
  Py_DECREF(lst);
  PyGILState_Release(gil);
  return CallHandle("symbol_create_group", a, out);
}

int MXSymbolSaveToFile(SymbolHandle symbol, const char* fname) {
  return CallVoidV("symbol_save_to_file", "(Os)",
                   static_cast<PyObject*>(symbol), fname);
}

int MXSymbolSaveToJSON(SymbolHandle symbol, const char** out_json) {
  return CallStrV("symbol_to_json", out_json, "(O)",
                  static_cast<PyObject*>(symbol));
}

int MXSymbolCopy(SymbolHandle symbol, SymbolHandle* out) {
  return CallHandleV("symbol_copy", out, "(O)",
                     static_cast<PyObject*>(symbol));
}

int MXSymbolPrint(SymbolHandle symbol, const char** out_str) {
  return CallStrV("symbol_print", out_str, "(O)",
                  static_cast<PyObject*>(symbol));
}


int MXSymbolGetName(SymbolHandle symbol, const char** out, int* success) {
  return StrSuccessPairV("symbol_get_name", out, success, "(O)",
                         static_cast<PyObject*>(symbol));
}

int MXSymbolGetAttr(SymbolHandle symbol, const char* key, const char** out,
                    int* success) {
  return StrSuccessPairV("symbol_get_attr", out, success, "(Os)",
                         static_cast<PyObject*>(symbol), key);
}

int MXSymbolSetAttr(SymbolHandle symbol, const char* key, const char* value) {
  return CallVoidV("symbol_set_attr", "(Oss)",
                   static_cast<PyObject*>(symbol), key, value);
}

static int SymAttrList(const char* fn, SymbolHandle symbol, mx_uint* out_size,
                       const char*** out) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = CallImpl(fn, Py_BuildValue("(O)",
                                           static_cast<PyObject*>(symbol)));
  if (r == nullptr) {
    PyGILState_Release(gil);
    return -1;
  }
  mx_uint n = 0;
  ReturnStrList(r, &n, out);
  *out_size = n / 2;  // reference counts PAIRS here
  Py_DECREF(r);
  PyGILState_Release(gil);
  return 0;
}

int MXSymbolListAttr(SymbolHandle symbol, mx_uint* out_size,
                     const char*** out) {
  return SymAttrList("symbol_list_attr", symbol, out_size, out);
}

int MXSymbolListAttrShallow(SymbolHandle symbol, mx_uint* out_size,
                            const char*** out) {
  return SymAttrList("symbol_list_attr_shallow", symbol, out_size, out);
}

int MXSymbolGetInternals(SymbolHandle symbol, SymbolHandle* out) {
  return CallHandleV("symbol_get_internals", out, "(O)",
                     static_cast<PyObject*>(symbol));
}

int MXSymbolGetChildren(SymbolHandle symbol, SymbolHandle* out) {
  return CallHandleV("symbol_get_children", out, "(O)",
                     static_cast<PyObject*>(symbol));
}

int MXSymbolGetOutput(SymbolHandle symbol, mx_uint index, SymbolHandle* out) {
  return CallHandleV("symbol_get_output", out, "(OI)",
                     static_cast<PyObject*>(symbol), index);
}

int MXSymbolCompose(SymbolHandle sym, const char* name, mx_uint num_args,
                    const char** keys, SymbolHandle* args) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* ks = keys != nullptr ? StrList(keys, num_args) : PyList_New(0);
  PyObject* as = HandleList(args, num_args);
  PyObject* a = Py_BuildValue("(OsOO)", static_cast<PyObject*>(sym),
                              name != nullptr ? name : "", ks, as);
  Py_DECREF(ks);
  Py_DECREF(as);
  PyGILState_Release(gil);
  return CallVoid("symbol_compose", a);
}

int MXSymbolCreateAtomicSymbol(AtomicSymbolCreator creator, mx_uint num_param,
                               const char** keys, const char** vals,
                               SymbolHandle* out) {
  PyGILState_STATE gil = EnsurePython();
  std::string* name = static_cast<std::string*>(creator);
  PyObject* ks = StrList(keys, num_param);
  PyObject* vs = StrList(vals, num_param);
  PyObject* a = Py_BuildValue("(sOO)", name->c_str(), ks, vs);
  Py_DECREF(ks);
  Py_DECREF(vs);
  PyGILState_Release(gil);
  return CallHandle("symbol_create_atomic", a, out);
}

int MXSymbolListAtomicSymbolCreators(mx_uint* out_size,
                                     AtomicSymbolCreator** out_array) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = CallImpl("op_names", PyTuple_New(0));
  if (r == nullptr) {
    PyGILState_Release(gil);
    return -1;
  }
  Py_ssize_t n = PyList_Size(r);
  // dedicated static storage: callers cache this array across later API
  // calls (the reference returns a stable registry vector), so it must
  // not share a buffer with any other return path
  static std::vector<void*> creators;
  creators.clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    const char* c = PyUnicode_AsUTF8(PyList_GetItem(r, i));
    creators.push_back(new std::string(c ? c : ""));  // leaked handles
  }
  Py_DECREF(r);
  *out_size = static_cast<mx_uint>(n);
  *out_array = creators.data();
  PyGILState_Release(gil);
  return 0;
}

int MXSymbolGetAtomicSymbolName(AtomicSymbolCreator creator,
                                const char** name) {
  *name = static_cast<std::string*>(creator)->c_str();
  return 0;
}

int MXSymbolGetAtomicSymbolInfo(AtomicSymbolCreator creator,
                                const char** name, const char** description,
                                mx_uint* num_args, const char*** arg_names,
                                const char*** arg_type_infos,
                                const char*** arg_descriptions,
                                const char** key_var_num_args,
                                const char** return_type) {
  PyGILState_STATE gil = EnsurePython();
  std::string* op = static_cast<std::string*>(creator);
  PyObject* r = CallImpl("op_info", Py_BuildValue("(s)", op->c_str()));
  if (r == nullptr) {
    PyGILState_Release(gil);
    return -1;
  }
  const char* c5 = PyUnicode_AsUTF8(PyTuple_GetItem(r, 5));
  g_rec_buf = c5 ? c5 : "";
  UnpackInfoGroups(r, name, description, num_args, arg_names,
                   arg_type_infos, arg_descriptions);
  Py_DECREF(r);
  *key_var_num_args = g_rec_buf.c_str();
  if (return_type != nullptr) *return_type = "";
  PyGILState_Release(gil);
  return 0;
}

int MXSymbolInferShapePartial(
    SymbolHandle sym, mx_uint num_args, const char** keys,
    const mx_uint* arg_ind_ptr, const mx_uint* arg_shape_data,
    mx_uint* in_shape_size, const mx_uint** in_shape_ndim,
    const mx_uint*** in_shape_data, mx_uint* out_shape_size,
    const mx_uint** out_shape_ndim, const mx_uint*** out_shape_data,
    mx_uint* aux_shape_size, const mx_uint** aux_shape_ndim,
    const mx_uint*** aux_shape_data, int* complete) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* names = StrList(keys, num_args);
  PyObject* shapes = ShapeLists(num_args, arg_ind_ptr, arg_shape_data);
  PyObject* a = Py_BuildValue("(OOO)", static_cast<PyObject*>(sym), names,
                              shapes);
  Py_DECREF(names);
  Py_DECREF(shapes);
  PyObject* r = CallImpl("symbol_infer_shape_partial", a);
  if (r == nullptr) {
    PyGILState_Release(gil);
    return -1;
  }
  UnpackShapeGroups(r, in_shape_size, in_shape_ndim, in_shape_data,
                    out_shape_size, out_shape_ndim, out_shape_data,
                    aux_shape_size, aux_shape_ndim, aux_shape_data, complete);
  Py_DECREF(r);
  PyGILState_Release(gil);
  return 0;
}

int MXSymbolInferType(SymbolHandle sym, mx_uint num_args, const char** keys,
                      const int* arg_type_data, mx_uint* in_type_size,
                      const int** in_type_data, mx_uint* out_type_size,
                      const int** out_type_data, mx_uint* aux_type_size,
                      const int** aux_type_data, int* complete) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* names = StrList(keys, num_args);
  PyObject* codes = IntList(arg_type_data, num_args);
  PyObject* a = Py_BuildValue("(OOO)", static_cast<PyObject*>(sym), names,
                              codes);
  Py_DECREF(names);
  Py_DECREF(codes);
  PyObject* r = CallImpl("symbol_infer_type", a);
  if (r == nullptr) {
    PyGILState_Release(gil);
    return -1;
  }
  g_int_buf.clear();
  mx_uint sizes[3];
  size_t offsets[4] = {0, 0, 0, 0};
  for (int grp = 0; grp < 3; ++grp) {
    PyObject* lst = PyTuple_GetItem(r, grp);
    Py_ssize_t n = PyList_Size(lst);
    sizes[grp] = static_cast<mx_uint>(n);
    for (Py_ssize_t i = 0; i < n; ++i)
      g_int_buf.push_back(
          static_cast<int>(PyLong_AsLong(PyList_GetItem(lst, i))));
    offsets[grp + 1] = g_int_buf.size();
  }
  *in_type_size = sizes[0];
  *in_type_data = g_int_buf.data() + offsets[0];
  *out_type_size = sizes[1];
  *out_type_data = g_int_buf.data() + offsets[1];
  *aux_type_size = sizes[2];
  *aux_type_data = g_int_buf.data() + offsets[2];
  *complete = PyObject_IsTrue(PyTuple_GetItem(r, 3));
  Py_DECREF(r);
  PyGILState_Release(gil);
  return 0;
}

// ---- executor extras ------------------------------------------------------

int MXExecutorPrint(ExecutorHandle handle, const char** out_str) {
  return CallStrV("executor_print", out_str, "(O)",
                  static_cast<PyObject*>(handle));
}

int MXExecutorBackwardEx(ExecutorHandle handle, mx_uint len,
                         NDArrayHandle* head_grads, int is_train) {
  (void)is_train;  // our backward derives mode from the recorded program
  return MXExecutorBackward(handle, len, head_grads);
}

int MXExecutorSimpleBind(
    SymbolHandle symbol_handle, int dev_type, int dev_id,
    const mx_uint num_g2c_keys, const char** g2c_keys,
    const int* g2c_dev_types, const int* g2c_dev_ids,
    const mx_uint provided_grad_req_list_len,
    const char** provided_grad_req_names,
    const char** provided_grad_req_types,
    const mx_uint num_provided_arg_shapes,
    const char** provided_arg_shape_names,
    const mx_uint* provided_arg_shape_data,
    const mx_uint* provided_arg_shape_idx,
    const mx_uint num_provided_arg_dtypes,
    const char** provided_arg_dtype_names, const int* provided_arg_dtypes,
    const mx_uint num_provided_arg_stypes,
    const char** provided_arg_stype_names, const int* provided_arg_stypes,
    const mx_uint num_shared_arg_names, const char** shared_arg_name_list,
    int* shared_buffer_len, const char** shared_buffer_name_list,
    NDArrayHandle* shared_buffer_handle_list,
    const char*** updated_shared_buffer_name_list,
    NDArrayHandle** updated_shared_buffer_handle_list, mx_uint* num_in_args,
    NDArrayHandle** in_args, NDArrayHandle** arg_grads,
    mx_uint* num_aux_states, NDArrayHandle** aux_states,
    ExecutorHandle shared_exec_handle, ExecutorHandle* out) {
  // shared buffer / shared exec are allocator-reuse hints in the
  // reference (c_api_executor.cc); PyTorch's caching allocator owns
  // allocation here, so they are accepted and passed through unchanged.
  (void)num_shared_arg_names;
  (void)shared_arg_name_list;
  (void)shared_exec_handle;
  PyGILState_STATE gil = EnsurePython();
  PyObject* g2ck = StrList(g2c_keys, num_g2c_keys);
  PyObject* g2ct = IntList(g2c_dev_types, num_g2c_keys);
  PyObject* g2ci = IntList(g2c_dev_ids, num_g2c_keys);
  PyObject* reqn = StrList(provided_grad_req_names,
                           provided_grad_req_names != nullptr
                               ? provided_grad_req_list_len : 0);
  // reference convention: a GLOBAL grad_req arrives as list_len==0 with
  // a single-element types array (python/mxnet/symbol.py simple_bind)
  mx_uint n_req_types = provided_grad_req_list_len;
  if (provided_grad_req_names == nullptr && provided_grad_req_list_len == 0
      && provided_grad_req_types != nullptr)
    n_req_types = 1;
  PyObject* reqt = StrList(provided_grad_req_types, n_req_types);
  PyObject* shn = StrList(provided_arg_shape_names, num_provided_arg_shapes);
  PyObject* shs = ShapeLists(num_provided_arg_shapes, provided_arg_shape_idx,
                             provided_arg_shape_data);
  PyObject* dtn = StrList(provided_arg_dtype_names, num_provided_arg_dtypes);
  PyObject* dtc = IntList(provided_arg_dtypes, num_provided_arg_dtypes);
  PyObject* stn = StrList(provided_arg_stype_names, num_provided_arg_stypes);
  PyObject* stc = IntList(provided_arg_stypes, num_provided_arg_stypes);
  PyObject* a = Py_BuildValue(
      "(OiiOOOOOOOOOOO)", static_cast<PyObject*>(symbol_handle), dev_type,
      dev_id, g2ck, g2ct, g2ci, reqn, reqt, shn, shs, dtn, dtc, stn, stc);
  Py_DECREF(g2ck); Py_DECREF(g2ct); Py_DECREF(g2ci);
  Py_DECREF(reqn); Py_DECREF(reqt); Py_DECREF(shn); Py_DECREF(shs);
  Py_DECREF(dtn); Py_DECREF(dtc); Py_DECREF(stn); Py_DECREF(stc);
  PyObject* r = CallImpl("executor_simple_bind", a);
  if (r == nullptr) {
    PyGILState_Release(gil);
    return -1;
  }
  PyObject* ex = PyTuple_GetItem(r, 0);
  Py_INCREF(ex);
  *out = ex;
  mx_uint n_in = 0, n_aux = 0;
  // in_args and arg_grads must live in SEPARATE buffers (two pointers
  // handed out simultaneously); ReturnHandleList uses one — inline here
  {
    PyObject* ins = PyTuple_GetItem(r, 1);
    PyObject* grads = PyTuple_GetItem(r, 2);
    Py_ssize_t n = PyList_Size(ins);
    g_handle_buf.clear();
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* o = PyList_GetItem(ins, i);
      Py_INCREF(o);
      g_handle_buf.push_back(o);
    }
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* o = PyList_GetItem(grads, i);
      if (o == Py_None) {
        g_handle_buf.push_back(nullptr);
      } else {
        Py_INCREF(o);
        g_handle_buf.push_back(o);
      }
    }
    n_in = static_cast<mx_uint>(n);
    *in_args = g_handle_buf.data();
    *arg_grads = g_handle_buf.data() + n;
  }
  {
    PyObject* aux = PyTuple_GetItem(r, 3);
    Py_ssize_t n = PyList_Size(aux);
    g_handle_buf2.clear();
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* o = PyList_GetItem(aux, i);
      Py_INCREF(o);
      g_handle_buf2.push_back(o);
    }
    n_aux = static_cast<mx_uint>(n);
    *aux_states = g_handle_buf2.data();
  }
  *num_in_args = n_in;
  *num_aux_states = n_aux;
  if (updated_shared_buffer_name_list != nullptr)
    *updated_shared_buffer_name_list = shared_buffer_name_list;
  if (updated_shared_buffer_handle_list != nullptr)
    *updated_shared_buffer_handle_list = shared_buffer_handle_list;
  if (shared_buffer_len != nullptr && *shared_buffer_len < 0)
    *shared_buffer_len = 0;
  Py_DECREF(r);
  PyGILState_Release(gil);
  return 0;
}

// ---- CachedOp -------------------------------------------------------------

int MXCreateCachedOp(SymbolHandle handle, CachedOpHandle* out) {
  return CallHandleV("cached_op_create", out, "(O)",
                     static_cast<PyObject*>(handle));
}

int MXFreeCachedOp(CachedOpHandle handle) {
  PyGILState_STATE gil = EnsurePython();
  Py_XDECREF(static_cast<PyObject*>(handle));
  PyGILState_Release(gil);
  return 0;
}

int MXInvokeCachedOp(CachedOpHandle handle, int num_inputs,
                     NDArrayHandle* inputs, int* num_outputs,
                     NDArrayHandle** outputs) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* ins = HandleList(inputs, num_inputs);
  PyObject* a = Py_BuildValue("(OO)", static_cast<PyObject*>(handle), ins);
  Py_DECREF(ins);
  PyObject* r = CallImpl("cached_op_invoke", a);
  if (r == nullptr) {
    PyGILState_Release(gil);
    return -1;
  }
  mx_uint n = 0;
  ReturnHandleList(r, &n, outputs);
  *num_outputs = static_cast<int>(n);
  Py_DECREF(r);
  PyGILState_Release(gil);
  return 0;
}

// ---- autograd -------------------------------------------------------------

int MXAutogradSetIsRecording(int is_recording, int* prev) {
  return CallIntV("autograd_set_recording", prev, "(i)", is_recording);
}

int MXAutogradSetIsTraining(int is_training, int* prev) {
  return CallIntV("autograd_set_training", prev, "(i)", is_training);
}

int MXAutogradIsRecording(bool* curr) {
  int v = 0;
  int rc = CallIntV("autograd_is_recording", &v, "()");
  *curr = v != 0;
  return rc;
}

int MXAutogradIsTraining(bool* curr) {
  int v = 0;
  int rc = CallIntV("autograd_is_training", &v, "()");
  *curr = v != 0;
  return rc;
}

int MXAutogradMarkVariables(mx_uint num_var, NDArrayHandle* var_handles,
                            mx_uint* reqs_array,
                            NDArrayHandle* grad_handles) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* vars = HandleList(var_handles, num_var);
  PyObject* reqs = UIntList(reqs_array, num_var);
  PyObject* grads = HandleList(grad_handles, num_var);
  PyObject* a = Py_BuildValue("(OOO)", vars, reqs, grads);
  Py_DECREF(vars);
  Py_DECREF(reqs);
  Py_DECREF(grads);
  PyGILState_Release(gil);
  return CallVoid("autograd_mark_variables", a);
}

int MXAutogradBackward(mx_uint num_output, NDArrayHandle* output_handles,
                       NDArrayHandle* ograd_handles, int retain_graph) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* outs = HandleList(output_handles, num_output);
  PyObject* ogs = ograd_handles != nullptr
                      ? HandleList(ograd_handles, num_output) : PyList_New(0);
  PyObject* a = Py_BuildValue("(OOii)", outs, ogs, retain_graph, 1);
  Py_DECREF(outs);
  Py_DECREF(ogs);
  PyGILState_Release(gil);
  return CallVoid("autograd_backward", a);
}

int MXAutogradComputeGradient(mx_uint num_output,
                              NDArrayHandle* output_handles) {
  return MXAutogradBackward(num_output, output_handles, nullptr, 0);
}

int MXAutogradBackwardEx(mx_uint num_output, NDArrayHandle* output_handles,
                         NDArrayHandle* ograd_handles, mx_uint num_variables,
                         NDArrayHandle* var_handles, int retain_graph,
                         int create_graph, int is_train,
                         NDArrayHandle** grad_handles, int** grad_stypes) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* outs = HandleList(output_handles, num_output);
  PyObject* ogs = ograd_handles != nullptr
                      ? HandleList(ograd_handles, num_output) : PyList_New(0);
  PyObject* vars = HandleList(var_handles, num_variables);
  PyObject* a = Py_BuildValue("(OOOiii)", outs, ogs, vars, retain_graph,
                              create_graph, is_train);
  Py_DECREF(outs);
  Py_DECREF(ogs);
  Py_DECREF(vars);
  PyObject* r = CallImpl("autograd_backward_ex", a);
  if (r == nullptr) {
    PyGILState_Release(gil);
    return -1;
  }
  if (num_variables > 0 && grad_handles != nullptr) {
    mx_uint n = 0;
    ReturnHandleList(PyTuple_GetItem(r, 0), &n, grad_handles);
    PyObject* st = PyTuple_GetItem(r, 1);
    g_int_buf.clear();
    for (Py_ssize_t i = 0; i < PyList_Size(st); ++i)
      g_int_buf.push_back(
          static_cast<int>(PyLong_AsLong(PyList_GetItem(st, i))));
    if (grad_stypes != nullptr) *grad_stypes = g_int_buf.data();
  }
  Py_DECREF(r);
  PyGILState_Release(gil);
  return 0;
}

int MXAutogradGetSymbol(NDArrayHandle handle, SymbolHandle* out) {
  return CallHandleV("autograd_get_symbol", out, "(O)",
                     static_cast<PyObject*>(handle));
}

// ---- data iterators -------------------------------------------------------

int MXListDataIters(mx_uint* out_size, DataIterCreator** out_array) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = CallImpl("list_data_iters", PyTuple_New(0));
  if (r == nullptr) {
    PyGILState_Release(gil);
    return -1;
  }
  static std::vector<void*> creators;  // leaked name handles, like ops
  creators.clear();
  for (Py_ssize_t i = 0; i < PyList_Size(r); ++i) {
    const char* c = PyUnicode_AsUTF8(PyList_GetItem(r, i));
    creators.push_back(new std::string(c ? c : ""));
  }
  Py_DECREF(r);
  *out_size = static_cast<mx_uint>(creators.size());
  *out_array = creators.data();
  PyGILState_Release(gil);
  return 0;
}

int MXDataIterGetIterInfo(DataIterCreator creator, const char** name,
                          const char** description, mx_uint* num_args,
                          const char*** arg_names,
                          const char*** arg_type_infos,
                          const char*** arg_descriptions) {
  PyGILState_STATE gil = EnsurePython();
  std::string* n = static_cast<std::string*>(creator);
  PyObject* r = CallImpl("data_iter_info", Py_BuildValue("(s)", n->c_str()));
  if (r == nullptr) {
    PyGILState_Release(gil);
    return -1;
  }
  UnpackInfoGroups(r, name, description, num_args, arg_names,
                   arg_type_infos, arg_descriptions);
  Py_DECREF(r);
  PyGILState_Release(gil);
  return 0;
}

int MXDataIterCreateIter(DataIterCreator handle, mx_uint num_param,
                         const char** keys, const char** vals,
                         DataIterHandle* out) {
  PyGILState_STATE gil = EnsurePython();
  std::string* n = static_cast<std::string*>(handle);
  PyObject* ks = StrList(keys, num_param);
  PyObject* vs = StrList(vals, num_param);
  PyObject* a = Py_BuildValue("(sOO)", n->c_str(), ks, vs);
  Py_DECREF(ks);
  Py_DECREF(vs);
  PyGILState_Release(gil);
  return CallHandle("data_iter_create", a, out);
}

int MXDataIterFree(DataIterHandle handle) {
  PyGILState_STATE gil = EnsurePython();
  Py_XDECREF(static_cast<PyObject*>(handle));
  PyGILState_Release(gil);
  return 0;
}

int MXDataIterNext(DataIterHandle handle, int* out) {
  return CallIntV("data_iter_next", out, "(O)",
                  static_cast<PyObject*>(handle));
}

int MXDataIterBeforeFirst(DataIterHandle handle) {
  return CallVoidV("data_iter_before_first", "(O)",
                   static_cast<PyObject*>(handle));
}

int MXDataIterGetData(DataIterHandle handle, NDArrayHandle* out) {
  return CallHandleV("data_iter_get_data", out, "(O)",
                     static_cast<PyObject*>(handle));
}

int MXDataIterGetLabel(DataIterHandle handle, NDArrayHandle* out) {
  return CallHandleV("data_iter_get_label", out, "(O)",
                     static_cast<PyObject*>(handle));
}

int MXDataIterGetPadNum(DataIterHandle handle, int* pad) {
  return CallIntV("data_iter_get_pad", pad, "(O)",
                  static_cast<PyObject*>(handle));
}

int MXDataIterGetIndex(DataIterHandle handle, uint64_t** out_index,
                       uint64_t* out_size) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = CallImpl("data_iter_get_index",
                         Py_BuildValue("(O)",
                                       static_cast<PyObject*>(handle)));
  if (r == nullptr) {
    PyGILState_Release(gil);
    return -1;
  }
  g_u64_buf.clear();
  for (Py_ssize_t i = 0; i < PyList_Size(r); ++i)
    g_u64_buf.push_back(static_cast<uint64_t>(
        PyLong_AsUnsignedLongLong(PyList_GetItem(r, i))));
  Py_DECREF(r);
  *out_index = g_u64_buf.data();
  *out_size = static_cast<uint64_t>(g_u64_buf.size());
  PyGILState_Release(gil);
  return 0;
}

// ---- kvstore --------------------------------------------------------------

int MXInitPSEnv(mx_uint num_vars, const char** keys, const char** vals) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* ks = StrList(keys, num_vars);
  PyObject* vs = StrList(vals, num_vars);
  PyObject* a = Py_BuildValue("(OO)", ks, vs);
  Py_DECREF(ks);
  Py_DECREF(vs);
  PyGILState_Release(gil);
  return CallVoid("init_ps_env", a);
}

int MXKVStoreCreate(const char* type, KVStoreHandle* out) {
  return CallHandleV("kvstore_create", out, "(s)", type);
}

int MXKVStoreFree(KVStoreHandle handle) {
  PyGILState_STATE gil = EnsurePython();
  Py_XDECREF(static_cast<PyObject*>(handle));
  PyGILState_Release(gil);
  return 0;
}

static PyObject* KVKeys(const int* keys, mx_uint num) {
  return IntList(keys, num);
}

static PyObject* KVKeysEx(const char** keys, mx_uint num) {
  return StrList(keys, num);
}

int MXKVStoreInit(KVStoreHandle handle, mx_uint num, const int* keys,
                  NDArrayHandle* vals) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* ks = KVKeys(keys, num);
  PyObject* vs = HandleList(vals, num);
  PyObject* a = Py_BuildValue("(OOO)", static_cast<PyObject*>(handle), ks,
                              vs);
  Py_DECREF(ks);
  Py_DECREF(vs);
  PyGILState_Release(gil);
  return CallVoid("kvstore_init", a);
}

int MXKVStoreInitEx(KVStoreHandle handle, mx_uint num, const char** keys,
                    NDArrayHandle* vals) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* ks = KVKeysEx(keys, num);
  PyObject* vs = HandleList(vals, num);
  PyObject* a = Py_BuildValue("(OOO)", static_cast<PyObject*>(handle), ks,
                              vs);
  Py_DECREF(ks);
  Py_DECREF(vs);
  PyGILState_Release(gil);
  return CallVoid("kvstore_init", a);
}

static int KVPush(KVStoreHandle handle, PyObject* ks, mx_uint num,
                  NDArrayHandle* vals, int priority) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* vs = HandleList(vals, num);
  PyObject* a = Py_BuildValue("(OOOi)", static_cast<PyObject*>(handle), ks,
                              vs, priority);
  Py_DECREF(ks);
  Py_DECREF(vs);
  PyGILState_Release(gil);
  return CallVoid("kvstore_push", a);
}

int MXKVStorePush(KVStoreHandle handle, mx_uint num, const int* keys,
                  NDArrayHandle* vals, int priority) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* ks = KVKeys(keys, num);
  PyGILState_Release(gil);
  return KVPush(handle, ks, num, vals, priority);
}

int MXKVStorePushEx(KVStoreHandle handle, mx_uint num, const char** keys,
                    NDArrayHandle* vals, int priority) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* ks = KVKeysEx(keys, num);
  PyGILState_Release(gil);
  return KVPush(handle, ks, num, vals, priority);
}

static int KVPull(KVStoreHandle handle, PyObject* ks, mx_uint num,
                  NDArrayHandle* vals, int priority) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* vs = HandleList(vals, num);
  PyObject* a = Py_BuildValue("(OOOi)", static_cast<PyObject*>(handle), ks,
                              vs, priority);
  Py_DECREF(ks);
  Py_DECREF(vs);
  PyGILState_Release(gil);
  return CallVoid("kvstore_pull", a);
}

int MXKVStorePull(KVStoreHandle handle, mx_uint num, const int* keys,
                  NDArrayHandle* vals, int priority) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* ks = KVKeys(keys, num);
  PyGILState_Release(gil);
  return KVPull(handle, ks, num, vals, priority);
}

int MXKVStorePullEx(KVStoreHandle handle, mx_uint num, const char** keys,
                    NDArrayHandle* vals, int priority) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* ks = KVKeysEx(keys, num);
  PyGILState_Release(gil);
  return KVPull(handle, ks, num, vals, priority);
}

static int KVPullRsp(KVStoreHandle handle, PyObject* ks, mx_uint num,
                     NDArrayHandle* vals, const NDArrayHandle* row_ids,
                     int priority) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* vs = HandleList(vals, num);
  PyObject* rs = HandleList(const_cast<NDArrayHandle*>(row_ids), num);
  PyObject* a = Py_BuildValue("(OOOOi)", static_cast<PyObject*>(handle), ks,
                              vs, rs, priority);
  Py_DECREF(ks);
  Py_DECREF(vs);
  Py_DECREF(rs);
  PyGILState_Release(gil);
  return CallVoid("kvstore_pull_row_sparse", a);
}

int MXKVStorePullRowSparse(KVStoreHandle handle, mx_uint num, const int* keys,
                           NDArrayHandle* vals, const NDArrayHandle* row_ids,
                           int priority) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* ks = KVKeys(keys, num);
  PyGILState_Release(gil);
  return KVPullRsp(handle, ks, num, vals, row_ids, priority);
}

int MXKVStorePullRowSparseEx(KVStoreHandle handle, mx_uint num,
                             const char** keys, NDArrayHandle* vals,
                             const NDArrayHandle* row_ids, int priority) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* ks = KVKeysEx(keys, num);
  PyGILState_Release(gil);
  return KVPullRsp(handle, ks, num, vals, row_ids, priority);
}

int MXKVStoreSetGradientCompression(KVStoreHandle handle, mx_uint num_params,
                                    const char** keys, const char** vals) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* ks = StrList(keys, num_params);
  PyObject* vs = StrList(vals, num_params);
  PyObject* a = Py_BuildValue("(OOO)", static_cast<PyObject*>(handle), ks,
                              vs);
  Py_DECREF(ks);
  Py_DECREF(vs);
  PyGILState_Release(gil);
  return CallVoid("kvstore_set_gradient_compression", a);
}

int MXKVStoreSetUpdater(KVStoreHandle handle, MXKVStoreUpdater updater,
                        void* updater_handle) {
  return CallVoidV(
      "kvstore_set_updater", "(OLL)", static_cast<PyObject*>(handle),
      static_cast<long long>(reinterpret_cast<intptr_t>(updater)),
      static_cast<long long>(reinterpret_cast<intptr_t>(updater_handle)));
}

int MXKVStoreSetUpdaterEx(KVStoreHandle handle, MXKVStoreUpdater updater,
                          MXKVStoreStrUpdater str_updater,
                          void* updater_handle) {
  return CallVoidV(
      "kvstore_set_updater", "(OLLL)", static_cast<PyObject*>(handle),
      static_cast<long long>(reinterpret_cast<intptr_t>(updater)),
      static_cast<long long>(reinterpret_cast<intptr_t>(updater_handle)),
      static_cast<long long>(reinterpret_cast<intptr_t>(str_updater)));
}

int MXKVStoreGetType(KVStoreHandle handle, const char** type) {
  return CallStrV("kvstore_get_type", type, "(O)",
                  static_cast<PyObject*>(handle));
}

int MXKVStoreGetRank(KVStoreHandle handle, int* ret) {
  return CallIntV("kvstore_get_rank", ret, "(O)",
                  static_cast<PyObject*>(handle));
}

int MXKVStoreGetGroupSize(KVStoreHandle handle, int* ret) {
  return CallIntV("kvstore_get_group_size", ret, "(O)",
                  static_cast<PyObject*>(handle));
}

// role queries: the SPMD runtime has workers only (kvstore_server.py is
// the documented role-absorber); env overrides keep launcher parity
int MXKVStoreIsWorkerNode(int* ret) {
  const char* role = getenv("DMLC_ROLE");
  *ret = (role == nullptr || std::string(role) == "worker") ? 1 : 0;
  return 0;
}

int MXKVStoreIsServerNode(int* ret) {
  const char* role = getenv("DMLC_ROLE");
  *ret = (role != nullptr && std::string(role) == "server") ? 1 : 0;
  return 0;
}

int MXKVStoreIsSchedulerNode(int* ret) {
  const char* role = getenv("DMLC_ROLE");
  *ret = (role != nullptr && std::string(role) == "scheduler") ? 1 : 0;
  return 0;
}

int MXKVStoreBarrier(KVStoreHandle handle) {
  return CallVoidV("kvstore_barrier", "(O)",
                   static_cast<PyObject*>(handle));
}

int MXKVStoreSetBarrierBeforeExit(KVStoreHandle handle,
                                  const int barrier_before_exit) {
  (void)handle;
  (void)barrier_before_exit;  // process teardown is torch.distributed's
  return 0;
}

int MXKVStoreRunServer(KVStoreHandle handle,
                       MXKVStoreServerController controller,
                       void* controller_handle) {
  return CallVoidV(
      "kvstore_run_server", "(OLL)", static_cast<PyObject*>(handle),
      static_cast<long long>(reinterpret_cast<intptr_t>(controller)),
      static_cast<long long>(
          reinterpret_cast<intptr_t>(controller_handle)));
}

int MXKVStoreSendCommmandToServers(KVStoreHandle handle, int cmd_id,
                                   const char* cmd_body) {
  return CallVoidV("kvstore_send_command", "(Ois)",
                   static_cast<PyObject*>(handle), cmd_id, cmd_body);
}

int MXKVStoreGetNumDeadNode(KVStoreHandle handle, const int node_id,
                            int* number, const int timeout_sec) {
  return CallIntV("kvstore_num_dead_node", number, "(Oii)",
                  static_cast<PyObject*>(handle), node_id, timeout_sec);
}

// ---- recordio -------------------------------------------------------------

int MXRecordIOWriterCreate(const char* uri, RecordIOHandle* out) {
  return CallHandleV("recordio_writer_create", out, "(s)", uri);
}

int MXRecordIOReaderCreate(const char* uri, RecordIOHandle* out) {
  return CallHandleV("recordio_reader_create", out, "(s)", uri);
}

static int RecordIOFree(RecordIOHandle handle) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* a = Py_BuildValue("(O)", static_cast<PyObject*>(handle));
  PyObject* r = CallImpl("recordio_close", a);
  Py_XDECREF(r);
  Py_XDECREF(static_cast<PyObject*>(handle));
  PyGILState_Release(gil);
  return r != nullptr ? 0 : -1;
}

int MXRecordIOWriterFree(RecordIOHandle handle) {
  return RecordIOFree(handle);
}

int MXRecordIOReaderFree(RecordIOHandle handle) {
  return RecordIOFree(handle);
}

int MXRecordIOWriterWriteRecord(RecordIOHandle handle, const char* buf,
                                size_t size) {
  return CallVoidV(
      "recordio_write_record", "(OLn)", static_cast<PyObject*>(handle),
      static_cast<long long>(reinterpret_cast<intptr_t>(buf)),
      static_cast<Py_ssize_t>(size));
}

int MXRecordIOWriterTell(RecordIOHandle handle, size_t* pos) {
  // full 64-bit position: .rec files routinely exceed 2 GB
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = CallImpl("recordio_tell",
                         Py_BuildValue("(O)",
                                       static_cast<PyObject*>(handle)));
  int rc = -1;
  if (r != nullptr) {
    *pos = static_cast<size_t>(PyLong_AsUnsignedLongLong(r));
    Py_DECREF(r);
    rc = 0;
  }
  PyGILState_Release(gil);
  return rc;
}

int MXRecordIOReaderTell(RecordIOHandle handle, size_t* pos) {
  return MXRecordIOWriterTell(handle, pos);
}

int MXRecordIOReaderSeek(RecordIOHandle handle, size_t pos) {
  return CallVoidV("recordio_seek", "(On)",
                   static_cast<PyObject*>(handle),
                   static_cast<Py_ssize_t>(pos));
}

int MXRecordIOReaderReadRecord(RecordIOHandle handle, char const** buf,
                               size_t* size) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = CallImpl("recordio_read_record",
                         Py_BuildValue("(O)",
                                       static_cast<PyObject*>(handle)));
  int rc = -1;
  if (r != nullptr) {
    if (r == Py_None) {  // EOF
      *buf = nullptr;
      *size = 0;
      rc = 0;
    } else {
      char* data = nullptr;
      Py_ssize_t n = 0;
      if (PyBytes_AsStringAndSize(r, &data, &n) == 0) {
        g_rec_buf.assign(data, n);
        *buf = g_rec_buf.data();
        *size = static_cast<size_t>(n);
        rc = 0;
      } else {
        CaptureError();
      }
    }
    Py_DECREF(r);
  }
  PyGILState_Release(gil);
  return rc;
}


// ---- sparse NDArray -------------------------------------------------------

int MXNDArrayCreateSparseEx(int storage_type, const mx_uint* shape,
                            mx_uint ndim, int dev_type, int dev_id,
                            int delay_alloc, int dtype, mx_uint num_aux,
                            int* aux_type, mx_uint* aux_ndims,
                            const mx_uint* aux_shape, NDArrayHandle* out) {
  (void)delay_alloc;
  (void)aux_ndims;
  (void)aux_shape;
  PyGILState_STATE gil = EnsurePython();
  PyObject* shp = UIntList(shape, ndim);
  PyObject* at = IntList(aux_type, num_aux);
  PyObject* a = Py_BuildValue("(iOiiiO)", storage_type, shp, dev_type,
                              dev_id, dtype, at);
  Py_DECREF(shp);
  Py_DECREF(at);
  PyGILState_Release(gil);
  return CallHandle("ndarray_create_sparse", a, out);
}

int MXNDArrayGetAuxType(NDArrayHandle handle, mx_uint i, int* out_type) {
  return CallIntV("ndarray_get_aux_type", out_type, "(OI)",
                  static_cast<PyObject*>(handle), i);
}

int MXNDArrayGetAuxNDArray(NDArrayHandle handle, mx_uint i,
                           NDArrayHandle* out) {
  return CallHandleV("ndarray_get_aux_ndarray", out, "(OI)",
                     static_cast<PyObject*>(handle), i);
}

int MXNDArrayGetDataNDArray(NDArrayHandle handle, NDArrayHandle* out) {
  return CallHandleV("ndarray_get_data_ndarray", out, "(O)",
                     static_cast<PyObject*>(handle));
}

int MXNDArraySyncCheckFormat(NDArrayHandle handle, const bool full_check) {
  return CallVoidV("ndarray_sync_check_format", "(Oi)",
                   static_cast<PyObject*>(handle), full_check ? 1 : 0);
}

// The live data pointer (parity: MXNDArrayGetData): the wrapped tensor's
// data_ptr(), a device pointer for an array on the card, as the
// reference's; valid while the handle holds the array and nothing
// rebinds its storage.
int MXNDArrayGetData(NDArrayHandle handle, void** out_pdata) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = CallImpl("ndarray_get_data_ptr",
                         Py_BuildValue("(O)",
                                       static_cast<PyObject*>(handle)));
  int rc = -1;
  if (r != nullptr) {
    *out_pdata = reinterpret_cast<void*>(
        static_cast<intptr_t>(PyLong_AsLongLong(r)));
    Py_DECREF(r);
    rc = 0;
  }
  PyGILState_Release(gil);
  return rc;
}

// ---- legacy function API --------------------------------------------------

typedef void* FunctionHandle;

int MXListFunctions(mx_uint* out_size, FunctionHandle** out_array) {
  // functions ARE the ops under the legacy convention
  return MXSymbolListAtomicSymbolCreators(
      out_size, reinterpret_cast<AtomicSymbolCreator**>(out_array));
}

int MXGetFunction(const char* name, FunctionHandle* out) {
  return NNGetOpHandle(name,
                       reinterpret_cast<AtomicSymbolCreator*>(out));
}

int MXFuncGetInfo(FunctionHandle fun, const char** name,
                  const char** description, mx_uint* num_args,
                  const char*** arg_names, const char*** arg_type_infos,
                  const char*** arg_descriptions,
                  const char** return_type) {
  PyGILState_STATE gil = EnsurePython();
  std::string* op = static_cast<std::string*>(fun);
  PyObject* r = CallImpl("func_info", Py_BuildValue("(s)", op->c_str()));
  if (r == nullptr) {
    PyGILState_Release(gil);
    return -1;
  }
  UnpackInfoGroups(r, name, description, num_args, arg_names,
                   arg_type_infos, arg_descriptions);
  Py_DECREF(r);
  if (return_type != nullptr) *return_type = "";
  PyGILState_Release(gil);
  return 0;
}

int MXFuncDescribe(FunctionHandle fun, mx_uint* num_use_vars,
                   mx_uint* num_scalars, mx_uint* num_mutate_vars,
                   int* type_mask) {
  PyGILState_STATE gil = EnsurePython();
  std::string* op = static_cast<std::string*>(fun);
  PyObject* r = CallImpl("func_describe",
                         Py_BuildValue("(s)", op->c_str()));
  int rc = -1;
  if (r != nullptr) {
    *num_use_vars =
        static_cast<mx_uint>(PyLong_AsLong(PyTuple_GetItem(r, 0)));
    *num_scalars =
        static_cast<mx_uint>(PyLong_AsLong(PyTuple_GetItem(r, 1)));
    *num_mutate_vars =
        static_cast<mx_uint>(PyLong_AsLong(PyTuple_GetItem(r, 2)));
    *type_mask = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 3)));
    Py_DECREF(r);
    rc = 0;
  }
  PyGILState_Release(gil);
  return rc;
}

static int FuncInvokeImpl(FunctionHandle fun, NDArrayHandle* use_vars,
                          float* scalar_args, NDArrayHandle* mutate_vars,
                          int num_params, char** param_keys,
                          char** param_vals);

int MXFuncInvokeEx(FunctionHandle fun, NDArrayHandle* use_vars,
                   float* scalar_args, NDArrayHandle* mutate_vars,
                   int num_params, char** param_keys, char** param_vals) {
  return FuncInvokeImpl(fun, use_vars, scalar_args, mutate_vars,
                        num_params, param_keys, param_vals);
}

int MXFuncInvoke(FunctionHandle fun, NDArrayHandle* use_vars,
                 float* scalar_args, NDArrayHandle* mutate_vars) {
  return FuncInvokeImpl(fun, use_vars, scalar_args, mutate_vars, 0,
                        nullptr, nullptr);
}

static int FuncInvokeImpl(FunctionHandle fun, NDArrayHandle* use_vars,
                          float* scalar_args, NDArrayHandle* mutate_vars,
                          int num_params, char** param_keys,
                          char** param_vals) {
  PyGILState_STATE gil = EnsurePython();
  std::string* op = static_cast<std::string*>(fun);
  // arity comes from func_describe
  PyObject* d = CallImpl("func_describe",
                         Py_BuildValue("(s)", op->c_str()));
  if (d == nullptr) {
    PyGILState_Release(gil);
    return -1;
  }
  long n_use = PyLong_AsLong(PyTuple_GetItem(d, 0));
  long n_scalar = PyLong_AsLong(PyTuple_GetItem(d, 1));
  long n_mut = PyLong_AsLong(PyTuple_GetItem(d, 2));
  Py_DECREF(d);
  PyObject* uses = HandleList(use_vars, static_cast<mx_uint>(n_use));
  PyObject* scalars = PyList_New(n_scalar);
  for (long i = 0; i < n_scalar; ++i)
    PyList_SetItem(scalars, i,
                   PyFloat_FromDouble(scalar_args ? scalar_args[i] : 0.0));
  PyObject* muts = HandleList(mutate_vars, static_cast<mx_uint>(n_mut));
  PyObject* ek = StrList(const_cast<const char**>(param_keys),
                         param_keys != nullptr ? num_params : 0);
  PyObject* ev = StrList(const_cast<const char**>(param_vals),
                         param_vals != nullptr ? num_params : 0);
  PyObject* a = Py_BuildValue("(sOOOOO)", op->c_str(), uses, scalars, muts,
                              ek, ev);
  Py_DECREF(uses);
  Py_DECREF(scalars);
  Py_DECREF(muts);
  Py_DECREF(ek);
  Py_DECREF(ev);
  PyObject* r = CallImpl("func_invoke", a);
  int rc = r != nullptr ? 0 : -1;
  Py_XDECREF(r);
  PyGILState_Release(gil);
  return rc;
}

// ---- executor bind with device map ---------------------------------------

static int ExecutorBindMapped(SymbolHandle sym, int dev_type, int dev_id,
                              mx_uint num_map_keys, const char** map_keys,
                              const int* map_dev_types,
                              const int* map_dev_ids, mx_uint len,
                              NDArrayHandle* in_args,
                              NDArrayHandle* arg_grad_store,
                              mx_uint* grad_req_type, mx_uint aux_states_len,
                              NDArrayHandle* aux_states,
                              ExecutorHandle* out) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* mk = StrList(map_keys, num_map_keys);
  PyObject* mt = IntList(map_dev_types, num_map_keys);
  PyObject* mi = IntList(map_dev_ids, num_map_keys);
  PyObject* args = HandleList(in_args, len);
  PyObject* grads = HandleList(arg_grad_store, len);
  PyObject* reqs = UIntList(grad_req_type, len);
  PyObject* aux = HandleList(aux_states, aux_states_len);
  PyObject* a = Py_BuildValue("(OiiOOOOOOO)", static_cast<PyObject*>(sym),
                              dev_type, dev_id, mk, mt, mi, args, grads,
                              reqs, aux);
  Py_DECREF(mk); Py_DECREF(mt); Py_DECREF(mi);
  Py_DECREF(args); Py_DECREF(grads); Py_DECREF(reqs); Py_DECREF(aux);
  PyGILState_Release(gil);
  return CallHandle("executor_bind_x", a, out);
}

int MXExecutorBindX(SymbolHandle symbol_handle, int dev_type, int dev_id,
                    mx_uint num_map_keys, const char** map_keys,
                    const int* map_dev_types, const int* map_dev_ids,
                    mx_uint len, NDArrayHandle* in_args,
                    NDArrayHandle* arg_grad_store, mx_uint* grad_req_type,
                    mx_uint aux_states_len, NDArrayHandle* aux_states,
                    ExecutorHandle* out) {
  return ExecutorBindMapped(symbol_handle, dev_type, dev_id, num_map_keys,
                            map_keys, map_dev_types, map_dev_ids, len,
                            in_args, arg_grad_store, grad_req_type,
                            aux_states_len, aux_states, out);
}

int MXExecutorBindEX(SymbolHandle symbol_handle, int dev_type, int dev_id,
                     mx_uint num_map_keys, const char** map_keys,
                     const int* map_dev_types, const int* map_dev_ids,
                     mx_uint len, NDArrayHandle* in_args,
                     NDArrayHandle* arg_grad_store, mx_uint* grad_req_type,
                     mx_uint aux_states_len, NDArrayHandle* aux_states,
                     ExecutorHandle shared_exec, ExecutorHandle* out) {
  (void)shared_exec;  // allocator-reuse hint; PyTorch owns allocation
  return ExecutorBindMapped(symbol_handle, dev_type, dev_id, num_map_keys,
                            map_keys, map_dev_types, map_dev_ids, len,
                            in_args, arg_grad_store, grad_req_type,
                            aux_states_len, aux_states, out);
}

typedef void (*ExecutorMonitorCallback)(const char*, NDArrayHandle, void*);

int MXExecutorSetMonitorCallback(ExecutorHandle handle,
                                 ExecutorMonitorCallback callback,
                                 void* callback_handle) {
  return CallVoidV(
      "executor_set_monitor_callback", "(OLLi)",
      static_cast<PyObject*>(handle),
      static_cast<long long>(reinterpret_cast<intptr_t>(callback)),
      static_cast<long long>(reinterpret_cast<intptr_t>(callback_handle)),
      0);
}

// ---- Ex invoke variants ---------------------------------------------------

int MXImperativeInvokeEx(AtomicSymbolCreator creator, int num_inputs,
                         NDArrayHandle* inputs, int* num_outputs,
                         NDArrayHandle** outputs, int num_params,
                         const char** param_keys, const char** param_vals,
                         const int** out_stypes) {
  int rc = MXImperativeInvoke(creator, num_inputs, inputs, num_outputs,
                              outputs, num_params, param_keys, param_vals);
  if (rc != 0) return rc;
  PyGILState_STATE gil = EnsurePython();
  g_int_buf.clear();
  for (int i = 0; i < *num_outputs; ++i) {
    PyObject* r = CallImpl(
        "ndarray_storage_type",
        Py_BuildValue("(O)", static_cast<PyObject*>((*outputs)[i])));
    g_int_buf.push_back(r != nullptr
                            ? static_cast<int>(PyLong_AsLong(r)) : 0);
    Py_XDECREF(r);
  }
  if (out_stypes != nullptr) *out_stypes = g_int_buf.data();
  PyGILState_Release(gil);
  return 0;
}

int MXInvokeCachedOpEx(CachedOpHandle handle, int num_inputs,
                       NDArrayHandle* inputs, int* num_outputs,
                       NDArrayHandle** outputs, const int** out_stypes) {
  int rc = MXInvokeCachedOp(handle, num_inputs, inputs, num_outputs,
                            outputs);
  if (rc != 0) return rc;
  PyGILState_STATE gil = EnsurePython();
  g_int_buf.clear();
  for (int i = 0; i < *num_outputs; ++i) {
    PyObject* r = CallImpl(
        "ndarray_storage_type",
        Py_BuildValue("(O)", static_cast<PyObject*>((*outputs)[i])));
    g_int_buf.push_back(r != nullptr
                            ? static_cast<int>(PyLong_AsLong(r)) : 0);
    Py_XDECREF(r);
  }
  if (out_stypes != nullptr) *out_stypes = g_int_buf.data();
  PyGILState_Release(gil);
  return 0;
}

// ---- RTC: CUDA C compiled at run time by NVRTC (mxnet_tpu_torch/rtc.py),
// launched on the card with the grid, block and shared memory given ----

typedef void* RtcHandle;
typedef void* CudaModuleHandle;
typedef void* CudaKernelHandle;

int MXRtcCreate(char* name, mx_uint num_input, mx_uint num_output,
                char** input_names, char** output_names,
                NDArrayHandle* inputs, NDArrayHandle* outputs,
                char* kernel, RtcHandle* out) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* in_names = StrList(const_cast<const char**>(input_names),
                               num_input);
  PyObject* out_names = StrList(const_cast<const char**>(output_names),
                                num_output);
  PyObject* ins = HandleList(inputs, num_input);
  PyObject* outs = HandleList(outputs, num_output);
  PyObject* a = Py_BuildValue("(sOOOOs)", name, in_names, out_names, ins,
                              outs, kernel);
  Py_DECREF(in_names);
  Py_DECREF(out_names);
  Py_DECREF(ins);
  Py_DECREF(outs);
  PyGILState_Release(gil);
  return CallHandle("rtc_create", a, out);
}

int MXRtcPush(RtcHandle handle, mx_uint num_input, mx_uint num_output,
              NDArrayHandle* inputs, NDArrayHandle* outputs,
              mx_uint gridDimX, mx_uint gridDimY, mx_uint gridDimZ,
              mx_uint blockDimX, mx_uint blockDimY, mx_uint blockDimZ) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* ins = HandleList(inputs, num_input);
  PyObject* outs = HandleList(outputs, num_output);
  PyObject* a = Py_BuildValue("(OOOIIIIII)", static_cast<PyObject*>(handle),
                              ins, outs, gridDimX, gridDimY, gridDimZ,
                              blockDimX, blockDimY, blockDimZ);
  Py_DECREF(ins);
  Py_DECREF(outs);
  PyGILState_Release(gil);
  return CallVoid("rtc_push", a);
}

int MXRtcFree(RtcHandle handle) {
  PyGILState_STATE gil = EnsurePython();
  Py_XDECREF(static_cast<PyObject*>(handle));
  PyGILState_Release(gil);
  return 0;
}

int MXRtcCudaModuleCreate(const char* source, int num_options,
                          const char** options, int num_exports,
                          const char** exports, CudaModuleHandle* out) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* opts = StrList(options, num_options);
  PyObject* exps = StrList(exports, num_exports);
  PyObject* a = Py_BuildValue("(sOO)", source, opts, exps);
  Py_DECREF(opts);
  Py_DECREF(exps);
  PyGILState_Release(gil);
  return CallHandle("rtc_module_create", a, out);
}

int MXRtcCudaModuleFree(CudaModuleHandle handle) {
  PyGILState_STATE gil = EnsurePython();
  Py_XDECREF(static_cast<PyObject*>(handle));
  PyGILState_Release(gil);
  return 0;
}

int MXRtcCudaKernelCreate(CudaModuleHandle handle, const char* name,
                          int num_args, int* is_ndarray, int* is_const,
                          int* arg_types, CudaKernelHandle* out) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* nds = IntList(is_ndarray, num_args);
  PyObject* consts = IntList(is_const, num_args);
  PyObject* types = IntList(arg_types, num_args);
  PyObject* a = Py_BuildValue("(OsOOO)", static_cast<PyObject*>(handle),
                              name, nds, consts, types);
  Py_DECREF(nds);
  Py_DECREF(consts);
  Py_DECREF(types);
  PyGILState_Release(gil);
  return CallHandle("rtc_kernel_create", a, out);
}

int MXRtcCudaKernelFree(CudaKernelHandle handle) {
  PyGILState_STATE gil = EnsurePython();
  Py_XDECREF(static_cast<PyObject*>(handle));
  PyGILState_Release(gil);
  return 0;
}

int MXRtcCudaKernelCall(CudaKernelHandle handle, int dev_id, void** args,
                        mx_uint grid_dim_x, mx_uint grid_dim_y,
                        mx_uint grid_dim_z, mx_uint block_dim_x,
                        mx_uint block_dim_y, mx_uint block_dim_z,
                        mx_uint shared_mem) {
  PyGILState_STATE gil = EnsurePython();
  // the tuple handle is (kernel, is_ndarray, dtype_codes); its second
  // element tells how many args the call takes
  PyObject* tup = static_cast<PyObject*>(handle);
  Py_ssize_t n_args = PyList_Size(PyTuple_GetItem(tup, 1));
  PyObject* addrs = PyList_New(n_args);
  for (Py_ssize_t i = 0; i < n_args; ++i)
    PyList_SetItem(addrs, i,
                   PyLong_FromLongLong(static_cast<long long>(
                       reinterpret_cast<intptr_t>(args[i]))));
  PyObject* a = Py_BuildValue("(OiOIIIIIII)", tup, dev_id, addrs,
                              grid_dim_x, grid_dim_y, grid_dim_z,
                              block_dim_x, block_dim_y, block_dim_z,
                              shared_mem);
  Py_DECREF(addrs);
  PyGILState_Release(gil);
  return CallVoid("rtc_kernel_call", a);
}

// ---- custom ops (documented divergence) -----------------------------------

// The reference's C callback protocol (MXCallbackList with per-op
// forward/backward/infer function pointers) exists to run custom code
// inside its C++ engine. Here custom operators are a PYTHON surface
// (mxnet_tpu_torch.operator CustomOp/CustomOpProp) running under the same
// executor as every other op; the C entry points report that clearly
// instead of half-implementing an engine that does not exist.
int MXCustomOpRegister(const char* op_type, void* creator) {
  (void)creator;
  mxtpu_last_error =
      std::string("MXCustomOpRegister: C-callback custom ops are not "
                  "supported by the PyTorch port; register op '") +
      (op_type ? op_type : "?") +
      "' through the Python CustomOp API "
      "(mxnet_tpu_torch.operator.register) "
      "— see PARITY.md 'known deliberate divergences'";
  return -1;
}

int MXCustomFunctionRecord(int num_inputs, NDArrayHandle* inputs,
                           int num_outputs, NDArrayHandle* outputs,
                           void* callbacks) {
  (void)num_inputs; (void)inputs; (void)num_outputs; (void)outputs;
  (void)callbacks;
  mxtpu_last_error =
      "MXCustomFunctionRecord: C-callback autograd functions are not "
      "supported by the PyTorch port; use autograd.Function in Python "
      "(mxnet_tpu_torch.autograd) — see PARITY.md";
  return -1;
}

// ---- shared-memory transport ----------------------------------------------

int MXNDArrayGetSharedMemHandle(NDArrayHandle handle, int* shared_pid,
                                int* shared_id) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* r = CallImpl("ndarray_get_shared_mem_handle",
                         Py_BuildValue("(O)",
                                       static_cast<PyObject*>(handle)));
  int rc = -1;
  if (r != nullptr) {
    *shared_pid = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 0)));
    *shared_id = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 1)));
    Py_DECREF(r);
    rc = 0;
  }
  PyGILState_Release(gil);
  return rc;
}

int MXNDArrayCreateFromSharedMem(int shared_pid, int shared_id,
                                 const mx_uint* shape, mx_uint ndim,
                                 int dtype, NDArrayHandle* out) {
  PyGILState_STATE gil = EnsurePython();
  PyObject* shp = UIntList(shape, ndim);
  PyObject* a = Py_BuildValue("(iiOi)", shared_pid, shared_id, shp, dtype);
  Py_DECREF(shp);
  PyGILState_Release(gil);
  return CallHandle("ndarray_create_from_shared_mem", a, out);
}


int MXSymbolGrad(SymbolHandle sym, mx_uint num_wrt, const char** wrt,
                 SymbolHandle* out) {
  (void)sym; (void)num_wrt; (void)wrt; (void)out;
  // the reference's own implementation is LOG(FATAL) << "not
  // implemented" (c_api_symbolic.cc:564-568); same contract here
  mxtpu_last_error = "MXSymbolGrad: not implemented (the reference "
                     "raises the same; use executor backward or "
                     "MXAutogradBackward)";
  return -1;
}

}  // extern "C"
