// Copy of src/embed_common.cc for the port's C library (see
// embed_common.h).
#include "embed_common.h"

#include <mutex>

thread_local std::string mxtpu_last_error;

PyGILState_STATE MXTPUEnsurePython() {
  // check-then-init must be synchronized: two threads making their first
  // API call concurrently would otherwise both run Py_InitializeEx
  // (undefined behaviour). call_once serialises exactly the init.
  static std::once_flag once;
  std::call_once(once, []() {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      // Py_InitializeEx leaves the GIL held by this thread; release it
      // so PyGILState_Ensure below behaves uniformly.
      PyEval_SaveThread();
    }
  });
  return PyGILState_Ensure();
}

void MXTPUCaptureError() {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  PyErr_NormalizeException(&type, &value, &trace);
  mxtpu_last_error = "unknown python error";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) mxtpu_last_error = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
}

extern "C" const char* MXGetLastError() { return mxtpu_last_error.c_str(); }
