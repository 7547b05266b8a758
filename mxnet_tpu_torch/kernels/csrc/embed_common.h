// Shared CPython-embedding machinery of the port's C ABI (c_api.cc,
// c_predict_api.cc; a copy of src/embed_common.h). The three sources
// build into one library, kernels/_build/libmxnet.so, as the reference
// ships one libmxnet.so: one definition of the error buffer and of
// MXGetLastError, read by both halves of the ABI.
//
// The library does not link libpython. Loaded into a Python process
// (ctypes) its Py* symbols resolve against that interpreter; a
// standalone C program links libpython itself (kernels/_build.py,
// driver_link_flags), and the first call starts the interpreter.
#ifndef MXTPU_EMBED_COMMON_H_
#define MXTPU_EMBED_COMMON_H_

#include <Python.h>

#include <string>

// thread-local last error; written by CaptureError, read by MXGetLastError
extern thread_local std::string mxtpu_last_error;

// Bring the interpreter up (thread-safe, at-most-once) and take the GIL.
PyGILState_STATE MXTPUEnsurePython();

// Capture the pending Python exception into mxtpu_last_error.
void MXTPUCaptureError();

extern "C" const char* MXGetLastError();

#endif  // MXTPU_EMBED_COMMON_H_
