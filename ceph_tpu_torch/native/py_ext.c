/* _ec_native: CPython C-API binding to the native EC kernels.
 *
 * Reference role: src/pybind -- the reference ships real C-extension
 * bindings (Cython -> C API) over its native libraries rather than
 * ffi-style wrappers.  This module binds the hot native entry points
 * (crc32c, GF(2^8) region multiply-accumulate, region XOR) through
 * PyMethodDef/PyArg_Parse, releasing the GIL around the kernels.
 * Built by ceph_tpu_torch/native/build.py (py_ext) against gf_kernels.cpp.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* native kernels (gf_kernels.cpp, extern "C"); the build compiles
 * this file with g++, so the declarations need the C linkage guard */
#ifdef __cplusplus
extern "C" {
#endif
extern uint32_t ec_crc32c(uint32_t crc, const uint8_t *data, size_t n);
extern void ec_gf8_mul_region(uint8_t c, const uint8_t *in, uint8_t *out,
                              size_t n, int accum);
extern void ec_region_xor(const uint8_t *const *srcs, int k, uint8_t *out,
                          size_t n);
extern int ec_arch_probe(void);
#ifdef __cplusplus
}
#endif

static PyObject *py_crc32c(PyObject *self, PyObject *args) {
  Py_buffer buf;
  unsigned int seed = 0xFFFFFFFFu;
  if (!PyArg_ParseTuple(args, "y*|I", &buf, &seed)) return NULL;
  uint32_t out;
  Py_BEGIN_ALLOW_THREADS
  out = ec_crc32c(seed, (const uint8_t *)buf.buf, (size_t)buf.len);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&buf);
  return PyLong_FromUnsignedLong(out);
}

static PyObject *py_gf8_mul_region(PyObject *self, PyObject *args) {
  unsigned char c;
  Py_buffer in;
  PyObject *accum_obj = Py_None;
  if (!PyArg_ParseTuple(args, "by*|O", &c, &in, &accum_obj)) return NULL;
  PyObject *out_bytes = PyBytes_FromStringAndSize(NULL, in.len);
  if (out_bytes == NULL) {
    PyBuffer_Release(&in);
    return NULL;
  }
  uint8_t *out = (uint8_t *)PyBytes_AS_STRING(out_bytes);
  int accum = 0;
  if (accum_obj != Py_None) {
    Py_buffer acc;
    if (PyObject_GetBuffer(accum_obj, &acc, PyBUF_SIMPLE) < 0) {
      /* acc is NOT initialized on failure: do not touch it */
      Py_DECREF(out_bytes);
      PyBuffer_Release(&in);
      return NULL; /* propagate the TypeError from GetBuffer */
    }
    if (acc.len != in.len) {
      PyBuffer_Release(&acc);
      Py_DECREF(out_bytes);
      PyBuffer_Release(&in);
      PyErr_SetString(PyExc_ValueError, "accum length mismatch");
      return NULL;
    }
    memcpy(out, acc.buf, (size_t)in.len);
    PyBuffer_Release(&acc);
    accum = 1;
  }
  Py_BEGIN_ALLOW_THREADS
  ec_gf8_mul_region(c, (const uint8_t *)in.buf, out, (size_t)in.len, accum);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&in);
  return out_bytes;
}

static PyObject *py_region_xor(PyObject *self, PyObject *args) {
  PyObject *seq;
  if (!PyArg_ParseTuple(args, "O", &seq)) return NULL;
  PyObject *fast = PySequence_Fast(seq, "expected a sequence of buffers");
  if (fast == NULL) return NULL;
  Py_ssize_t k = PySequence_Fast_GET_SIZE(fast);
  if (k < 1) {
    Py_DECREF(fast);
    PyErr_SetString(PyExc_ValueError, "need at least one source");
    return NULL;
  }
  Py_buffer *bufs = (Py_buffer *)PyMem_Malloc(sizeof(Py_buffer) * k);
  const uint8_t **ptrs =
      (const uint8_t **)PyMem_Malloc(sizeof(uint8_t *) * k);
  if (bufs == NULL || ptrs == NULL) {
    PyMem_Free(bufs);
    PyMem_Free(ptrs);
    Py_DECREF(fast);
    return PyErr_NoMemory();
  }
  PyObject *out_bytes = NULL;
  Py_ssize_t n = -1, got = 0;
  for (Py_ssize_t i = 0; i < k; ++i, ++got) {
    if (PyObject_GetBuffer(PySequence_Fast_GET_ITEM(fast, i), &bufs[i],
                           PyBUF_SIMPLE) < 0)
      goto fail;
    if (n < 0) n = bufs[i].len;
    if (bufs[i].len != n) {
      got++;
      PyErr_SetString(PyExc_ValueError, "source length mismatch");
      goto fail;
    }
    ptrs[i] = (const uint8_t *)bufs[i].buf;
  }
  out_bytes = PyBytes_FromStringAndSize(NULL, n);
  if (out_bytes == NULL) goto fail;
  Py_BEGIN_ALLOW_THREADS
  ec_region_xor(ptrs, (int)k, (uint8_t *)PyBytes_AS_STRING(out_bytes),
                (size_t)n);
  Py_END_ALLOW_THREADS
  for (Py_ssize_t i = 0; i < k; ++i) PyBuffer_Release(&bufs[i]);
  PyMem_Free(bufs);
  PyMem_Free(ptrs);
  Py_DECREF(fast);
  return out_bytes;
fail:
  for (Py_ssize_t i = 0; i < got; ++i) PyBuffer_Release(&bufs[i]);
  PyMem_Free(bufs);
  PyMem_Free(ptrs);
  Py_XDECREF(out_bytes);
  Py_DECREF(fast);
  return NULL;
}

static PyObject *py_arch_probe(PyObject *self, PyObject *args) {
  return PyLong_FromLong(ec_arch_probe());
}

static PyMethodDef Methods[] = {
    {"crc32c", py_crc32c, METH_VARARGS,
     "crc32c(data, seed=0xFFFFFFFF) -> int"},
    {"gf8_mul_region", py_gf8_mul_region, METH_VARARGS,
     "gf8_mul_region(c, data, accum=None) -> bytes (out (^)= c*data)"},
    {"region_xor", py_region_xor, METH_VARARGS,
     "region_xor([buf, ...]) -> bytes"},
    {"arch_probe", py_arch_probe, METH_NOARGS,
     "arch_probe() -> ISA feature bitmask"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_ec_native",
    "C-API bindings to the native EC kernels", -1, Methods,
};

PyMODINIT_FUNC PyInit__ec_native(void) {
  return PyModule_Create(&moduledef);
}
