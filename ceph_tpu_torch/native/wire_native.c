/* _wire_native: CPython C-API batched wire codec of ceph_tpu_torch.
 *
 * A copy of the JAX package's ceph_tpu/native/wire_native.c: the same
 * functions and the same bytes.  The typed body encode/decode, the
 * envelope parse, the frame seal and the burst scan of the TCP messenger
 * run in one C pass per direction:
 *
 *   encode_entry(head, seq, msg) composes a whole MSG payload -- the
 *     kind|src|dst head, seq/length varints and the typed body -- as a
 *     scatter-gather part list with the frame crc folded in the same
 *     pass (large payload blobs are REFERENCED, never copied; small
 *     runs join into single buffers);
 *   seal_frames(entries, ack) seals a whole cork-queue batch: frame
 *     headers + piggyback-ack tail composed natively, cached payload
 *     crcs extended (never recomputed) over the tail;
 *   parse_burst(buf, pos) scans every complete frame in a received
 *     burst -- magic/length/crc validated in ONE GIL-released pass;
 *   decode_msg(rec, off) / decode_body(body) parse the envelope tail
 *     and the typed body straight from the record buffer.
 *
 * Bit-exactness contract: the byte stream is identical to the Python
 * codec in ceph_tpu_torch/msg/wire.py + utils/encoding.py.  Any value
 * outside the implemented model raises FallbackError and the caller
 * re-encodes that message through the Python codec -- at message
 * granularity, never a wire difference.
 *
 * Message types are Python dataclasses: the loader registers them via
 * register() (no imports here -- the module stays cycle-free), and
 * decode constructs instances through the same constructors the Python
 * codec calls.  Built by ceph_tpu_torch/native/build.py (wire_ext) with
 * gf_kernels.cpp for crc32c.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>
#include <structmember.h>
#include <time.h>

#ifdef __cplusplus
extern "C" {
#endif
extern uint32_t ec_crc32c(uint32_t crc, const uint8_t *data, size_t n);
#ifdef __cplusplus
}
#endif

#define MAGIC 0xCE9B10C5u
#define CRC_SEED 0xFFFFFFFFu
/* payload blobs at or above this stay scatter-gather (referenced); the
 * utils/encoding.Encoder.parts "small" threshold */
#define SCATTER 4096
/* whole payloads at or below this join into one buffer (msg/tcp.py
 * _JOIN_BELOW: a short memcpy beats per-part bookkeeping) */
#define JOIN_BELOW 4096

/* value tags (utils/encoding.py) */
enum {
  WT_NONE = 0, WT_FALSE = 1, WT_TRUE = 2, WT_INT = 3, WT_NEGINT = 4,
  WT_BYTES = 5, WT_STR = 6, WT_LIST = 7, WT_DICT = 8, WT_TUPLE = 9,
  WT_FLOAT = 10,
};

/* message kind bytes (msg/wire.py) */
enum {
  MSG_VALUE = 0, MSG_EC_SUB_WRITE = 1, MSG_EC_SUB_WRITE_REPLY = 2,
  MSG_EC_SUB_READ = 3, MSG_EC_SUB_READ_REPLY = 4, MSG_MGR_BEACON = 5,
  MSG_MGR_REPORT = 6,
};

/* -- module state ---------------------------------------------------------- */

static PyObject *FallbackError;   /* "re-encode via the Python codec" */
static PyObject *Unknown;         /* sentinel: unknown inbound frame kind */

/* registered dataclass types (borrowed semantics: we own one ref each) */
static PyObject *cls_sub_write, *cls_sub_write_reply, *cls_sub_read,
    *cls_sub_read_reply, *cls_transaction, *cls_txn_op, *cls_log_entry,
    *cls_mgr_beacon, *cls_mgr_report, *cls_np_integer;

/* interned attribute / kwarg names */
static PyObject *s_from_shard, *s_tid, *s_oid, *s_transaction,
    *s_at_version, *s_log_entries, *s_op_class, *s_rollback,
    *s_prev_version, *s_reqid, *s_trace, *s_qos_class, *s_committed,
    *s_applied, *s_current_version, *s_missed, *s_to_read,
    *s_attrs_to_read, *s_subchunks, *s_buffers_read, *s_attrs_read,
    *s_errors, *s_name, *s_seq, *s_interval, *s_stats, *s_lag_ms,
    *s_ops, *s_op, *s_offset, *s_data, *s_attr_name, *s_attr_value,
    *s_version, *s_prior_size, *s_parts, *s_crc, *s_regen;
static PyObject *empty_tuple;

/* -- output emitter -------------------------------------------------------- */

typedef struct {
  PyObject *parts;   /* list of finished output buffers */
  uint8_t *buf;      /* accumulating small-run buffer */
  size_t len, cap;
  size_t total;      /* bytes emitted so far (runs + refs) */
} Emit;

static int emit_init(Emit *e) {
  e->parts = PyList_New(0);
  if (e->parts == NULL) return -1;
  e->cap = 512;
  e->buf = (uint8_t *)PyMem_Malloc(e->cap);
  if (e->buf == NULL) {
    Py_CLEAR(e->parts);
    PyErr_NoMemory();
    return -1;
  }
  e->len = 0;
  e->total = 0;
  return 0;
}

static void emit_free(Emit *e) {
  PyMem_Free(e->buf);
  e->buf = NULL;
  Py_CLEAR(e->parts);
}

static int emit_flush_run(Emit *e) {
  PyObject *run;
  if (e->len == 0) return 0;
  run = PyBytes_FromStringAndSize((const char *)e->buf, (Py_ssize_t)e->len);
  if (run == NULL) return -1;
  if (PyList_Append(e->parts, run) < 0) {
    Py_DECREF(run);
    return -1;
  }
  Py_DECREF(run);
  e->len = 0;
  return 0;
}

static int emit_raw(Emit *e, const void *data, size_t n) {
  if (e->len + n > e->cap) {
    size_t cap = e->cap;
    uint8_t *nbuf;
    while (e->len + n > cap) cap *= 2;
    nbuf = (uint8_t *)PyMem_Realloc(e->buf, cap);
    if (nbuf == NULL) {
      PyErr_NoMemory();
      return -1;
    }
    e->buf = nbuf;
    e->cap = cap;
  }
  memcpy(e->buf + e->len, data, n);
  e->len += n;
  e->total += n;
  return 0;
}

static int emit_u8(Emit *e, uint8_t b) { return emit_raw(e, &b, 1); }

static int emit_varint(Emit *e, uint64_t v) {
  uint8_t out[10];
  int n = 0;
  for (;;) {
    uint8_t b = (uint8_t)(v & 0x7F);
    v >>= 7;
    if (v) {
      out[n++] = b | 0x80;
    } else {
      out[n++] = b;
      break;
    }
  }
  return emit_raw(e, out, (size_t)n);
}

/* reference a bytes object as its own scatter part (zero copy) */
static int emit_ref(Emit *e, PyObject *bytes_obj) {
  if (emit_flush_run(e) < 0) return -1;
  if (PyList_Append(e->parts, bytes_obj) < 0) return -1;
  e->total += (size_t)PyBytes_GET_SIZE(bytes_obj);
  return 0;
}

/* length-prefixed blob: big immutable bytes are referenced, everything
 * else (and small bytes) copies into the run -- Encoder.blob + parts() */
static int emit_blob(Emit *e, PyObject *obj) {
  if (PyBytes_Check(obj)) {
    Py_ssize_t n = PyBytes_GET_SIZE(obj);
    if (emit_varint(e, (uint64_t)n) < 0) return -1;
    if (n >= SCATTER) return emit_ref(e, obj);
    return emit_raw(e, PyBytes_AS_STRING(obj), (size_t)n);
  }
  if (PyByteArray_Check(obj)) {
    Py_ssize_t n = PyByteArray_GET_SIZE(obj);
    if (emit_varint(e, (uint64_t)n) < 0) return -1;
    return emit_raw(e, PyByteArray_AS_STRING(obj), (size_t)n);
  }
  if (PyObject_CheckBuffer(obj)) {
    Py_buffer view;
    int rc;
    if (PyObject_GetBuffer(obj, &view, PyBUF_SIMPLE) < 0) return -1;
    rc = emit_varint(e, (uint64_t)view.len);
    if (rc == 0) rc = emit_raw(e, view.buf, (size_t)view.len);
    PyBuffer_Release(&view);
    return rc;
  }
  PyErr_SetString(FallbackError, "unbloblable object");
  return -1;
}

static int emit_string(Emit *e, PyObject *str) {
  Py_ssize_t n;
  const char *utf8;
  if (!PyUnicode_Check(str)) {
    PyErr_SetString(FallbackError, "expected str");
    return -1;
  }
  utf8 = PyUnicode_AsUTF8AndSize(str, &n);
  if (utf8 == NULL) return -1;
  if (emit_varint(e, (uint64_t)n) < 0) return -1;
  return emit_raw(e, utf8, (size_t)n);
}

/* -- value encoder (Encoder.value, exact tag/order semantics) -------------- */

static int emit_value(Emit *e, PyObject *v);

static int emit_long(Emit *e, PyObject *v) {
  int overflow = 0;
  long long sv = PyLong_AsLongLongAndOverflow(v, &overflow);
  if (sv == -1 && PyErr_Occurred()) return -1;
  if (overflow > 0) {
    /* positive past 63 bits: still fits the unsigned varint */
    uint64_t uv = PyLong_AsUnsignedLongLong(v);
    if (uv == (uint64_t)-1 && PyErr_Occurred()) {
      /* arbitrary precision: the Python encoder handles it */
      PyErr_Clear();
      PyErr_SetString(FallbackError, "int wider than 64 bits");
      return -1;
    }
    if (emit_u8(e, WT_INT) < 0) return -1;
    return emit_varint(e, uv);
  }
  if (overflow < 0) {
    PyErr_SetString(FallbackError, "int wider than 64 bits");
    return -1;
  }
  if (sv >= 0) {
    if (emit_u8(e, WT_INT) < 0) return -1;
    return emit_varint(e, (uint64_t)sv);
  }
  if (emit_u8(e, WT_NEGINT) < 0) return -1;
  return emit_varint(e, (uint64_t)(-(sv + 1)) + 1);
}

static int emit_seq_items(Emit *e, PyObject *seq, uint8_t tag) {
  PyObject *fast = PySequence_Fast(seq, "expected a sequence");
  Py_ssize_t i, n;
  if (fast == NULL) return -1;
  n = PySequence_Fast_GET_SIZE(fast);
  if (emit_u8(e, tag) < 0 || emit_varint(e, (uint64_t)n) < 0) {
    Py_DECREF(fast);
    return -1;
  }
  for (i = 0; i < n; ++i) {
    if (emit_value(e, PySequence_Fast_GET_ITEM(fast, i)) < 0) {
      Py_DECREF(fast);
      return -1;
    }
  }
  Py_DECREF(fast);
  return 0;
}

static int emit_dict(Emit *e, PyObject *d) {
  PyObject *key, *val;
  Py_ssize_t pos = 0;
  if (emit_u8(e, WT_DICT) < 0) return -1;
  if (emit_varint(e, (uint64_t)PyDict_GET_SIZE(d)) < 0) return -1;
  while (PyDict_Next(d, &pos, &key, &val)) {
    if (!PyUnicode_Check(key)) {
      /* the Python encoder raises TypeError here -- same contract */
      /* cephlint: disable-next-line=native-missing-fallback */
      PyErr_Format(PyExc_TypeError, "dict keys must be str, got %R",
                   (PyObject *)Py_TYPE(key));
      return -1;
    }
    if (emit_string(e, key) < 0) return -1;
    if (emit_value(e, val) < 0) return -1;
  }
  return 0;
}

static int emit_value(Emit *e, PyObject *v) {
  int rc;
  if (v == Py_None) return emit_u8(e, WT_NONE);
  if (v == Py_True) return emit_u8(e, WT_TRUE);
  if (v == Py_False) return emit_u8(e, WT_FALSE);
  if (PyLong_Check(v)) return emit_long(e, v);
  if (PyBytes_Check(v)) {
    if (emit_u8(e, WT_BYTES) < 0) return -1;
    return emit_blob(e, v);
  }
  if (PyUnicode_Check(v)) {
    if (emit_u8(e, WT_STR) < 0) return -1;
    return emit_string(e, v);
  }
  if (PyFloat_Check(v)) {
    double d = PyFloat_AS_DOUBLE(v);
    uint8_t le[8];
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
    {
      const uint8_t *p = (const uint8_t *)&d;
      int i;
      for (i = 0; i < 8; ++i) le[i] = p[7 - i];
    }
#else
    memcpy(le, &d, 8);
#endif
    if (emit_u8(e, WT_FLOAT) < 0) return -1;
    return emit_raw(e, le, 8);
  }
  if (PyTuple_Check(v)) return emit_seq_items(e, v, WT_TUPLE);
  if (PyList_Check(v)) return emit_seq_items(e, v, WT_LIST);
  if (PyDict_Check(v)) return emit_dict(e, v);
  if (PyByteArray_Check(v) || PyMemoryView_Check(v)) {
    if (emit_u8(e, WT_BYTES) < 0) return -1;
    return emit_blob(e, v);
  }
  if (cls_np_integer != NULL &&
      (rc = PyObject_IsInstance(v, cls_np_integer)) != 0) {
    PyObject *as_int;
    if (rc < 0) return -1;
    as_int = PyNumber_Index(v);
    if (as_int == NULL) return -1;
    rc = emit_long(e, as_int);
    Py_DECREF(as_int);
    return rc;
  }
  PyErr_Format(FallbackError, "unencodable type %R", (PyObject *)Py_TYPE(v));
  return -1;
}

/* ``tuple(x) if isinstance(x, (tuple, list)) else x`` / the list twin:
 * the wire.py normalizations for version/reqid/trace fields */
static int emit_value_seq_normalized(Emit *e, PyObject *v, uint8_t tag) {
  if (PyTuple_Check(v) || PyList_Check(v)) return emit_seq_items(e, v, tag);
  return emit_value(e, v);
}

/* ``{k: [tuple(x) for x in v] for k, v in d.items()}`` -- the extent-map
 * normalization (ECSubRead to_read/subchunks) without building temps */
static int emit_extent_map(Emit *e, PyObject *d) {
  PyObject *key, *val;
  Py_ssize_t pos = 0;
  if (!PyDict_Check(d)) {
    PyErr_SetString(FallbackError, "extent map is not a dict");
    return -1;
  }
  if (emit_u8(e, WT_DICT) < 0) return -1;
  if (emit_varint(e, (uint64_t)PyDict_GET_SIZE(d)) < 0) return -1;
  while (PyDict_Next(d, &pos, &key, &val)) {
    PyObject *fast;
    Py_ssize_t i, n;
    if (!PyUnicode_Check(key)) {
      /* the Python encoder raises TypeError here -- same contract */
      /* cephlint: disable-next-line=native-missing-fallback */
      PyErr_Format(PyExc_TypeError, "dict keys must be str, got %R",
                   (PyObject *)Py_TYPE(key));
      return -1;
    }
    if (emit_string(e, key) < 0) return -1;
    fast = PySequence_Fast(val, "extent list expected");
    if (fast == NULL) return -1;
    n = PySequence_Fast_GET_SIZE(fast);
    if (emit_u8(e, WT_LIST) < 0 || emit_varint(e, (uint64_t)n) < 0) {
      Py_DECREF(fast);
      return -1;
    }
    for (i = 0; i < n; ++i) {
      if (emit_value_seq_normalized(
              e, PySequence_Fast_GET_ITEM(fast, i), WT_TUPLE) < 0) {
        Py_DECREF(fast);
        return -1;
      }
    }
    Py_DECREF(fast);
  }
  return 0;
}

/* ``{k: [(off, bytes(b)) for off, b in v] ...}`` -- ECSubReadReply
 * buffers_read normalization */
static int emit_buffers_read(Emit *e, PyObject *d) {
  PyObject *key, *val;
  Py_ssize_t pos = 0;
  if (!PyDict_Check(d)) {
    PyErr_SetString(FallbackError, "buffers_read is not a dict");
    return -1;
  }
  if (emit_u8(e, WT_DICT) < 0) return -1;
  if (emit_varint(e, (uint64_t)PyDict_GET_SIZE(d)) < 0) return -1;
  while (PyDict_Next(d, &pos, &key, &val)) {
    PyObject *fast;
    Py_ssize_t i, n;
    if (!PyUnicode_Check(key)) {
      /* the Python encoder raises TypeError here -- same contract */
      /* cephlint: disable-next-line=native-missing-fallback */
      PyErr_Format(PyExc_TypeError, "dict keys must be str, got %R",
                   (PyObject *)Py_TYPE(key));
      return -1;
    }
    if (emit_string(e, key) < 0) return -1;
    fast = PySequence_Fast(val, "buffer list expected");
    if (fast == NULL) return -1;
    n = PySequence_Fast_GET_SIZE(fast);
    if (emit_u8(e, WT_LIST) < 0 || emit_varint(e, (uint64_t)n) < 0) {
      Py_DECREF(fast);
      return -1;
    }
    for (i = 0; i < n; ++i) {
      PyObject *pair = PySequence_Fast_GET_ITEM(fast, i);
      PyObject *off, *b;
      if (!PyTuple_Check(pair) && !PyList_Check(pair)) {
        Py_DECREF(fast);
        PyErr_SetString(FallbackError, "buffer pair shape");
        return -1;
      }
      if (PySequence_Size(pair) != 2) {
        Py_DECREF(fast);
        PyErr_SetString(FallbackError, "buffer pair shape");
        return -1;
      }
      off = PySequence_GetItem(pair, 0);
      b = PySequence_GetItem(pair, 1);
      if (off == NULL || b == NULL ||
          emit_u8(e, WT_TUPLE) < 0 || emit_varint(e, 2) < 0 ||
          emit_value(e, off) < 0 ||
          emit_u8(e, WT_BYTES) < 0 || emit_blob(e, b) < 0) {
        Py_XDECREF(off);
        Py_XDECREF(b);
        Py_DECREF(fast);
        return -1;
      }
      Py_DECREF(off);
      Py_DECREF(b);
    }
    Py_DECREF(fast);
  }
  return 0;
}

/* -- typed body encoders (msg/wire.py message_encoder) --------------------- */

/* fetch msg.<attr>, emit through fn, drop the ref; -1 on error */
#define GET(obj, name, into)                          \
  do {                                                \
    (into) = PyObject_GetAttr((obj), (name));         \
    if ((into) == NULL) return -1;                    \
  } while (0)

static int emit_attr_varint(Emit *e, PyObject *msg, PyObject *name) {
  PyObject *v;
  uint64_t uv;
  GET(msg, name, v);
  uv = PyLong_AsUnsignedLongLong(v);
  if (uv == (uint64_t)-1 && PyErr_Occurred()) {
    Py_DECREF(v);
    /* negative / non-int field: the Python encoder would assert */
    PyErr_Clear();
    PyErr_SetString(FallbackError, "varint field out of range");
    return -1;
  }
  Py_DECREF(v);
  return emit_varint(e, uv);
}

static int emit_attr_string(Emit *e, PyObject *msg, PyObject *name) {
  PyObject *v;
  int rc;
  GET(msg, name, v);
  rc = emit_string(e, v);
  Py_DECREF(v);
  return rc;
}

static int emit_attr_value(Emit *e, PyObject *msg, PyObject *name) {
  PyObject *v;
  int rc;
  GET(msg, name, v);
  rc = emit_value(e, v);
  Py_DECREF(v);
  return rc;
}

static int emit_attr_value_norm(Emit *e, PyObject *msg, PyObject *name,
                                uint8_t tag) {
  PyObject *v;
  int rc;
  GET(msg, name, v);
  rc = emit_value_seq_normalized(e, v, tag);
  Py_DECREF(v);
  return rc;
}

static int emit_transaction(Emit *e, PyObject *txn) {
  PyObject *ops, *fast;
  Py_ssize_t i, n;
  GET(txn, s_ops, ops);
  fast = PySequence_Fast(ops, "transaction ops");
  Py_DECREF(ops);
  if (fast == NULL) return -1;
  n = PySequence_Fast_GET_SIZE(fast);
  if (emit_varint(e, (uint64_t)n) < 0) {
    Py_DECREF(fast);
    return -1;
  }
  for (i = 0; i < n; ++i) {
    PyObject *op = PySequence_Fast_GET_ITEM(fast, i);
    PyObject *data;
    if (emit_attr_string(e, op, s_op) < 0 ||
        emit_attr_string(e, op, s_oid) < 0 ||
        emit_attr_varint(e, op, s_offset) < 0) {
      Py_DECREF(fast);
      return -1;
    }
    data = PyObject_GetAttr(op, s_data);
    if (data == NULL || emit_blob(e, data) < 0) {
      Py_XDECREF(data);
      Py_DECREF(fast);
      return -1;
    }
    Py_DECREF(data);
    if (emit_attr_string(e, op, s_attr_name) < 0 ||
        emit_attr_value(e, op, s_attr_value) < 0) {
      Py_DECREF(fast);
      return -1;
    }
  }
  Py_DECREF(fast);
  return 0;
}

static int emit_log_entries(Emit *e, PyObject *msg) {
  PyObject *entries, *fast;
  Py_ssize_t i, n;
  GET(msg, s_log_entries, entries);
  fast = PySequence_Fast(entries, "log entries");
  Py_DECREF(entries);
  if (fast == NULL) return -1;
  n = PySequence_Fast_GET_SIZE(fast);
  if (emit_varint(e, (uint64_t)n) < 0) {
    Py_DECREF(fast);
    return -1;
  }
  for (i = 0; i < n; ++i) {
    PyObject *le = PySequence_Fast_GET_ITEM(fast, i);
    if (emit_attr_varint(e, le, s_version) < 0 ||
        emit_attr_string(e, le, s_oid) < 0 ||
        emit_attr_string(e, le, s_op) < 0 ||
        emit_attr_varint(e, le, s_prior_size) < 0) {
      Py_DECREF(fast);
      return -1;
    }
  }
  Py_DECREF(fast);
  return 0;
}

static int emit_attr_extent_map(Emit *e, PyObject *msg, PyObject *name) {
  PyObject *v;
  int rc;
  GET(msg, name, v);
  rc = emit_extent_map(e, v);
  Py_DECREF(v);
  return rc;
}

/* ``enc.value(list(x))`` */
static int emit_attr_value_as_list(Emit *e, PyObject *msg, PyObject *name) {
  PyObject *v, *fast;
  Py_ssize_t i, n;
  GET(msg, name, v);
  fast = PySequence_Fast(v, "expected a sequence");
  Py_DECREF(v);
  if (fast == NULL) return -1;
  n = PySequence_Fast_GET_SIZE(fast);
  if (emit_u8(e, WT_LIST) < 0 || emit_varint(e, (uint64_t)n) < 0) {
    Py_DECREF(fast);
    return -1;
  }
  for (i = 0; i < n; ++i) {
    if (emit_value(e, PySequence_Fast_GET_ITEM(fast, i)) < 0) {
      Py_DECREF(fast);
      return -1;
    }
  }
  Py_DECREF(fast);
  return 0;
}

static int emit_body(Emit *e, PyObject *msg) {
  int rc;
  if (cls_sub_write != NULL &&
      (rc = PyObject_IsInstance(msg, cls_sub_write)) != 0) {
    PyObject *txn;
    if (rc < 0) return -1;
    if (emit_u8(e, MSG_EC_SUB_WRITE) < 0 ||
        emit_attr_varint(e, msg, s_from_shard) < 0 ||
        emit_attr_varint(e, msg, s_tid) < 0 ||
        emit_attr_string(e, msg, s_oid) < 0)
      return -1;
    GET(msg, s_transaction, txn);
    rc = emit_transaction(e, txn);
    Py_DECREF(txn);
    if (rc < 0) return -1;
    if (emit_attr_value_norm(e, msg, s_at_version, WT_TUPLE) < 0 ||
        emit_log_entries(e, msg) < 0 ||
        emit_attr_string(e, msg, s_op_class) < 0 ||
        emit_attr_value(e, msg, s_rollback) < 0 ||
        emit_attr_value(e, msg, s_prev_version) < 0 ||
        emit_attr_value_norm(e, msg, s_reqid, WT_TUPLE) < 0 ||
        emit_attr_value_norm(e, msg, s_trace, WT_LIST) < 0 ||
        emit_attr_value(e, msg, s_qos_class) < 0)
      return -1;
    return 0;
  }
  if (cls_sub_write_reply != NULL &&
      (rc = PyObject_IsInstance(msg, cls_sub_write_reply)) != 0) {
    if (rc < 0) return -1;
    if (emit_u8(e, MSG_EC_SUB_WRITE_REPLY) < 0 ||
        emit_attr_varint(e, msg, s_from_shard) < 0 ||
        emit_attr_varint(e, msg, s_tid) < 0 ||
        emit_attr_value(e, msg, s_committed) < 0 ||
        emit_attr_value(e, msg, s_applied) < 0 ||
        emit_attr_value_norm(e, msg, s_current_version, WT_TUPLE) < 0 ||
        emit_attr_value(e, msg, s_missed) < 0)
      return -1;
    return 0;
  }
  if (cls_sub_read != NULL &&
      (rc = PyObject_IsInstance(msg, cls_sub_read)) != 0) {
    if (rc < 0) return -1;
    if (emit_u8(e, MSG_EC_SUB_READ) < 0 ||
        emit_attr_varint(e, msg, s_from_shard) < 0 ||
        emit_attr_varint(e, msg, s_tid) < 0 ||
        emit_attr_extent_map(e, msg, s_to_read) < 0 ||
        emit_attr_value_as_list(e, msg, s_attrs_to_read) < 0 ||
        emit_attr_extent_map(e, msg, s_subchunks) < 0 ||
        emit_attr_string(e, msg, s_op_class) < 0 ||
        emit_attr_value_norm(e, msg, s_trace, WT_LIST) < 0 ||
        emit_attr_value(e, msg, s_qos_class) < 0 ||
        emit_attr_value(e, msg, s_regen) < 0)
      return -1;
    return 0;
  }
  if (cls_sub_read_reply != NULL &&
      (rc = PyObject_IsInstance(msg, cls_sub_read_reply)) != 0) {
    PyObject *br;
    if (rc < 0) return -1;
    if (emit_u8(e, MSG_EC_SUB_READ_REPLY) < 0 ||
        emit_attr_varint(e, msg, s_from_shard) < 0 ||
        emit_attr_varint(e, msg, s_tid) < 0)
      return -1;
    GET(msg, s_buffers_read, br);
    rc = emit_buffers_read(e, br);
    Py_DECREF(br);
    if (rc < 0) return -1;
    if (emit_attr_value(e, msg, s_attrs_read) < 0 ||
        emit_attr_value(e, msg, s_errors) < 0)
      return -1;
    return 0;
  }
  if (cls_mgr_beacon != NULL &&
      (rc = PyObject_IsInstance(msg, cls_mgr_beacon)) != 0) {
    if (rc < 0) return -1;
    if (emit_u8(e, MSG_MGR_BEACON) < 0 ||
        emit_attr_string(e, msg, s_name) < 0 ||
        emit_attr_varint(e, msg, s_seq) < 0 ||
        emit_attr_value(e, msg, s_lag_ms) < 0)
      return -1;
    return 0;
  }
  if (cls_mgr_report != NULL &&
      (rc = PyObject_IsInstance(msg, cls_mgr_report)) != 0) {
    if (rc < 0) return -1;
    if (emit_u8(e, MSG_MGR_REPORT) < 0 ||
        emit_attr_string(e, msg, s_name) < 0 ||
        emit_attr_varint(e, msg, s_seq) < 0 ||
        emit_attr_value(e, msg, s_interval) < 0 ||
        emit_attr_value(e, msg, s_stats) < 0 ||
        emit_attr_value(e, msg, s_lag_ms) < 0)
      return -1;
    return 0;
  }
  if (emit_u8(e, MSG_VALUE) < 0) return -1;
  return emit_value(e, msg);
}

/* fold the frame crc over a finished part list (chained castagnoli) */
static uint32_t crc_parts(PyObject *parts, uint32_t crc, int *err) {
  Py_ssize_t i, n = PyList_GET_SIZE(parts);
  *err = 0;
  for (i = 0; i < n; ++i) {
    PyObject *p = PyList_GET_ITEM(parts, i);
    if (PyBytes_Check(p)) {
      crc = ec_crc32c(crc, (const uint8_t *)PyBytes_AS_STRING(p),
                      (size_t)PyBytes_GET_SIZE(p));
    } else {
      Py_buffer view;
      if (PyObject_GetBuffer(p, &view, PyBUF_SIMPLE) < 0) {
        *err = 1;
        return crc;
      }
      crc = ec_crc32c(crc, (const uint8_t *)view.buf, (size_t)view.len);
      PyBuffer_Release(&view);
    }
  }
  return crc;
}

/* -- encode entry points --------------------------------------------------- */

/* encode_body(msg) -> bytes: the joined typed body (wire.encode_message
 * twin; the interop-test surface) */
static PyObject *py_encode_body(PyObject *self, PyObject *msg) {
  Emit e;
  PyObject *out = NULL, *joined;
  Py_ssize_t i, n;
  char *w;
  if (emit_init(&e) < 0) return NULL;
  if (emit_body(&e, msg) < 0) goto fail;
  if (emit_flush_run(&e) < 0) goto fail;
  n = PyList_GET_SIZE(e.parts);
  if (n == 1) {
    out = PyList_GET_ITEM(e.parts, 0);
    Py_INCREF(out);
    emit_free(&e);
    return out;
  }
  joined = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)e.total);
  if (joined == NULL) goto fail;
  w = PyBytes_AS_STRING(joined);
  for (i = 0; i < n; ++i) {
    PyObject *p = PyList_GET_ITEM(e.parts, i);
    memcpy(w, PyBytes_AS_STRING(p), (size_t)PyBytes_GET_SIZE(p));
    w += PyBytes_GET_SIZE(p);
  }
  emit_free(&e);
  return joined;
fail:
  emit_free(&e);
  return NULL;
}

static int varint_len(uint64_t v) {
  int n = 1;
  while (v >= 0x80) {
    v >>= 7;
    ++n;
  }
  return n;
}

static void write_varint(uint8_t *p, uint64_t v) {
  for (;;) {
    uint8_t b = (uint8_t)(v & 0x7F);
    v >>= 7;
    if (v) {
      *p++ = b | 0x80;
    } else {
      *p++ = b;
      break;
    }
  }
}

/* encode_entry(head: bytes, seq: int, msg) -> (parts, nbytes, crc)
 *
 * One MSG payload composed in a single pass: the cached kind|src|dst
 * head, seq + body-length varints, and the typed body -- returned as a
 * scatter-gather part list (sub-JOIN_BELOW payloads joined into one
 * buffer) with the payload crc32c already folded, so the transmit-time
 * seal only EXTENDS it over the per-transmission tail. */
static PyObject *py_encode_entry(PyObject *self, PyObject *args) {
  PyObject *head, *msg, *parts_out = NULL, *result;
  unsigned long long seq;
  Emit e;
  uint8_t pre_tail[20];
  Py_ssize_t head_len;
  size_t pre_tail_len, total;
  uint32_t crc = CRC_SEED;
  int err = 0;

  if (!PyArg_ParseTuple(args, "SKO", &head, &seq, &msg)) return NULL;
  if (emit_init(&e) < 0) return NULL;
  if (emit_body(&e, msg) < 0 || emit_flush_run(&e) < 0) {
    emit_free(&e);
    return NULL;
  }
  head_len = PyBytes_GET_SIZE(head);
  write_varint(pre_tail, seq);
  pre_tail_len = (size_t)varint_len(seq);
  write_varint(pre_tail + pre_tail_len, (uint64_t)e.total);
  pre_tail_len += (size_t)varint_len((uint64_t)e.total);
  total = (size_t)head_len + pre_tail_len + e.total;

  if (total <= JOIN_BELOW) {
    /* one joined buffer: the hot sub-op-frame shape */
    PyObject *joined = PyBytes_FromStringAndSize(NULL, (Py_ssize_t)total);
    Py_ssize_t i, n;
    char *w;
    if (joined == NULL) {
      emit_free(&e);
      return NULL;
    }
    w = PyBytes_AS_STRING(joined);
    memcpy(w, PyBytes_AS_STRING(head), (size_t)head_len);
    w += head_len;
    memcpy(w, pre_tail, pre_tail_len);
    w += pre_tail_len;
    n = PyList_GET_SIZE(e.parts);
    for (i = 0; i < n; ++i) {
      PyObject *p = PyList_GET_ITEM(e.parts, i);
      memcpy(w, PyBytes_AS_STRING(p), (size_t)PyBytes_GET_SIZE(p));
      w += PyBytes_GET_SIZE(p);
    }
    crc = ec_crc32c(crc, (const uint8_t *)PyBytes_AS_STRING(joined), total);
    parts_out = PyList_New(1);
    if (parts_out == NULL) {
      Py_DECREF(joined);
      emit_free(&e);
      return NULL;
    }
    PyList_SET_ITEM(parts_out, 0, joined);
  } else {
    /* scatter: pre buffer (head + varints) as its own small part +
     * the body part list, big blobs referenced */
    PyObject *pre = PyBytes_FromStringAndSize(
        NULL, head_len + (Py_ssize_t)pre_tail_len);
    char *w;
    if (pre == NULL) {
      emit_free(&e);
      return NULL;
    }
    w = PyBytes_AS_STRING(pre);
    memcpy(w, PyBytes_AS_STRING(head), (size_t)head_len);
    memcpy(w + head_len, pre_tail, pre_tail_len);
    parts_out = PyList_New(0);
    if (parts_out == NULL || PyList_Append(parts_out, pre) < 0) {
      Py_XDECREF(parts_out);
      Py_DECREF(pre);
      emit_free(&e);
      return NULL;
    }
    Py_DECREF(pre);
    {
      Py_ssize_t i, n = PyList_GET_SIZE(e.parts);
      for (i = 0; i < n; ++i) {
        if (PyList_Append(parts_out, PyList_GET_ITEM(e.parts, i)) < 0) {
          Py_DECREF(parts_out);
          emit_free(&e);
          return NULL;
        }
      }
    }
    crc = crc_parts(parts_out, crc, &err);
    if (err) {
      Py_DECREF(parts_out);
      emit_free(&e);
      return NULL;
    }
  }
  emit_free(&e);
  result = Py_BuildValue("(NnI)", parts_out, (Py_ssize_t)total,
                         (unsigned int)crc);
  return result;
}

/* seal_frames(entries, ack) -> (bufs, nbytes)
 *
 * The whole cork-queue batch sealed in one call (unsigned connections):
 * per entry the cached payload crc is EXTENDED over the piggyback-ack
 * tail (which rides the LAST frame only) and one frame header is
 * composed -- the output is the flat writelines buffer list.  Entries
 * whose crc is still None (Python-encoded fallbacks) get it computed
 * and cached here, so retransmits never re-digest. */
static PyObject *py_seal_frames(PyObject *self, PyObject *args) {
  PyObject *entries, *bufs = NULL, *fast = NULL;
  unsigned long long ack;
  Py_ssize_t i, n;
  size_t nbytes = 0;

  if (!PyArg_ParseTuple(args, "OK", &entries, &ack)) return NULL;
  fast = PySequence_Fast(entries, "expected an entry sequence");
  if (fast == NULL) return NULL;
  n = PySequence_Fast_GET_SIZE(fast);
  bufs = PyList_New(0);
  if (bufs == NULL) goto fail;
  for (i = 0; i < n; ++i) {
    PyObject *entry = PySequence_Fast_GET_ITEM(fast, i);
    PyObject *parts, *crc_obj, *header;
    uint32_t crc;
    size_t plen;
    uint8_t tail[10];
    size_t tail_len = 0;
    int err = 0;
    Py_ssize_t j, np;
    uint8_t *hw;

    parts = PyObject_GetAttr(entry, s_parts);
    if (parts == NULL || !PyList_Check(parts)) {
      Py_XDECREF(parts);
      if (!PyErr_Occurred())
        PyErr_SetString(PyExc_TypeError, "entry.parts must be a list");
      goto fail;
    }
    crc_obj = PyObject_GetAttr(entry, s_crc);
    if (crc_obj == NULL) {
      Py_DECREF(parts);
      goto fail;
    }
    if (crc_obj == Py_None) {
      crc = crc_parts(parts, CRC_SEED, &err);
      if (err) {
        Py_DECREF(parts);
        Py_DECREF(crc_obj);
        goto fail;
      }
      Py_DECREF(crc_obj);
      crc_obj = PyLong_FromUnsignedLong(crc);
      if (crc_obj == NULL ||
          PyObject_SetAttr(entry, s_crc, crc_obj) < 0) {
        Py_XDECREF(crc_obj);
        Py_DECREF(parts);
        goto fail;
      }
    } else {
      crc = (uint32_t)PyLong_AsUnsignedLong(crc_obj);
      if (PyErr_Occurred()) {
        Py_DECREF(parts);
        Py_DECREF(crc_obj);
        goto fail;
      }
    }
    Py_DECREF(crc_obj);
    /* payload length */
    plen = 0;
    np = PyList_GET_SIZE(parts);
    for (j = 0; j < np; ++j) {
      PyObject *p = PyList_GET_ITEM(parts, j);
      Py_ssize_t pl = PyBytes_Check(p) ? PyBytes_GET_SIZE(p)
                                       : PyObject_Length(p);
      if (pl < 0) {
        Py_DECREF(parts);
        goto fail;
      }
      plen += (size_t)pl;
    }
    if (ack != 0 && i == n - 1) {
      write_varint(tail, ack);
      tail_len = (size_t)varint_len(ack);
      crc = ec_crc32c(crc, tail, tail_len);
      plen += tail_len;
    }
    /* frame header: <III magic, len, crc */
    header = PyBytes_FromStringAndSize(NULL, 12);
    if (header == NULL) {
      Py_DECREF(parts);
      goto fail;
    }
    hw = (uint8_t *)PyBytes_AS_STRING(header);
    hw[0] = (uint8_t)(MAGIC & 0xFF);
    hw[1] = (uint8_t)((MAGIC >> 8) & 0xFF);
    hw[2] = (uint8_t)((MAGIC >> 16) & 0xFF);
    hw[3] = (uint8_t)((MAGIC >> 24) & 0xFF);
    hw[4] = (uint8_t)(plen & 0xFF);
    hw[5] = (uint8_t)((plen >> 8) & 0xFF);
    hw[6] = (uint8_t)((plen >> 16) & 0xFF);
    hw[7] = (uint8_t)((plen >> 24) & 0xFF);
    hw[8] = (uint8_t)(crc & 0xFF);
    hw[9] = (uint8_t)((crc >> 8) & 0xFF);
    hw[10] = (uint8_t)((crc >> 16) & 0xFF);
    hw[11] = (uint8_t)((crc >> 24) & 0xFF);
    if (PyList_Append(bufs, header) < 0) {
      Py_DECREF(header);
      Py_DECREF(parts);
      goto fail;
    }
    Py_DECREF(header);
    for (j = 0; j < np; ++j) {
      if (PyList_Append(bufs, PyList_GET_ITEM(parts, j)) < 0) {
        Py_DECREF(parts);
        goto fail;
      }
    }
    Py_DECREF(parts);
    if (tail_len) {
      PyObject *t = PyBytes_FromStringAndSize((const char *)tail,
                                              (Py_ssize_t)tail_len);
      if (t == NULL || PyList_Append(bufs, t) < 0) {
        Py_XDECREF(t);
        goto fail;
      }
      Py_DECREF(t);
    }
    nbytes += 12 + plen;
  }
  Py_DECREF(fast);
  return Py_BuildValue("(Nn)", bufs, (Py_ssize_t)nbytes);
fail:
  Py_XDECREF(bufs);
  Py_XDECREF(fast);
  return NULL;
}

/* -- decode ---------------------------------------------------------------- */

typedef struct {
  const uint8_t *data;
  size_t pos, end;
} Dec;

static int dec_varint(Dec *d, uint64_t *out) {
  uint64_t v = 0;
  int shift = 0;
  while (d->pos < d->end) {
    uint8_t b = d->data[d->pos++];
    if (shift > 57 && ((uint64_t)(b & 0x7F) >> (64 - shift))) {
      /* the group carries bits past 2^64: never silently truncate --
       * lengths/counts this wide are forged or corrupt, and VALUE
       * ints take the wide path in dec_varint_obj instead */
      PyErr_SetString(PyExc_ValueError, "varint overflows u64");
      return -1;
    }
    v |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = v;
      return 0;
    }
    shift += 7;
    if (shift > 63) {
      PyErr_SetString(PyExc_ValueError, "varint too long");
      return -1;
    }
  }
  PyErr_SetString(PyExc_ValueError, "decode past end of buffer");
  return -1;
}

/* Full-width varint as a PyLong.  The Python codec round-trips ints of
 * any width the 10-group wire format holds (up to 70 bits), and its
 * fallback encoder emits the 64..70-bit band the C emitter refuses
 * (FallbackError), so the native DECODER must reconstruct that band
 * exactly -- truncating to u64 here silently corrupts a mixed-codec
 * peer pair. */
static PyObject *dec_varint_obj(Dec *d) {
  unsigned __int128 v = 0;
  int shift = 0;
  while (d->pos < d->end) {
    uint8_t b = d->data[d->pos++];
    v |= (unsigned __int128)(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      if (v >> 64) {
        /* cold path: only python-encoded fallback frames land here */
        PyObject *hi = PyLong_FromUnsignedLongLong((uint64_t)(v >> 64));
        PyObject *lo = PyLong_FromUnsignedLongLong((uint64_t)v);
        PyObject *sixty_four = PyLong_FromLong(64);
        PyObject *shifted = NULL, *out = NULL;
        if (hi != NULL && lo != NULL && sixty_four != NULL) {
          shifted = PyNumber_Lshift(hi, sixty_four);
          if (shifted != NULL) out = PyNumber_Or(shifted, lo);
        }
        Py_XDECREF(shifted);
        Py_XDECREF(sixty_four);
        Py_XDECREF(hi);
        Py_XDECREF(lo);
        return out;
      }
      return PyLong_FromUnsignedLongLong((uint64_t)v);
    }
    shift += 7;
    if (shift > 63) {
      PyErr_SetString(PyExc_ValueError, "varint too long");
      return NULL;
    }
  }
  PyErr_SetString(PyExc_ValueError, "decode past end of buffer");
  return NULL;
}

static int dec_take(Dec *d, size_t n, const uint8_t **out) {
  if (d->pos + n > d->end) {
    PyErr_SetString(PyExc_ValueError, "decode past end of buffer");
    return -1;
  }
  *out = d->data + d->pos;
  d->pos += n;
  return 0;
}

static PyObject *dec_blob(Dec *d) {
  uint64_t n;
  const uint8_t *p;
  if (dec_varint(d, &n) < 0) return NULL;
  if (dec_take(d, (size_t)n, &p) < 0) return NULL;
  return PyBytes_FromStringAndSize((const char *)p, (Py_ssize_t)n);
}

static PyObject *dec_string(Dec *d) {
  uint64_t n;
  const uint8_t *p;
  if (dec_varint(d, &n) < 0) return NULL;
  if (dec_take(d, (size_t)n, &p) < 0) return NULL;
  return PyUnicode_DecodeUTF8((const char *)p, (Py_ssize_t)n, NULL);
}

static PyObject *dec_value(Dec *d) {
  const uint8_t *p;
  uint64_t n;
  PyObject *out;
  uint8_t tag;
  if (d->pos >= d->end) {
    PyErr_SetString(PyExc_ValueError, "decode past end of buffer");
    return NULL;
  }
  tag = d->data[d->pos++];
  switch (tag) {
    case WT_INT:
      return dec_varint_obj(d);
    case WT_BYTES:
      return dec_blob(d);
    case WT_STR:
      return dec_string(d);
    case WT_NONE:
      Py_RETURN_NONE;
    case WT_TRUE:
      Py_RETURN_TRUE;
    case WT_FALSE:
      Py_RETURN_FALSE;
    case WT_NEGINT: {
      PyObject *mag, *neg;
      mag = dec_varint_obj(d);
      if (mag == NULL) return NULL;
      neg = PyNumber_Negative(mag);
      Py_DECREF(mag);
      return neg;
    }
    case WT_LIST:
    case WT_TUPLE: {
      uint64_t i;
      if (dec_varint(d, &n) < 0) return NULL;
      if (n > (uint64_t)(d->end - d->pos)) {
        /* each element needs >= 1 byte: cheap forged-length guard */
        PyErr_SetString(PyExc_ValueError, "sequence length past buffer");
        return NULL;
      }
      if (Py_EnterRecursiveCall(" decoding wire value")) return NULL;
      out = (tag == WT_LIST) ? PyList_New((Py_ssize_t)n)
                            : PyTuple_New((Py_ssize_t)n);
      if (out == NULL) {
        Py_LeaveRecursiveCall();
        return NULL;
      }
      for (i = 0; i < n; ++i) {
        PyObject *item = dec_value(d);
        if (item == NULL) {
          Py_DECREF(out);
          Py_LeaveRecursiveCall();
          return NULL;
        }
        if (tag == WT_LIST)
          PyList_SET_ITEM(out, (Py_ssize_t)i, item);
        else
          PyTuple_SET_ITEM(out, (Py_ssize_t)i, item);
      }
      Py_LeaveRecursiveCall();
      return out;
    }
    case WT_DICT: {
      uint64_t i;
      if (dec_varint(d, &n) < 0) return NULL;
      if (n > (uint64_t)(d->end - d->pos)) {
        PyErr_SetString(PyExc_ValueError, "dict length past buffer");
        return NULL;
      }
      if (Py_EnterRecursiveCall(" decoding wire value")) return NULL;
      out = PyDict_New();
      if (out == NULL) {
        Py_LeaveRecursiveCall();
        return NULL;
      }
      for (i = 0; i < n; ++i) {
        PyObject *key = dec_string(d);
        PyObject *val;
        if (key == NULL) {
          Py_DECREF(out);
          Py_LeaveRecursiveCall();
          return NULL;
        }
        val = dec_value(d);
        if (val == NULL || PyDict_SetItem(out, key, val) < 0) {
          Py_DECREF(key);
          Py_XDECREF(val);
          Py_DECREF(out);
          Py_LeaveRecursiveCall();
          return NULL;
        }
        Py_DECREF(key);
        Py_DECREF(val);
      }
      Py_LeaveRecursiveCall();
      return out;
    }
    case WT_FLOAT: {
      double v;
      if (dec_take(d, 8, &p) < 0) return NULL;
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
      {
        uint8_t sw[8];
        int i;
        for (i = 0; i < 8; ++i) sw[i] = p[7 - i];
        memcpy(&v, sw, 8);
      }
#else
      memcpy(&v, p, 8);
#endif
      return PyFloat_FromDouble(v);
    }
    default:
      PyErr_Format(PyExc_ValueError, "bad value tag %d", (int)tag);
      return NULL;
  }
}

/* kwargs-call a registered dataclass constructor; steals nothing */
static PyObject *construct(PyObject *cls, PyObject *kwargs) {
  return PyObject_Call(cls, empty_tuple, kwargs);
}

static int kw_set(PyObject *kw, PyObject *name, PyObject *val_stolen) {
  int rc;
  if (val_stolen == NULL) return -1;
  rc = PyDict_SetItem(kw, name, val_stolen);
  Py_DECREF(val_stolen);
  return rc;
}

/* ``[tuple(x) for x in v]`` in place over a freshly decoded list */
static int listify_tuples(PyObject *lst) {
  Py_ssize_t i, n;
  if (!PyList_Check(lst)) return 0;  /* decoded something else: leave it */
  n = PyList_GET_SIZE(lst);
  for (i = 0; i < n; ++i) {
    PyObject *item = PyList_GET_ITEM(lst, i);
    if (!PyTuple_Check(item)) {
      PyObject *t = PySequence_Tuple(item);
      if (t == NULL) return -1;
      PyList_SetItem(lst, i, t); /* steals t, drops item */
    }
  }
  return 0;
}

/* the extent-map decode transform, a faithful twin of the Python
 * comprehension {k: [tuple(x) for x in v]}: a non-dict input or a
 * non-iterable v RAISES exactly where the comprehension would -- a
 * corrupt frame must fail identically through both codecs, never
 * decode to a struct the Python side refuses (differential-fuzz
 * finding, tools/wire_fuzz.py) */
static int mapify_tuples(PyObject *d) {
  PyObject *key, *val;
  Py_ssize_t pos = 0;
  if (!PyDict_Check(d)) {
    PyErr_SetString(PyExc_ValueError, "extent map is not a dict");
    return -1;
  }
  while (PyDict_Next(d, &pos, &key, &val)) {
    if (PyList_Check(val)) {
      if (listify_tuples(val) < 0) return -1; /* in-place fast path */
    } else {
      /* the comprehension materializes any iterable v as a fresh
       * list (str iterates chars, dict iterates keys) and raises
       * TypeError on the rest; PySequence_List matches that */
      PyObject *lst = PySequence_List(val);
      if (lst == NULL) return -1;
      if (listify_tuples(lst) < 0) {
        Py_DECREF(lst);
        return -1;
      }
      /* value replacement for an existing key: safe under
       * PyDict_Next (the key set does not change) */
      if (PyDict_SetItem(d, key, lst) < 0) {
        Py_DECREF(lst);
        return -1;
      }
      Py_DECREF(lst);
    }
  }
  return 0;
}

static PyObject *decode_transaction(Dec *d) {
  uint64_t n, i;
  PyObject *txn, *ops;
  if (dec_varint(d, &n) < 0) return NULL;
  txn = construct(cls_transaction, NULL);
  if (txn == NULL) return NULL;
  ops = PyObject_GetAttr(txn, s_ops);
  if (ops == NULL) {
    Py_DECREF(txn);
    return NULL;
  }
  for (i = 0; i < n; ++i) {
    PyObject *kw = PyDict_New();
    PyObject *op_obj;
    if (kw == NULL) goto fail;
    if (kw_set(kw, s_op, dec_string(d)) < 0 ||
        kw_set(kw, s_oid, dec_string(d)) < 0 ||
        kw_set(kw, s_offset, dec_varint_obj(d)) < 0 ||
        kw_set(kw, s_data, dec_blob(d)) < 0 ||
        kw_set(kw, s_attr_name, dec_string(d)) < 0 ||
        kw_set(kw, s_attr_value, dec_value(d)) < 0) {
      Py_DECREF(kw);
      goto fail;
    }
    op_obj = construct(cls_txn_op, kw);
    Py_DECREF(kw);
    if (op_obj == NULL) goto fail;
    if (PyList_Append(ops, op_obj) < 0) {
      Py_DECREF(op_obj);
      goto fail;
    }
    Py_DECREF(op_obj);
  }
  Py_DECREF(ops);
  return txn;
fail:
  Py_DECREF(ops);
  Py_DECREF(txn);
  return NULL;
}

static PyObject *decode_body_at(Dec *d) {
  uint8_t kind;
  PyObject *kw = NULL, *out = NULL;
  if (d->pos >= d->end) {
    PyErr_SetString(PyExc_ValueError, "decode past end of buffer");
    return NULL;
  }
  kind = d->data[d->pos++];
  switch (kind) {
    case MSG_VALUE:
      return dec_value(d);
    case MSG_EC_SUB_WRITE: {
      PyObject *txn, *entries;
      uint64_t ne, i;
      kw = PyDict_New();
      if (kw == NULL) return NULL;
      if (kw_set(kw, s_from_shard, dec_varint_obj(d)) < 0 ||
          kw_set(kw, s_tid, dec_varint_obj(d)) < 0 ||
          kw_set(kw, s_oid, dec_string(d)) < 0)
        goto fail;
      txn = decode_transaction(d);
      if (kw_set(kw, s_transaction, txn) < 0) goto fail;
      if (kw_set(kw, s_at_version, dec_value(d)) < 0) goto fail;
      if (dec_varint(d, &ne) < 0) goto fail;
      entries = PyList_New(0);
      if (entries == NULL) goto fail;
      for (i = 0; i < ne; ++i) {
        PyObject *lkw = PyDict_New();
        PyObject *le;
        if (lkw == NULL) {
          Py_DECREF(entries);
          goto fail;
        }
        if (kw_set(lkw, s_version, dec_varint_obj(d)) < 0 ||
            kw_set(lkw, s_oid, dec_string(d)) < 0 ||
            kw_set(lkw, s_op, dec_string(d)) < 0 ||
            kw_set(lkw, s_prior_size, dec_varint_obj(d)) < 0) {
          Py_DECREF(lkw);
          Py_DECREF(entries);
          goto fail;
        }
        le = construct(cls_log_entry, lkw);
        Py_DECREF(lkw);
        if (le == NULL || PyList_Append(entries, le) < 0) {
          Py_XDECREF(le);
          Py_DECREF(entries);
          goto fail;
        }
        Py_DECREF(le);
      }
      if (kw_set(kw, s_log_entries, entries) < 0) goto fail;
      if (kw_set(kw, s_op_class, dec_string(d)) < 0 ||
          kw_set(kw, s_rollback, dec_value(d)) < 0 ||
          kw_set(kw, s_prev_version, dec_value(d)) < 0)
        goto fail;
      /* trailing optionals (wire-optional compat tails): pre-reqid /
       * pre-trace / pre-qos senders end earlier -- mirror the guards */
      if (d->pos < d->end) {
        if (kw_set(kw, s_reqid, dec_value(d)) < 0) goto fail;
      }
      if (d->pos < d->end) {
        if (kw_set(kw, s_trace, dec_value(d)) < 0) goto fail;
      }
      if (d->pos < d->end) {
        if (kw_set(kw, s_qos_class, dec_value(d)) < 0) goto fail;
      }
      out = construct(cls_sub_write, kw);
      Py_DECREF(kw);
      return out;
    }
    case MSG_EC_SUB_WRITE_REPLY:
      kw = PyDict_New();
      if (kw == NULL) return NULL;
      if (kw_set(kw, s_from_shard, dec_varint_obj(d)) < 0 ||
          kw_set(kw, s_tid, dec_varint_obj(d)) < 0 ||
          kw_set(kw, s_committed, dec_value(d)) < 0 ||
          kw_set(kw, s_applied, dec_value(d)) < 0 ||
          kw_set(kw, s_current_version, dec_value(d)) < 0 ||
          kw_set(kw, s_missed, dec_value(d)) < 0)
        goto fail;
      out = construct(cls_sub_write_reply, kw);
      Py_DECREF(kw);
      return out;
    case MSG_EC_SUB_READ: {
      PyObject *m;
      kw = PyDict_New();
      if (kw == NULL) return NULL;
      if (kw_set(kw, s_from_shard, dec_varint_obj(d)) < 0 ||
          kw_set(kw, s_tid, dec_varint_obj(d)) < 0)
        goto fail;
      m = dec_value(d);
      if (m == NULL) goto fail;
      if (mapify_tuples(m) < 0) {
        Py_DECREF(m);
        goto fail;
      }
      if (kw_set(kw, s_to_read, m) < 0) goto fail;
      if (kw_set(kw, s_attrs_to_read, dec_value(d)) < 0) goto fail;
      m = dec_value(d);
      if (m == NULL) goto fail;
      if (mapify_tuples(m) < 0) {
        Py_DECREF(m);
        goto fail;
      }
      if (kw_set(kw, s_subchunks, m) < 0) goto fail;
      if (kw_set(kw, s_op_class, dec_string(d)) < 0) goto fail;
      if (d->pos < d->end) {
        if (kw_set(kw, s_trace, dec_value(d)) < 0) goto fail;
      }
      if (d->pos < d->end) {
        if (kw_set(kw, s_qos_class, dec_value(d)) < 0) goto fail;
      }
      if (d->pos < d->end) {
        if (kw_set(kw, s_regen, dec_value(d)) < 0) goto fail;
      }
      out = construct(cls_sub_read, kw);
      Py_DECREF(kw);
      return out;
    }
    case MSG_EC_SUB_READ_REPLY:
      kw = PyDict_New();
      if (kw == NULL) return NULL;
      if (kw_set(kw, s_from_shard, dec_varint_obj(d)) < 0 ||
          kw_set(kw, s_tid, dec_varint_obj(d)) < 0 ||
          kw_set(kw, s_buffers_read, dec_value(d)) < 0 ||
          kw_set(kw, s_attrs_read, dec_value(d)) < 0 ||
          kw_set(kw, s_errors, dec_value(d)) < 0)
        goto fail;
      out = construct(cls_sub_read_reply, kw);
      Py_DECREF(kw);
      return out;
    case MSG_MGR_BEACON:
      kw = PyDict_New();
      if (kw == NULL) return NULL;
      if (kw_set(kw, s_name, dec_string(d)) < 0 ||
          kw_set(kw, s_seq, dec_varint_obj(d)) < 0)
        goto fail;
      if (d->pos < d->end) {
        if (kw_set(kw, s_lag_ms, dec_value(d)) < 0) goto fail;
      }
      out = construct(cls_mgr_beacon, kw);
      Py_DECREF(kw);
      return out;
    case MSG_MGR_REPORT:
      kw = PyDict_New();
      if (kw == NULL) return NULL;
      if (kw_set(kw, s_name, dec_string(d)) < 0 ||
          kw_set(kw, s_seq, dec_varint_obj(d)) < 0 ||
          kw_set(kw, s_interval, dec_value(d)) < 0 ||
          kw_set(kw, s_stats, dec_value(d)) < 0)
        goto fail;
      if (d->pos < d->end) {
        if (kw_set(kw, s_lag_ms, dec_value(d)) < 0) goto fail;
      }
      out = construct(cls_mgr_report, kw);
      Py_DECREF(kw);
      return out;
    default:
      /* a NEWER peer's frame kind: the transport counts-and-drops */
      Py_INCREF(Unknown);
      return Unknown;
  }
fail:
  Py_XDECREF(kw);
  return NULL;
}

/* decode_body(body: bytes) -> msg (wire.decode_message twin; raises
 * ValueError on an unknown kind, matching the Python codec) */
static PyObject *py_decode_body(PyObject *self, PyObject *arg) {
  Dec d;
  PyObject *out;
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
  d.data = (const uint8_t *)view.buf;
  d.pos = 0;
  d.end = (size_t)view.len;
  out = decode_body_at(&d);
  PyBuffer_Release(&view);
  if (out == Unknown) {
    Py_DECREF(out);
    PyErr_SetString(PyExc_ValueError, "unknown message type");
    return NULL;
  }
  return out;
}

/* decode_msg(rec: bytes, offset) -> (seq, msg, back_ack)
 *
 * The inbound envelope tail + typed body in one pass: seq varint, the
 * length-prefixed body decoded IN PLACE from the record buffer, and
 * the optional trailing piggyback-ack varint (None when absent -- v3
 * senders end at the body).  ``msg`` is the UNKNOWN sentinel for a
 * newer peer's frame kind (count-and-drop at the transport). */
static PyObject *py_decode_msg(PyObject *self, PyObject *args) {
  PyObject *rec, *msg, *ack_obj, *out;
  Py_ssize_t offset;
  Py_buffer view;
  Dec d, body;
  uint64_t seq, blen, ack;

  if (!PyArg_ParseTuple(args, "On", &rec, &offset)) return NULL;
  if (PyObject_GetBuffer(rec, &view, PyBUF_SIMPLE) < 0) return NULL;
  if (offset < 0 || offset > view.len) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "offset out of range");
    return NULL;
  }
  d.data = (const uint8_t *)view.buf;
  d.pos = (size_t)offset;
  d.end = (size_t)view.len;
  if (dec_varint(&d, &seq) < 0 || dec_varint(&d, &blen) < 0) {
    PyBuffer_Release(&view);
    return NULL;
  }
  if (d.pos + blen > d.end) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "body past end of record");
    return NULL;
  }
  body.data = d.data;
  body.pos = d.pos;
  body.end = d.pos + (size_t)blen;
  msg = decode_body_at(&body);
  if (msg == NULL) {
    PyBuffer_Release(&view);
    return NULL;
  }
  d.pos += (size_t)blen;
  if (d.pos < d.end) {
    if (dec_varint(&d, &ack) < 0) {
      PyBuffer_Release(&view);
      Py_DECREF(msg);
      return NULL;
    }
    ack_obj = PyLong_FromUnsignedLongLong(ack);
  } else {
    ack_obj = Py_None;
    Py_INCREF(Py_None);
  }
  PyBuffer_Release(&view);
  if (ack_obj == NULL) {
    Py_DECREF(msg);
    return NULL;
  }
  out = Py_BuildValue("(KNN)", seq, msg, ack_obj);
  return out;
}

/* parse_burst(buf: bytes, pos) -> (frames, new_pos, ok)
 *
 * Every complete ``MAGIC | len | crc | payload`` frame already buffered
 * is located and crc-validated in ONE GIL-released pass over the raw
 * buffer; the payload slices are materialized afterwards.  ``ok`` is
 * False when the scan hit a corrupt/forged frame (the caller drops the
 * connection, exactly like unframe() returning None). */
static PyObject *py_parse_burst(PyObject *self, PyObject *args) {
  PyObject *buf, *frames;
  Py_ssize_t pos;
  Py_buffer view;
  size_t p, end;
  int ok = 1;
  size_t n_frames = 0, cap_frames = 32;
  size_t *offs;   /* payload offset/length pairs */

  if (!PyArg_ParseTuple(args, "On", &buf, &pos)) return NULL;
  if (PyObject_GetBuffer(buf, &view, PyBUF_SIMPLE) < 0) return NULL;
  if (pos < 0 || pos > view.len) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "pos out of range");
    return NULL;
  }
  offs = (size_t *)PyMem_RawMalloc(sizeof(size_t) * 2 * cap_frames);
  if (offs == NULL) {
    PyBuffer_Release(&view);
    return PyErr_NoMemory();
  }
  p = (size_t)pos;
  end = (size_t)view.len;
  {
    const uint8_t *data = (const uint8_t *)view.buf;
    int mem_fail = 0;
    Py_BEGIN_ALLOW_THREADS
    while (end - p >= 12) {
      uint32_t magic = (uint32_t)data[p] | ((uint32_t)data[p + 1] << 8) |
                       ((uint32_t)data[p + 2] << 16) |
                       ((uint32_t)data[p + 3] << 24);
      uint32_t length = (uint32_t)data[p + 4] |
                        ((uint32_t)data[p + 5] << 8) |
                        ((uint32_t)data[p + 6] << 16) |
                        ((uint32_t)data[p + 7] << 24);
      uint32_t crc = (uint32_t)data[p + 8] | ((uint32_t)data[p + 9] << 8) |
                     ((uint32_t)data[p + 10] << 16) |
                     ((uint32_t)data[p + 11] << 24);
      if (magic != MAGIC) {
        ok = 0;
        break;
      }
      if (end - p - 12 < (size_t)length) break; /* partial tail frame */
      if (ec_crc32c(CRC_SEED, data + p + 12, (size_t)length) != crc) {
        ok = 0;
        break;
      }
      if (n_frames == cap_frames) {
        size_t *grown;
        cap_frames *= 2;
        grown = (size_t *)PyMem_RawRealloc(
            offs, sizeof(size_t) * 2 * cap_frames);
        if (grown == NULL) {
          mem_fail = 1;
          break;
        }
        offs = grown;
      }
      offs[2 * n_frames] = p + 12;
      offs[2 * n_frames + 1] = (size_t)length;
      ++n_frames;
      p += 12 + (size_t)length;
    }
    Py_END_ALLOW_THREADS
    if (mem_fail) {
      PyMem_RawFree(offs);
      PyBuffer_Release(&view);
      return PyErr_NoMemory();
    }
    frames = PyList_New((Py_ssize_t)n_frames);
    if (frames == NULL) {
      PyMem_RawFree(offs);
      PyBuffer_Release(&view);
      return NULL;
    }
    {
      size_t i;
      for (i = 0; i < n_frames; ++i) {
        PyObject *payload = PyBytes_FromStringAndSize(
            (const char *)data + offs[2 * i], (Py_ssize_t)offs[2 * i + 1]);
        if (payload == NULL) {
          Py_DECREF(frames);
          PyMem_RawFree(offs);
          PyBuffer_Release(&view);
          return NULL;
        }
        PyList_SET_ITEM(frames, (Py_ssize_t)i, payload);
      }
    }
  }
  PyMem_RawFree(offs);
  PyBuffer_Release(&view);
  return Py_BuildValue("(NnO)", frames, (Py_ssize_t)p,
                       ok ? Py_True : Py_False);
}


/* -- C stage markers (the profiler's hot path) ------------------------------
 *
 * The ledger's `with stage(name):` markers bracket every wire seam;
 * against the native codec's wire wall the Python pairs' ~0.6us cost
 * is a >3% enabled-profiler overhead -- failing the wire-tax stage's
 * own gate.  This Stage type is the drop-in C twin
 * (ceph_tpu_torch/profiling/ledger.py selects it when the extension
 * loads):
 * identical exclusive-time semantics -- entering banks+pauses the
 * parent's clock, every nanosecond lands in exactly one stage, GC
 * pauses credited out via stage_gc_credit -- at clock_gettime cost.
 * Disabled enter/exit is a flag check returning a borrowed constant:
 * zero allocations, pinned by the bench's off-mode alloc gate. */

typedef struct StageObj {
  PyObject_HEAD
  PyObject *name;
  long long ns, calls, nbytes;
  long long t0;
  struct StageObj *parent;  /* strong ref while on the current chain */
} StageObj;

static int stage_enabled_flag = 0;
static StageObj *stage_current = NULL;  /* strong ref */

static inline long long stage_now_ns(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (long long)ts.tv_sec * 1000000000LL + (long long)ts.tv_nsec;
}

static PyObject *Stage_new(PyTypeObject *type, PyObject *args,
                           PyObject *kwargs) {
  PyObject *name;
  StageObj *self;
  if (!PyArg_ParseTuple(args, "U", &name)) return NULL;
  self = (StageObj *)type->tp_alloc(type, 0);
  if (self == NULL) return NULL;
  Py_INCREF(name);
  self->name = name;
  self->ns = self->calls = self->nbytes = 0;
  self->t0 = 0;
  self->parent = NULL;
  return (PyObject *)self;
}

static void Stage_dealloc(StageObj *self) {
  Py_XDECREF(self->name);
  Py_XDECREF((PyObject *)self->parent);
  Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyObject *Stage_enter(StageObj *self, PyObject *noargs) {
  long long now;
  StageObj *parent;
  if (!stage_enabled_flag) {
    Py_INCREF(self);
    return (PyObject *)self;
  }
  now = stage_now_ns();
  parent = stage_current;
  if (parent != NULL) parent->ns += now - parent->t0;
  /* transfer stage_current's ref into self->parent (clearing any
   * stale parent from an enable-toggle abandoning an open stage) */
  Py_XDECREF((PyObject *)self->parent);
  self->parent = parent;
  self->t0 = now;
  Py_INCREF(self);
  stage_current = self;
  Py_INCREF(self);
  return (PyObject *)self;
}

static PyObject *Stage_exit(StageObj *self, PyObject *args) {
  long long now;
  StageObj *parent;
  if (!stage_enabled_flag) Py_RETURN_FALSE;
  now = stage_now_ns();
  self->ns += now - self->t0;
  self->calls += 1;
  parent = self->parent;
  self->parent = NULL;
  if (stage_current == self) {
    Py_DECREF((PyObject *)self);  /* the chain's ref to us */
    stage_current = parent;       /* ownership transfers */
    if (parent != NULL) parent->t0 = now;
  } else {
    /* mismatched nesting (enable toggled mid-block): drop quietly,
     * exactly like the Python marker's abandoned-tail semantics */
    Py_XDECREF((PyObject *)parent);
  }
  Py_RETURN_FALSE;
}

static PyObject *Stage_add_bytes(StageObj *self, PyObject *arg) {
  if (stage_enabled_flag) {
    long long n = PyLong_AsLongLong(arg);
    if (n == -1 && PyErr_Occurred()) return NULL;
    self->nbytes += n;
  }
  Py_RETURN_NONE;
}

static PyMethodDef Stage_methods[] = {
    {"__enter__", (PyCFunction)Stage_enter, METH_NOARGS, NULL},
    {"__exit__", (PyCFunction)Stage_exit, METH_VARARGS, NULL},
    {"add_bytes", (PyCFunction)Stage_add_bytes, METH_O, NULL},
    {NULL, NULL, 0, NULL},
};

static PyMemberDef Stage_members[] = {
    {(char *)"name", T_OBJECT_EX, offsetof(StageObj, name), READONLY,
     NULL},
    {(char *)"ns", T_LONGLONG, offsetof(StageObj, ns), 0, NULL},
    {(char *)"calls", T_LONGLONG, offsetof(StageObj, calls), 0, NULL},
    {(char *)"nbytes", T_LONGLONG, offsetof(StageObj, nbytes), 0, NULL},
    {NULL, 0, 0, 0, NULL},
};

static PyTypeObject StageType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    "_wire_native.Stage",          /* tp_name */
    sizeof(StageObj),              /* tp_basicsize */
};

static PyObject *py_stage_set_enabled(PyObject *self, PyObject *arg) {
  int on = PyObject_IsTrue(arg);
  if (on < 0) return NULL;
  stage_enabled_flag = on;
  if (!on) {
    /* abandon the open chain (test/bench boundary, never a hot op) */
    StageObj *cur = stage_current;
    stage_current = NULL;
    while (cur != NULL) {
      StageObj *p = cur->parent;
      cur->parent = NULL;
      Py_DECREF((PyObject *)cur);
      cur = p;
    }
  }
  Py_RETURN_NONE;
}

static PyObject *py_stage_gc_credit(PyObject *self, PyObject *arg) {
  long long ns = PyLong_AsLongLong(arg);
  if (ns == -1 && PyErr_Occurred()) return NULL;
  if (stage_current != NULL) stage_current->t0 += ns;
  Py_RETURN_NONE;
}

static PyObject *py_stage_current_name(PyObject *self, PyObject *noargs) {
  if (stage_current != NULL) {
    Py_INCREF(stage_current->name);
    return stage_current->name;
  }
  Py_RETURN_NONE;
}

/* -- registration ---------------------------------------------------------- */

static PyObject *py_register(PyObject *self, PyObject *args,
                             PyObject *kwargs) {
  static const char *kwlist_names[] = {
      "ec_sub_write", "ec_sub_write_reply", "ec_sub_read",
      "ec_sub_read_reply", "transaction", "txn_op", "log_entry",
      "mgr_beacon", "mgr_report", "np_integer", NULL};
  static char *kwlist[11];
  PyObject *a, *b, *c, *d2, *e, *f, *g, *h, *i2, *j;
  int i;
  for (i = 0; i < 11; ++i) kwlist[i] = (char *)kwlist_names[i];
  if (!PyArg_ParseTupleAndKeywords(
          args, kwargs, "OOOOOOOOOO", kwlist, &a, &b, &c, &d2, &e, &f,
          &g, &h, &i2, &j))
    return NULL;
  Py_INCREF(a); Py_XSETREF(cls_sub_write, a);
  Py_INCREF(b); Py_XSETREF(cls_sub_write_reply, b);
  Py_INCREF(c); Py_XSETREF(cls_sub_read, c);
  Py_INCREF(d2); Py_XSETREF(cls_sub_read_reply, d2);
  Py_INCREF(e); Py_XSETREF(cls_transaction, e);
  Py_INCREF(f); Py_XSETREF(cls_txn_op, f);
  Py_INCREF(g); Py_XSETREF(cls_log_entry, g);
  Py_INCREF(h); Py_XSETREF(cls_mgr_beacon, h);
  Py_INCREF(i2); Py_XSETREF(cls_mgr_report, i2);
  Py_INCREF(j); Py_XSETREF(cls_np_integer, j);
  Py_RETURN_NONE;
}

static PyMethodDef Methods[] = {
    {"register", (PyCFunction)py_register, METH_VARARGS | METH_KEYWORDS,
     "register(ec_sub_write, ..., np_integer): bind the message types"},
    {"encode_body", py_encode_body, METH_O,
     "encode_body(msg) -> bytes (typed body; wire.encode_message twin)"},
    {"encode_entry", py_encode_entry, METH_VARARGS,
     "encode_entry(head, seq, msg) -> (parts, nbytes, crc)"},
    {"seal_frames", py_seal_frames, METH_VARARGS,
     "seal_frames(entries, ack) -> (bufs, nbytes)"},
    {"parse_burst", py_parse_burst, METH_VARARGS,
     "parse_burst(buf, pos) -> (frames, new_pos, ok)"},
    {"decode_msg", py_decode_msg, METH_VARARGS,
     "decode_msg(rec, offset) -> (seq, msg, back_ack)"},
    {"decode_body", py_decode_body, METH_O,
     "decode_body(body) -> msg (wire.decode_message twin)"},
    {"stage_set_enabled", py_stage_set_enabled, METH_O,
     "stage_set_enabled(on): master switch for C Stage markers"},
    {"stage_gc_credit", py_stage_gc_credit, METH_O,
     "stage_gc_credit(ns): push the current stage's clock past a GC "
     "pause"},
    {"stage_current_name", py_stage_current_name, METH_NOARGS,
     "stage_current_name() -> str | None (the sampler's read)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_wire_native",
    "batched native v4 wire codec (frame bodies + envelopes + seal)",
    -1, Methods,
};

PyMODINIT_FUNC PyInit__wire_native(void) {
  PyObject *mod;
  StageType.tp_flags = Py_TPFLAGS_DEFAULT;
  StageType.tp_doc = "C stage marker (ledger.StageMarker twin)";
  StageType.tp_new = Stage_new;
  StageType.tp_dealloc = (destructor)Stage_dealloc;
  StageType.tp_methods = Stage_methods;
  StageType.tp_members = Stage_members;
  if (PyType_Ready(&StageType) < 0) return NULL;
  mod = PyModule_Create(&moduledef);
  if (mod == NULL) return NULL;
  Py_INCREF(&StageType);
  PyModule_AddObject(mod, "Stage", (PyObject *)&StageType);
  FallbackError = PyErr_NewException(
      "_wire_native.FallbackError", NULL, NULL);
  Unknown = PyObject_CallObject((PyObject *)&PyBaseObject_Type, NULL);
  empty_tuple = PyTuple_New(0);
  if (FallbackError == NULL || Unknown == NULL || empty_tuple == NULL)
    goto fail;
  Py_INCREF(FallbackError);
  PyModule_AddObject(mod, "FallbackError", FallbackError);
  Py_INCREF(Unknown);
  PyModule_AddObject(mod, "UNKNOWN", Unknown);

#define INTERN(var, name)                      \
  do {                                         \
    var = PyUnicode_InternFromString(name);    \
    if (var == NULL) goto fail;                \
  } while (0)
  INTERN(s_from_shard, "from_shard");
  INTERN(s_tid, "tid");
  INTERN(s_oid, "oid");
  INTERN(s_transaction, "transaction");
  INTERN(s_at_version, "at_version");
  INTERN(s_log_entries, "log_entries");
  INTERN(s_op_class, "op_class");
  INTERN(s_rollback, "rollback");
  INTERN(s_prev_version, "prev_version");
  INTERN(s_reqid, "reqid");
  INTERN(s_trace, "trace");
  INTERN(s_qos_class, "qos_class");
  INTERN(s_committed, "committed");
  INTERN(s_applied, "applied");
  INTERN(s_current_version, "current_version");
  INTERN(s_missed, "missed");
  INTERN(s_to_read, "to_read");
  INTERN(s_attrs_to_read, "attrs_to_read");
  INTERN(s_subchunks, "subchunks");
  INTERN(s_regen, "regen");
  INTERN(s_buffers_read, "buffers_read");
  INTERN(s_attrs_read, "attrs_read");
  INTERN(s_errors, "errors");
  INTERN(s_name, "name");
  INTERN(s_seq, "seq");
  INTERN(s_interval, "interval");
  INTERN(s_stats, "stats");
  INTERN(s_lag_ms, "lag_ms");
  INTERN(s_ops, "ops");
  INTERN(s_op, "op");
  INTERN(s_offset, "offset");
  INTERN(s_data, "data");
  INTERN(s_attr_name, "attr_name");
  INTERN(s_attr_value, "attr_value");
  INTERN(s_version, "version");
  INTERN(s_prior_size, "prior_size");
  INTERN(s_parts, "parts");
  INTERN(s_crc, "crc");
#undef INTERN
  return mod;
fail:
  Py_DECREF(mod);
  return NULL;
}
