// Shared ABI version for the native codec/wire shared objects.
//
// Bump DLT_ABI_VERSION whenever the exported C symbol set or any
// function signature changes.  native/__init__.py calls the exported
// dlt_abi_version() right after dlopen and force-rebuilds a cached .so
// whose version does not match — a stale cache must become a rebuild,
// never an AttributeError at first use.
#ifndef DLT_ABI_H_
#define DLT_ABI_H_

// v3: dlt_wire_fused_apply joins the export set, and
// dlt_wire_fused_decode's out-buffer contract changed (the decode now
// zero-fills the ravel itself, so callers may pass dirty scratch).
#define DLT_ABI_VERSION 3u

// Transport-frame and trace-context versions, restated here so the
// native side carries the full wire identity in one header.  The
// Python authorities are comm/framing.py (WIRE_VERSION) and
// comm/protocol.py (TRACE_CTX_VERSION); the three statements of either
// version (Python authority, wire.cpp constexpr, this define) must agree,
// and tests/torch_port/test_torch_wire.py checks that they do.
#define DLT_WIRE_VERSION 2u
#define DLT_TRACE_CTX_VERSION 1u

#endif  // DLT_ABI_H_
