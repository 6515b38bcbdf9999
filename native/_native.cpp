// adcraft_tpu._native — C++ host-runtime kernels.
//
// The reference ships a Rust (pyo3) extension for its host-side hot loops
// (src/lib.rs: nth-price auction helpers, reductions, outcome reprs). The
// device compute path here is XLA, but the host runtime keeps native
// kernels for the pieces that stay on CPU:
//
//   * gate_day       — the oracle's exact day-simulation loop (budget
//                      gating over (T, K, M) draw tables), used by parity
//                      tests and the reference-parity oracle at scale.
//   * nth_price_auction — literal auction clearing over materialized
//                      competitor bids (semantics of
//                      adcraft/synthetic_kw_helpers.py:116-180).
//   * repr_outcomes  — fast info-string formatting (role of
//                      rust.repr_outcomes_py, src/lib.rs:251-275).
//
// Built with the CPython + numpy C APIs (no pybind11 dependency).

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// gate_day: exact sequential day simulation over an injected draw table.
// Mirrors adcraft_tpu.oracle.simulate_day_numpy (and thereby the
// reference's simulate_epoch_of_bidding_on_campaign control flow,
// bidding_simulation.py:170-234) bit-for-bit.
// ---------------------------------------------------------------------------

// costs: (T,K,M) float64; n_clicks/impressions/n_auctions: (T,K) int64;
// conv_flags: (T,K,M) uint8; revs_cents: (T,K,M) int64;
// budget: double; cents: int (gate in integer cents when nonzero).
PyObject* gate_day(PyObject*, PyObject* args) {
  PyArrayObject *costs, *n_clicks, *impressions, *n_auctions, *conv_flags,
      *revs_cents;
  double budget;
  int cents;
  if (!PyArg_ParseTuple(args, "O!O!O!O!O!O!di", &PyArray_Type, &costs,
                        &PyArray_Type, &n_clicks, &PyArray_Type, &impressions,
                        &PyArray_Type, &n_auctions, &PyArray_Type, &conv_flags,
                        &PyArray_Type, &revs_cents, &budget, &cents))
    return nullptr;

  if (PyArray_NDIM(costs) != 3 || PyArray_TYPE(costs) != NPY_FLOAT64 ||
      PyArray_TYPE(n_clicks) != NPY_INT64 ||
      PyArray_TYPE(impressions) != NPY_INT64 ||
      PyArray_TYPE(n_auctions) != NPY_INT64 ||
      PyArray_TYPE(conv_flags) != NPY_UINT8 ||
      PyArray_TYPE(revs_cents) != NPY_INT64) {
    PyErr_SetString(PyExc_TypeError,
                    "gate_day: expected costs f64 (T,K,M); n_clicks, "
                    "impressions, n_auctions i64 (T,K); conv_flags u8 "
                    "(T,K,M); revs_cents i64 (T,K,M)");
    return nullptr;
  }
  const npy_intp T = PyArray_DIM(costs, 0);
  const npy_intp K = PyArray_DIM(costs, 1);
  const npy_intp M = PyArray_DIM(costs, 2);

  auto at3d = [&](PyArrayObject* a, npy_intp t, npy_intp k, npy_intp m) {
    return PyArray_GETPTR3(a, t, k, m);
  };

  std::vector<int64_t> out_imp(K, 0), out_clicks(K, 0), out_convs(K, 0),
      out_elig(K, 0), out_rev_c(K, 0), out_cost_c(K, 0);
  std::vector<double> out_cost(K, 0.0);

  // budget state: integer cents or double, per the parity contract
  // (EnvConfig.cents_costs)
  int64_t b_c = static_cast<int64_t>(std::llround(budget * 100.0));
  double b_f = budget;
  bool broken = false;

  std::vector<int64_t> prefix_c(M + 1);
  std::vector<double> prefix_f(M + 1);

  for (npy_intp t = 0; t < T && !broken; ++t) {
    for (npy_intp k = 0; k < K; ++k) {
      const int64_t imp =
          *static_cast<int64_t*>(PyArray_GETPTR2(impressions, t, k));
      const int64_t nc =
          *static_cast<int64_t*>(PyArray_GETPTR2(n_clicks, t, k));
      int64_t accepted = 0;
      if (cents) {
        prefix_c[0] = 0;
        for (npy_intp m = 0; m < nc; ++m) {
          const double c = *static_cast<double*>(at3d(costs, t, k, m));
          prefix_c[m + 1] = prefix_c[m] + std::llround(c * 100.0);
        }
        int64_t spend = 0;
        for (npy_intp m = 0; m < nc; ++m) {
          if (prefix_c[m + 1] <= b_c) {
            accepted++;
            spend = prefix_c[m + 1];
          } else {
            break;
          }
        }
        b_c -= spend;
        out_cost_c[k] += spend;
      } else {
        prefix_f[0] = 0.0;
        for (npy_intp m = 0; m < nc; ++m) {
          prefix_f[m + 1] =
              prefix_f[m] + *static_cast<double*>(at3d(costs, t, k, m));
        }
        double spend = 0.0;
        for (npy_intp m = 0; m < nc; ++m) {
          if (prefix_f[m + 1] <= b_f) {
            accepted++;
            spend = prefix_f[m + 1];
          } else {
            break;
          }
        }
        b_f -= spend;
        out_cost[k] += spend;
      }
      int64_t convs = 0;
      for (npy_intp m = 0; m < accepted; ++m)
        convs += *static_cast<uint8_t*>(at3d(conv_flags, t, k, m)) ? 1 : 0;
      int64_t rev_c = 0;
      for (npy_intp m = 0; m < convs; ++m)
        rev_c += *static_cast<int64_t*>(at3d(revs_cents, t, k, m));

      out_imp[k] += imp;
      out_clicks[k] += accepted;
      out_convs[k] += convs;
      out_rev_c[k] += rev_c;
      if (imp >= 1)
        out_elig[k] +=
            *static_cast<int64_t*>(PyArray_GETPTR2(n_auctions, t, k));
      const bool depleted = cents ? (b_c <= 0) : (b_f <= 0.0);
      if (depleted) {
        broken = true;
        break;
      }
    }
  }

  npy_intp dims[1] = {K};
  PyObject* imp_arr = PyArray_SimpleNew(1, dims, NPY_INT64);
  PyObject* clk_arr = PyArray_SimpleNew(1, dims, NPY_INT64);
  PyObject* cost_arr = PyArray_SimpleNew(1, dims, NPY_FLOAT64);
  PyObject* conv_arr = PyArray_SimpleNew(1, dims, NPY_INT64);
  PyObject* rev_arr = PyArray_SimpleNew(1, dims, NPY_FLOAT64);
  PyObject* elig_arr = PyArray_SimpleNew(1, dims, NPY_INT64);
  if (!imp_arr || !clk_arr || !cost_arr || !conv_arr || !rev_arr || !elig_arr)
    return nullptr;
  for (npy_intp k = 0; k < K; ++k) {
    *static_cast<int64_t*>(
        PyArray_GETPTR1(reinterpret_cast<PyArrayObject*>(imp_arr), k)) =
        out_imp[k];
    *static_cast<int64_t*>(
        PyArray_GETPTR1(reinterpret_cast<PyArrayObject*>(clk_arr), k)) =
        out_clicks[k];
    *static_cast<double*>(
        PyArray_GETPTR1(reinterpret_cast<PyArrayObject*>(cost_arr), k)) =
        cents ? out_cost_c[k] / 100.0 : out_cost[k];
    *static_cast<int64_t*>(
        PyArray_GETPTR1(reinterpret_cast<PyArrayObject*>(conv_arr), k)) =
        out_convs[k];
    *static_cast<double*>(
        PyArray_GETPTR1(reinterpret_cast<PyArrayObject*>(rev_arr), k)) =
        out_rev_c[k] / 100.0;
    *static_cast<int64_t*>(
        PyArray_GETPTR1(reinterpret_cast<PyArrayObject*>(elig_arr), k)) =
        out_elig[k];
  }
  PyObject* out = PyDict_New();
  PyDict_SetItemString(out, "impressions", imp_arr);
  PyDict_SetItemString(out, "buyside_clicks", clk_arr);
  PyDict_SetItemString(out, "cost", cost_arr);
  PyDict_SetItemString(out, "sellside_conversions", conv_arr);
  PyDict_SetItemString(out, "revenue", rev_arr);
  PyDict_SetItemString(out, "eligible_volume", elig_arr);
  Py_DECREF(imp_arr);
  Py_DECREF(clk_arr);
  Py_DECREF(cost_arr);
  Py_DECREF(conv_arr);
  Py_DECREF(rev_arr);
  Py_DECREF(elig_arr);
  return out;
}

// ---------------------------------------------------------------------------
// nth_price_auction(bid, other_bids (A, B), n, num_winners)
//   -> (impressions, placements i64[imp], costs f64[imp])
// Literal clearing with zero-padding and strict searchsorted-left win
// semantics (reference synthetic_kw_helpers.py:116-180).
// ---------------------------------------------------------------------------

PyObject* nth_price_auction(PyObject*, PyObject* args) {
  double bid;
  PyArrayObject* other;
  int n = 2, winners = 1;
  if (!PyArg_ParseTuple(args, "dO!|ii", &bid, &PyArray_Type, &other, &n,
                        &winners))
    return nullptr;
  if (PyArray_NDIM(other) != 2 || PyArray_TYPE(other) != NPY_FLOAT64) {
    PyErr_SetString(PyExc_TypeError, "other_bids must be (A, B) float64");
    return nullptr;
  }
  const npy_intp A = PyArray_DIM(other, 0);
  const npy_intp B = PyArray_DIM(other, 1);
  const int width = winners + n;

  std::vector<double> top(width);
  std::vector<int64_t> placements;
  std::vector<double> costs;
  int64_t imps = 0;
  std::vector<double> row(std::max<npy_intp>(B, width));

  for (npy_intp a = 0; a < A; ++a) {
    for (npy_intp j = 0; j < B; ++j)
      row[j] = *static_cast<double*>(PyArray_GETPTR2(other, a, j));
    if (B >= width) {
      std::partial_sort_copy(row.begin(), row.begin() + B, top.begin(),
                             top.end(), std::greater<double>());
      std::reverse(top.begin(), top.end());  // ascending top-`width`
    } else {
      std::fill(top.begin(), top.end(), 0.0);
      std::copy(row.begin(), row.begin() + B, top.begin() + (width - B));
      std::sort(top.begin(), top.end());
    }
    // searchsorted-left: count of entries strictly below bid
    int idx = static_cast<int>(
        std::lower_bound(top.begin(), top.end(), bid) - top.begin());
    if (idx > n) {
      imps++;
      placements.push_back(width - idx);
      costs.push_back(n > 1 ? top[std::max(idx - (n - 1), 0)] : bid);
    }
  }

  npy_intp dims[1] = {static_cast<npy_intp>(imps)};
  PyObject* p_arr = PyArray_SimpleNew(1, dims, NPY_INT64);
  PyObject* c_arr = PyArray_SimpleNew(1, dims, NPY_FLOAT64);
  if (!p_arr || !c_arr) return nullptr;
  for (npy_intp i = 0; i < imps; ++i) {
    *static_cast<int64_t*>(
        PyArray_GETPTR1(reinterpret_cast<PyArrayObject*>(p_arr), i)) =
        placements[i];
    *static_cast<double*>(
        PyArray_GETPTR1(reinterpret_cast<PyArrayObject*>(c_arr), i)) =
        costs[i];
  }
  PyObject* out = Py_BuildValue("(LNN)", static_cast<long long>(imps), p_arr,
                                c_arr);
  return out;
}

// ---------------------------------------------------------------------------
// repr_outcomes(bids f64[K], impressions i64[K], shares f64[K],
//               clicks i64[K], costs f64[K], convs i64[K], revs f64[K],
//               profits f64[K]) -> str
// ---------------------------------------------------------------------------

static void fmt_double(std::string& s, double v) {
  char buf[32];
  if (v == std::floor(v) && std::fabs(v) < 1e15)
    snprintf(buf, sizeof(buf), "%.1f", v);
  else
    snprintf(buf, sizeof(buf), "%g", v);
  s += buf;
}

PyObject* repr_outcomes(PyObject*, PyObject* args) {
  PyArrayObject *bids, *imps, *shares, *clicks, *costs, *convs, *revs,
      *profits;
  if (!PyArg_ParseTuple(args, "O!O!O!O!O!O!O!O!", &PyArray_Type, &bids,
                        &PyArray_Type, &imps, &PyArray_Type, &shares,
                        &PyArray_Type, &clicks, &PyArray_Type, &costs,
                        &PyArray_Type, &convs, &PyArray_Type, &revs,
                        &PyArray_Type, &profits))
    return nullptr;
  const npy_intp K = PyArray_DIM(bids, 0);
  std::string s = "[";
  for (npy_intp k = 0; k < K; ++k) {
    s += "{'bid': ";
    fmt_double(s, *static_cast<double*>(PyArray_GETPTR1(bids, k)));
    s += ", 'impressions': " +
         std::to_string(*static_cast<int64_t*>(PyArray_GETPTR1(imps, k)));
    s += ", 'impression_share': ";
    fmt_double(s, *static_cast<double*>(PyArray_GETPTR1(shares, k)));
    s += ", 'buyside_clicks': " +
         std::to_string(*static_cast<int64_t*>(PyArray_GETPTR1(clicks, k)));
    s += ", 'costs_total': ";
    fmt_double(s, *static_cast<double*>(PyArray_GETPTR1(costs, k)));
    s += ", 'sellside_conversions': " +
         std::to_string(*static_cast<int64_t*>(PyArray_GETPTR1(convs, k)));
    s += ", 'revenues_total': ";
    fmt_double(s, *static_cast<double*>(PyArray_GETPTR1(revs, k)));
    s += ", 'profit': ";
    fmt_double(s, *static_cast<double*>(PyArray_GETPTR1(profits, k)));
    s += "}";
    if (k + 1 < K) s += ", ";
  }
  s += "]";
  return PyUnicode_FromStringAndSize(s.data(), s.size());
}

PyMethodDef methods[] = {
    {"gate_day", gate_day, METH_VARARGS,
     "Exact sequential day simulation over an injected draw table."},
    {"nth_price_auction", nth_price_auction, METH_VARARGS,
     "Literal nth-price auction clearing over materialized bids."},
    {"repr_outcomes", repr_outcomes, METH_VARARGS,
     "Fast outcome-summary string formatting."},
    {nullptr, nullptr, 0, nullptr}};

struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_native",
                                "adcraft_tpu native host kernels", -1,
                                methods};

}  // namespace

PyMODINIT_FUNC PyInit__native(void) {
  import_array();
  return PyModule_Create(&moduledef);
}
