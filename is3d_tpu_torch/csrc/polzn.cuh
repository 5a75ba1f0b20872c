// What the polarization kernels (polzn.cu, K6, and its backward
// polzn_bwd.cu) share: the packed cell row's field order and the number of
// sums.

#pragma once

namespace is3d {

// must match PW_FIELDS in is3d_tpu_torch/kernels/polzn.py
enum PwField {
  W_TAU, W_ETA, W_DAT, W_DANT, W_DAX, W_DAY, W_UT_T, W_TUN_T, W_UX_T,
  W_UY_T, W_ITAU, W_WTX, W_WTY, W_WTN, W_WXY, W_WXN, W_WYN, W_YFLOW, NW
};

constexpr int NSUM = 5;            // St, Sx, Sy, Sn, Snorm

}  // namespace is3d
