// The Monte-Carlo sampler's event batch (K7, csrc/sample.cuh) on
// viscous hydro (df 1-4) with the binary-search draws
// (K7-search), for Hopper (sm_90a), float32 and float64:
// a library of its own, so that nvcc builds it beside the others.

#include "sample.cuh"

IS3D_SAMPLE_EVENT_ENTRIES(false, true)
