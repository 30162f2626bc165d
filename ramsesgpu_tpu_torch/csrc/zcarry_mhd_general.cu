// The general instances of zcarry_mhd.cu's modes (mhd_stages.cuh Mode with
// GEN: the face and corner solvers from the parameter block), in an object
// of their own: zcarry_mhd.cu declares them extern and calls them where the
// block asks for another pair than HLLD / 2D-HLLD, so the build compiles
// the two sets of instances side by side.
#define RAMSES_MHD_GENERAL_TU
#include "zcarry_mhd.cu"
