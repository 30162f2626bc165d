// The general instances of mhd_step.cu's modes (mhd_stages.cuh Mode with
// GEN: the face solver HLLD, LLF or HLL and the corner solver 2D-HLLD,
// HLLA, HLLF or LLF from the parameter block), in an object of their own:
// mhd_step.cu declares them extern and calls them where the block asks for
// another pair than HLLD / 2D-HLLD, so the build compiles the two sets of
// instances side by side and the HLLD instances stay what they were.
#define RAMSES_MHD_GENERAL_TU
#include "mhd_step.cu"
