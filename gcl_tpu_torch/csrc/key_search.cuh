// The fields of the packed keys that the kernels search, shared by them.
//
// The keys are signed int32 in the ascending order torch.sort gives them
// (packed keys of clouds >= 16 are negative), so searches compare as
// signed int32 too.

#pragma once

#include <cuda_runtime.h>

// coords.DEFAULT_KEY_BITS
constexpr int kKeyBX = 10, kKeyBY = 10, kKeyBZ = 7;
