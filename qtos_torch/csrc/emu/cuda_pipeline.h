// The pipeline primitives come with cuda_runtime.h in this stand-in.
#pragma once
#include "cuda_runtime.h"
