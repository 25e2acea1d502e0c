// The CPU stand-in's cooperative groups: the cluster calls live in
// cuda_runtime.h.
#pragma once
#include "cuda_runtime.h"
