// Shared declarations for the native runtime library.
//
// Paddle implements its runtime layer (channels, thread pool, memory
// allocator, reader pipeline, cloud master) in native code (paddle/fluid/
// framework/channel.h, threadpool.h, memory/detail/buddy_allocator.h,
// framework/reader.h, go/master/service.go).  This library is the PyTorch port's native
// equivalent: host-side runtime services around the CUDA compute path,
// exposed to Python over a flat C ABI consumed via ctypes.
#pragma once
#include <cstddef>
#include <cstdint>

#define PT_API extern "C" __attribute__((visibility("default")))
