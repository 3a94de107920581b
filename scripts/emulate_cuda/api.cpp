// The emulation's controls, exported beside the kernels' C entries.
#include "emu.h"
extern "C" void emu_register(void* p, long long n) { emu::ranges.push_back({(uintptr_t)p, (uintptr_t)p + (uintptr_t)n}); }
extern "C" void emu_clear() { emu::ranges.clear(); emu::fault = 0; emu::fault_msg[0] = 0; }
extern "C" const char* emu_fault() { return emu::fault ? emu::fault_msg : nullptr; }
extern "C" void emu_set_eager(int e) { emu::eager = e; }
