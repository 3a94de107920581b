#pragma once
#include "emu.h"
