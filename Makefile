# Build/test entry points (reference: CMake + `make bttest`,
# zklaim/CMakeLists.txt:110-116; CI runs Dockerfile:10-12).
#
#   make native      build the C++ host library (SHA256/Ed25519-ECDSA/codec);
#                    also built automatically at first use
#   make test-fast   native + host-side suite, no heavy XLA compiles (<5 min)
#   make test        native + the full CPU suite (compile-heavy; slow cold)
#   make test-gpu    the tests that need a GPU, on the GPU
#   make smoke       chip_smoke.py on one GPU
#   make bench       the benchmark line (GPU)

PYTHON ?= python

.PHONY: native test-fast test test-gpu smoke bench clean

native:
	$(MAKE) -C native

test-fast: native
	$(PYTHON) -m pytest tests/ -q -m "not slow and not gpu"

test: native
	$(PYTHON) -m pytest tests/ -q

test-gpu: native
	ZKLAIM_TEST_PLATFORM=gpu $(PYTHON) -m pytest tests/ -q -m gpu

smoke:
	$(PYTHON) chip_smoke.py

bench:
	$(PYTHON) bench.py

clean:
	$(MAKE) -C native clean
