# Build / test / bench entry points (≈ the reference's compile.m, which
# drives nvcc + mex; here: g++ for the native planner, pytest, bench).

CSRC := csrc
SO   := $(CSRC)/libfftconv_planner.so

.PHONY: all native test test-gpu smoke bench demo clean

all: native

native: $(SO)

$(SO): $(CSRC)/planner.cpp
	g++ -O2 -shared -fPIC -std=c++17 -o $@ $<

test:
	JAX_PLATFORMS=cpu python -m pytest tests/ -q

# the tests that need the card (run on a machine with an NVIDIA GPU)
test-gpu:
	python -m pytest tests/ -q -m gpu

# full-size main path on one GPU against the float64 reference
smoke:
	python chip_smoke.py

bench:
	python bench.py

demo:
	python examples/demo.py
	python examples/demo_bank.py
	python examples/demo_dpm.py
	python examples/demo_train.py
	python examples/demo_serving.py

clean:
	rm -f $(SO)
	find . -name __pycache__ -type d -exec rm -rf {} +
