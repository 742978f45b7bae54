# Top-level build/test/benchmark driver, mirroring the reference Makefile
# (reference Makefile:1-72): `make` prepares everything the executables
# need, `make test` / `make benchmark` drive the black-box harnesses over
# both storage formats.

PYTHON ?= python
MATRIX  = matrices/shallow_water1/shallow_water1.mtx

all: native matrix

native:
	$(MAKE) -C native

matrix: $(MATRIX)

$(MATRIX):
	$(PYTHON) matrices/make_matrix.py

test: all
	./run_tests "$(PYTHON) bin/cg-csr"
	./run_tests "$(PYTHON) bin/cg-coo"

pytest:
	$(PYTHON) -m pytest tests/ -q

# Hardware check on an NVIDIA GPU: runs chip_smoke.py through the `gpu`
# pytest marker (the test skips on a machine without a GPU).
test-gpu:
	$(PYTHON) -m pytest tests/ -q -m gpu

benchmark: all
	./run_benchmark "$(PYTHON) bin/cg-csr" -b 10
	./run_benchmark "$(PYTHON) bin/cg-coo" -b 10

bench: all
	$(PYTHON) bench.py

clean:
	$(MAKE) -C native clean

.PHONY: all native matrix test test-gpu pytest benchmark bench clean
