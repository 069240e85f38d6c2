# Task runner — the analog of the reference's justfile (reference:
# justfile:8-104: setup/lab/run/build/test/fmt/lint/info/clean).

PY ?= python

.PHONY: all setup native run bench bench-suite chip-smoke chip-smoke-multi \
        test lab fmt lint info clean

all: native test

# environment bootstrap (the reference's `just setup`, justfile:8-28):
# venv + editable install + jupyter kernel + native runtime. On images with
# jax/jupyter preinstalled this is a no-op-safe refresh.
setup:
	$(PY) -m venv --system-site-packages .venv 2>/dev/null || true
	. .venv/bin/activate 2>/dev/null; $(PY) -m pip install -e . 2>/dev/null \
	  || echo "pip install skipped (offline image: deps are preinstalled)"
	$(PY) -m ipykernel install --user --name bhr_tpu \
	  --display-name "Python (bhr_tpu)" 2>/dev/null \
	  || echo "ipykernel registration skipped"
	$(MAKE) -s -C native

# build the native C++ I/O runtime (auto-built on first use too)
native:
	$(MAKE) -s -C native

# headless real-time animation (the reference's `just run`)
run: native
	$(PY) -m bhr_tpu.app --frames 120 --perf-log dev

# headline benchmark -> one JSON line (needs a GPU)
bench:
	$(PY) bench.py

# the config suite, one run -> measurements/bench_suite_*.json
# (compare two runs with scripts/bench_compare.py)
bench-suite:
	$(PY) scripts/bench_suite.py

# on-card smoke test: every kernel compiled for the GPU and checked against
# the XLA oracle at full width; last line is one JSON object. The CPU tests
# run the Pallas kernel in interpret mode and cannot see what the GPU's
# compiler refuses, so run this on the card after any kernel change.
chip-smoke:
	$(PY) chip_smoke.py

# the four-GPU sharded path only
chip-smoke-multi:
	$(PY) chip_smoke.py --multi

# CPU test suite with 8 virtual devices (the `gpu`-marked tests skip)
test:
	$(PY) -m pytest tests/ -q -m 'not slow' -n 6 --dist loadfile

# JupyterLab with the rendering notebook (the reference's `just lab`)
lab:
	jupyter lab notebooks/

fmt:
	$(PY) -m black bhr_tpu tests *.py 2>/dev/null || echo "black not installed; skipping"

lint:
	$(PY) -m ruff check bhr_tpu tests 2>/dev/null || echo "ruff not installed; skipping"

info:
	$(PY) -c "import jax, bhr_tpu; print('bhr_tpu', bhr_tpu.__version__); print('jax', jax.__version__); print('devices', jax.devices())"

clean:
	$(MAKE) -s -C native clean
	rm -rf .pytest_cache .jax_cache bhr_tpu/**/__pycache__ bhr_tpu/__pycache__ tests/__pycache__
