# Dev loop.  Tests run on the CPU (tests/conftest.py forces it); the GPU
# checks are chip_smoke.py's.
CPU_ENV := JAX_PLATFORMS=cpu

.PHONY: test test-fast smoke bench lint

test:
	$(CPU_ENV) python -m pytest tests/ -x -q

test-fast:
	$(CPU_ENV) python -m pytest tests/ -x -q -m "not slow"

smoke:
	python chip_smoke.py

bench:
	python bench.py

lint:
	$(CPU_ENV) python -m compileall -q cusift_tpu
