# Convenience targets (the reference's CMake/Make role; the Python
# package itself needs no build step — only the native C API does).

.PHONY: all test capi capi-test bench examples clean

all: capi

test:
	python -m pytest tests/ -q

capi:
	$(MAKE) -C capi

capi-test: capi
	$(MAKE) -C capi test_host
	cd capi && JAX_PLATFORMS=cpu \
	  FABBER_TPU_PYTHONPATH="$(CURDIR):$$(python -c 'import site; print(site.getsitepackages()[0])')" \
	  ./test_host

bench:
	python bench.py

examples:
	JAX_PLATFORMS=cpu PYTHONPATH=$(CURDIR) python examples/test_single.py

clean:
	$(MAKE) -C capi clean
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
