.PHONY: native test bench

native:
	python setup.py build_ext --inplace

test: native
	JAX_PLATFORMS=cpu python -m pytest tests/ -x -q

bench:
	python bench.py
