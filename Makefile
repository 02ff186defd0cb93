# Convenience entry points (the reference's docker-compose role, D1 — the
# compose service just ran the node-classification harness on one device;
# `make smoke` is the equivalent here).

.PHONY: test smoke full bench kernels native clean

test:
	python -m pytest tests/ -q

smoke:
	python benchmarks/generate_result.py --suite smoke

full:
	python benchmarks/generate_result.py --suite full --timeout 7200

bench:
	python bench.py

kernels:
	python kernel/bench_kernels.py

native:
	python -c "from dgl_jax.csrc import native; assert native.available(); print('native ok')"

clean:
	rm -rf dgl_jax/csrc/_build .pytest_cache
	find . -name __pycache__ -type d -exec rm -rf {} +
