# Developer entry points. Tests force the CPU backend themselves
# (tests/conftest.py); bench and chip-smoke need a GPU.

.PHONY: test test-fast bench bench-10m native e2e clean

test:
	python -m pytest tests/ -q

test-fast:
	python -m pytest tests/ -q -x -m "not slow" --ignore=tests/test_e2e.py

native:
	sh sert_tpu/native/build.sh

bench:
	python bench.py

bench-10m:
	python benchmarks/sharded_bench.py

e2e:
	python -m sert_tpu e2e --recipe w3c_expert_finding --workdir /tmp/sert_e2e_w3c

clean:
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null; true
