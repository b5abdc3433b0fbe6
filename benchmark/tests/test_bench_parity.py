"""The plain references against the program at a CPU size, float32 on both
sides: what the check compares agrees to rounding."""

import pytest

from benchmark.tests.tiny import tiny_cell


@pytest.mark.parametrize("name,tol", [
    ("sd-v1-4.or.512.b8", {"latents": 1e-4, "ll": 1e-4, "images": 1.0}),
    ("cifar10-pair.or_sde.b100", {"x0": 1e-5, "logq": 1e-5}),
])
def test_reference_against_the_program(name, tol):
    cell = tiny_cell(name)
    drv = cell.driver().Driver(cell, 2**31 + 11, "cpu")
    drv.setup()
    drv.request(0)
    drv.release()
    numbers, _ = drv.check([0])
    assert set(numbers) == set(tol)
    for k, v in numbers.items():
        assert v <= tol[k], (k, v)
