"""The other half of the registry's exported artifacts: see
``test_torch_export_zoo.py``, whose round trip each name here takes."""

import pytest

from test_torch_export_zoo import NAMES, one_thread, zoo_round_trip

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("name", NAMES[1::2])
def test_zoo_export_round_trip(tmp_path, name):
    zoo_round_trip(tmp_path, name)
