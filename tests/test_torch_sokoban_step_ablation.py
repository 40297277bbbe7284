"""``tools/sokoban_step_ablation.py`` edits the Sokoban step kernel's source
to make its variants: every edit must still find its text there, once."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
  "sokoban_step_ablation", ROOT / "tools" / "sokoban_step_ablation.py"
)
ablation = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ablation)


@pytest.mark.parametrize("name", sorted(ablation.VARIANTS))
def test_variant_edits_match_the_kernel_source(name):
  src = ablation.SOURCE.read_text()
  edits, _ = ablation.VARIANTS[name]
  for old, new in edits:
    assert src.count(old) == 1, old
    assert src.replace(old, new) != src
