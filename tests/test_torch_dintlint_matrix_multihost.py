"""dintlint over the port's 2-D mesh block runners (one family of the
``python -m dint_tpu_torch.dintlint --all`` matrix; tests/
_torch_dintlint_matrix.py says what each test holds)."""
import pytest

from _torch_dintlint_matrix import (check_family_allowlist,
                                    check_link_bytes, check_target, family)

NAMES = [n for n in family("multihost_sb/block", "multihost/")
         if n not in family("multihost_sb/block@h3",
                            "multihost_sb/block@trace")]


@pytest.mark.lint
@pytest.mark.parametrize("name", NAMES)
def test_target_is_clean(name):
    check_target(name)


@pytest.mark.lint
def test_family_allowlist_entries_all_match():
    check_family_allowlist(NAMES)


@pytest.mark.lint
@pytest.mark.parametrize("name", NAMES)
def test_link_bytes_equal_the_hand_count(name):
    check_link_bytes(name)
