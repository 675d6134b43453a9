"""The rank launcher gives each rank a card of those the run was given."""
import pytest

from kbench import ranks


def test_cards_follow_the_given_list(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5,6,7")
    assert ranks.visible_cards(4) == ["4", "5", "6", "7"]
    assert ranks.visible_cards(2) == ["4", "5"]


def test_cards_without_a_list(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert ranks.visible_cards(4) == ["0", "1", "2", "3"]


def test_too_few_cards(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3")
    with pytest.raises(SystemExit):
        ranks.visible_cards(4)
