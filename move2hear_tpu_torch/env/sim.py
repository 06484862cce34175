"""Simulator action codes (``habitat_audio/simulator_train.py``)."""

import enum


class Action(enum.IntEnum):
    PAUSE = 0
    MOVE_FORWARD = 1
    TURN_LEFT = 2
    TURN_RIGHT = 3
