from .robots import ClickRobot, BboxRobot
from .annotator import Annotator
from .fake_sam import FakeSAMController

__all__ = ["ClickRobot", "BboxRobot", "Annotator", "FakeSAMController"]
