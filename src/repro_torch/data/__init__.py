from . import streams
from .streams import chicago_aq_stream, materialize, shenzhen_taxi_stream

__all__ = ["chicago_aq_stream", "materialize", "shenzhen_taxi_stream", "streams"]
