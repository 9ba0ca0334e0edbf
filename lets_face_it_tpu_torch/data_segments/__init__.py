from lets_face_it_tpu_torch.data_segments.segments import (  # noqa: F401
    DataSegment,
    MimicrySegment,
    Segment,
    get_segments,
    get_segments_v2,
)
