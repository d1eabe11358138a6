from bidirectional_pathtracing.parallel.render import (  # noqa: F401
    make_render_mesh, render_step_sharded, render_frame_sharded,
)
