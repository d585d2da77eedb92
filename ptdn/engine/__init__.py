from ptdn.engine.renderer import Renderer  # noqa: F401
