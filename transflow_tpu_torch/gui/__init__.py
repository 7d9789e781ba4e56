from .server import GuiServer, start_gui

__all__ = ["GuiServer", "start_gui"]
