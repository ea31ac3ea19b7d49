from .renderer import Camera, Shader, RenderInput, Renderer
