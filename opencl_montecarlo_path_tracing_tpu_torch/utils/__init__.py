from .pam import ImgInfo, save_pam, load_pam

__all__ = ["ImgInfo", "save_pam", "load_pam"]
